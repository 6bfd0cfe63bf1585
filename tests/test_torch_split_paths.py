"""The split-bounce wavefront's entry points on the port's small scene at
40x36: the continuation state rows, the octant walks over the treelet
view, which configs take the fused K1 instead of the split, and the
wrappers' refusals."""

import pytest
import torch

from test_torch_split_k1 import SW, SH, small_k1  # noqa: F401
from rayzen_tpu_torch import pack_scene
from rayzen_tpu_torch.demo import build_small_scene
from rayzen_tpu_torch.integrator import check_config, render_rays
from rayzen_tpu_torch.ops import megakernel
from rayzen_tpu_torch.packing import world_geometry
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_split_continuation_state(small_k1):
    """Phase 1's rows: the live rays carry their paths, the others zeros
    and alive 0; the seeds are the sampler's. A continuation that emits
    rewrites its rays' rows in place and leaves only rays it traced alive."""
    cfg, arrays, cam, _frag, uv, _img, _rays = small_k1
    cfg = cfg.replace(split_bounce=1)
    ws = world_geometry(arrays)
    act = torch.arange(uv.shape[0]) % 5 != 0
    color, rays, state = megakernel.sample_wave_phase1(
        ws, cfg, uv, act, cam, 0, 3, 5)
    alive = state[10] > 0.5
    assert state.shape == (13, uv.shape[0]) and alive.any() and not alive.all()
    assert (state[:10, ~alive] == 0).all() and (state[:, ~act] == 0).all()
    assert (state[6:9, alive] > 0).all()  # throughput after bounce 0
    assert (color[~act] == 0).all() and int(rays) > int(act.sum())
    _d, order, live = megakernel._compaction_permutation(
        alive, state[3], state[4], state[5], "rank")
    state2 = state.clone()
    megakernel.continuation(ws, cfg, state2, order, live, color.clone(),
                            rays.clone(), 0, 3, 5, 1, 2, emit=True)
    assert not (state2[10] > 0.5)[~alive].any()
    torch.testing.assert_close(state2[11:], state[11:], rtol=0, atol=0)


def test_octant_tiered_k1_matches_tiered_k1(small_k1):
    """K9 over the treelet view (K8 sub-walks): the plain octant tiered K1
    renders the plain tiered K1's frame."""
    cfg, _arrays, cam, _frag, uv, _img, _rays = small_k1
    cfg = cfg.replace(tiered="on", treelet_rows=8, max_bounces=4)
    ws = world_geometry(pack_scene(build_small_scene(SW, SH), cfg, "cpu"))
    assert ws.tiered
    act = torch.ones(uv.shape[0], dtype=torch.bool)
    base = megakernel.sample_wave(ws, cfg, uv, act, cam, 0, 0, 4)
    octant = megakernel.sample_wave(
        ws, cfg.replace(octant_bounce_walks=True), uv, act, cam, 0, 0, 4)
    torch.testing.assert_close(octant[0], base[0], rtol=0, atol=0)
    assert int(octant[1]) == int(base[1])


@pytest.mark.parametrize("knobs", [
    dict(split_bounce=2, rng="threefry"),
    dict(split_bounce=2, tiered="on", treelet_rows=8),
    dict(split_bounce=5),  # not below max_bounces
], ids=["hash_rng", "tiered", "past_budget"])
def test_split_off_path_takes_fused_k1(small_k1, knobs, monkeypatch):
    cfg, _arrays, cam, frag, uv, _img, _rays = small_k1
    cfg = cfg.replace(spp=1, **knobs)
    check_config(cfg)
    arrays = pack_scene(build_small_scene(SW, SH), cfg, "cpu")

    def refuse(*a):
        raise AssertionError("took the split")

    monkeypatch.setattr(megakernel, "sample_wave_split", refuse)
    img = render_rays(arrays, frag, uv, cam, cfg)
    assert img.shape == (SW * SH, 3) and torch.isfinite(img).all()


def test_split_wrappers_refuse_other_devices(small_k1):
    cfg, arrays, cam, _frag, uv, _img, _rays = small_k1
    cfg = cfg.replace(split_bounce=2)
    ws = world_geometry(arrays)
    act = torch.ones(uv.shape[0], dtype=torch.bool)
    with pytest.raises(ValueError, match="device meta"):
        megakernel.sample_wave_phase1(ws, cfg, uv.to("meta"), act, cam, 0, 0, 5)
    with pytest.raises(ValueError, match="device meta"):
        meta = dict(device="meta")
        megakernel.continuation(
            ws, cfg, torch.zeros(13, 8, **meta),
            torch.zeros(8, dtype=torch.int32, **meta),
            torch.zeros((), dtype=torch.int32, **meta), torch.zeros(8, 3, **meta),
            torch.zeros((), dtype=torch.int64, **meta), 0, 0, 5, 2, 5, emit=False)
    with pytest.raises(ValueError, match="split_bounce must be"):
        megakernel.sample_wave_split(ws, cfg.replace(split_bounce=5), uv, act,
                                     cam, 0, 0, 5)
