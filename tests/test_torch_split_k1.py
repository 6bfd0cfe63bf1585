"""The port's plain split-bounce wavefront (K4) against its own plain K1 on
the small scene at 40x36 (not a multiple of a warp or a packet), 2 spp,
rng_key 3: every split point, rebin mode and split_every, with and without
the octant bounce walks, render K1's frame."""

import pytest

from rayzen_tpu_torch import RenderConfig, pack_scene
from rayzen_tpu_torch.demo import build_small_scene
from rayzen_tpu_torch.integrator import render_rays
from rayzen_tpu_torch.ops import megakernel
from rayzen_tpu_torch.ops.camera_rays import pixel_grid
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SW, SH = 40, 36


@pytest.fixture(scope="module")
def small_k1():
    """The port's own pack of the small scene at 40x36 (not a multiple of a
    warp or a packet), spp 2, rng_key 3, and the plain K1's frame."""
    walk_scene = build_small_scene(SW, SH)
    cfg = RenderConfig(width=SW, height=SH, spp=2, max_bounces=5)
    arrays = pack_scene(walk_scene, cfg, "cpu")
    cam = walk_scene.camera.device_params()
    frag, uv = pixel_grid(SW, SH, "cpu")
    img, rays = render_rays(arrays, frag, uv, cam, cfg, rng_key=3,
                            with_stats=True)
    return cfg, arrays, cam, frag, uv, img, int(rays)


@pytest.mark.parametrize("knobs", [
    dict(split_bounce=1), dict(split_bounce=2), dict(split_bounce=3),
    dict(split_bounce=2, split_rebin="octcell"),
    dict(split_bounce=2, split_rebin="octant", split_every=True),
    dict(split_bounce=1, octant_bounce_walks=True, split_every=True),
], ids=["b1", "b2", "b3", "octcell", "every", "octant_walks_every"])
def test_plain_split_matches_plain_k1(small_k1, knobs, monkeypatch):
    cfg, arrays, cam, frag, uv, img, rays = small_k1
    calls = []
    split = megakernel.sample_wave_split
    monkeypatch.setattr(megakernel, "sample_wave_split",
                        lambda *a: calls.append(1) or split(*a))
    simg, srays = render_rays(arrays, frag, uv, cam, cfg.replace(**knobs),
                              rng_key=3, with_stats=True)
    assert len(calls) == cfg.spp  # one split per sample
    assert (simg - img).abs().max().item() <= 1e-6
    assert int(srays) == rays
