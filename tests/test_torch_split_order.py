"""The split-bounce wavefront's state read through the compaction's
permutation (K4's continuation, plain version) on the port's small scene at
32x24: the flow that reads each live ray's rows in place, in pixel order,
gives the colour and ray count of the flow that gathers the 13 rows into
compacted order and scatters the colour back, in every rebin mode and with
split_every; and the compaction's live count, which stays on the device,
is the number of live rays."""

import numpy as np
import pytest
import torch

from rayzen_tpu_torch import RenderConfig, pack_scene
from rayzen_tpu_torch.demo import build_small_scene
from rayzen_tpu_torch.ops import megakernel
from rayzen_tpu_torch.ops.camera_rays import pixel_grid
from rayzen_tpu_torch.packing import world_geometry
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H, MB = 32, 24, 5


@pytest.fixture(scope="module")
def scene():
    s = build_small_scene(W, H)
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=MB, split_bounce=2)
    ws = world_geometry(pack_scene(s, cfg, "cpu"))
    _, uv = pixel_grid(W, H, "cpu")
    act = torch.arange(uv.shape[0]) % 7 != 3  # holes in the wave
    return cfg, ws, s.camera.device_params(), uv, act


def _gathered_split(ws, cfg, uv, act, cam):
    """The split as it ran before the state was read in place: the 13 rows
    gathered into compacted order before each continuation (which then
    reads slots 0..live-1 in order), the colour scattered back through the
    composed permutations."""
    split_b = cfg.split_bounce
    color, rays, state = megakernel.sample_wave_phase1_reference(
        ws, cfg, uv, act, cam, 0, 1, MB)
    n = state.shape[1]
    iota = torch.arange(n, dtype=torch.int32)
    starts = list(range(split_b, MB)) if cfg.split_every else [split_b]
    pix2slot = None
    for i, b_start in enumerate(starts):
        b_stop = starts[i + 1] if i + 1 < len(starts) else MB
        dest, order, live = megakernel._compaction_permutation(
            state[10] > 0.5, state[3], state[4], state[5], cfg.split_rebin,
            origins=(state[0], state[1], state[2]))
        state = state[:, order.long()]
        col = torch.zeros((n, 3), dtype=torch.float32)
        r = torch.zeros((), dtype=torch.int64)
        megakernel.continuation_reference(ws, cfg, state, iota, live, col, r, 0,
                                          1, MB, b_start, b_stop,
                                          emit=b_stop < MB)
        pix2slot = dest.long() if pix2slot is None else dest.long()[pix2slot]
        color = color + col[pix2slot]
        rays = rays + r
    return color, rays


@pytest.mark.parametrize("knobs", [
    dict(split_rebin="rank"), dict(split_rebin="octant"),
    dict(split_rebin="octcell"), dict(split_rebin="octant", split_every=True),
], ids=["rank", "octant", "octcell", "every"])
def test_split_through_order_equals_gathered_flow(scene, knobs):
    cfg, ws, cam, uv, act = scene
    cfg = cfg.replace(**knobs)
    color, rays = megakernel.sample_wave_split(ws, cfg, uv, act, cam, 0, 1, MB)
    g_color, g_rays = _gathered_split(ws, cfg, uv, act, cam)
    torch.testing.assert_close(color, g_color, rtol=0, atol=0)
    assert int(rays) == int(g_rays) > int(act.sum())
    assert (color[~act] == 0).all()


@pytest.mark.parametrize("mode", ["rank", "octant", "octcell"])
def test_compaction_live_count(mode):
    n = 777
    rs = np.random.RandomState(5)
    d = [torch.from_numpy(rs.normal(size=n).astype(np.float32)) for _ in range(3)]
    o = tuple(torch.from_numpy(rs.uniform(-3, 3, size=n).astype(np.float32))
              for _ in range(3))
    for alive in (torch.from_numpy(rs.uniform(size=n) < 0.2),
                  torch.zeros(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool)):
        dest, order, live = megakernel._compaction_permutation(
            alive, *d, mode, origins=o)
        assert live.dtype == torch.int32 and live.dim() == 0
        assert int(live) == int(alive.sum())
        assert alive[order[: int(live)].long()].all()
        assert not alive[order[int(live):].long()].any()
        assert torch.equal(order[dest.long()], torch.arange(n, dtype=torch.int32))
