"""K1's warp map and the K6 packets of the frustum K1 forms, on the CPU.

The plain tile map (megakernel.tile_pixels, the form of csrc/sample_kernel.cu
tile_pixel) against the shape it promises, and the plain frustum K1, whose
packets are the kernel's warps (8 x 4 pixel tiles), against the plain K1.
The kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py).

Six items: pytest-xdist queues test files by their number of tests, so a
file with more than tests/test_parallel.py's seven would start before that
long file and could delay it."""

import pytest
import torch

from rayzen_tpu_torch import RenderConfig
from rayzen_tpu_torch.demo import build_small_scene
from rayzen_tpu_torch.ops import megakernel, walk
from rayzen_tpu_torch.ops.camera_rays import pixel_grid
from rayzen_tpu_torch.packing import pack_scene, world_geometry
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("shape", [(256, 192, None), (33, 17, None),
                                   (1920, 1080, None), (37, 23, 300)],
                         ids=["256x192", "33x17", "1920x1080", "ragged"])
def test_tile_map(shape):
    """Every pixel has exactly one (warp, lane); on a full frame a warp
    covers the 8 x 4 pixels of its cell, clipped at the right and bottom
    edges; a wave that is not a frame is mapped linearly."""
    w, h, n = shape
    n = w * h if n is None else n
    tp = megakernel.tile_pixels(n, w, h)
    assert tp.dim() == 2 and tp.shape[1] == 32
    assert tp.shape[0] % (megakernel.K1_THREADS // 32) == 0  # whole blocks
    on = tp >= 0
    assert torch.equal(tp[on].sort().values, torch.arange(n))
    warps = megakernel.pixel_warps(n, w, h)
    assert torch.equal(warps[tp[on]],
                       torch.arange(tp.shape[0])[:, None].expand_as(tp)[on])
    if n != w * h:
        assert torch.equal(tp.reshape(-1)[:n], torch.arange(n))
        assert (tp.reshape(-1)[n:] == -1).all()
        return
    # a warp's pixels: its 8 x 4 cell (x0, y0), the lanes row by row
    x, y = tp % w, tp // w
    x0 = torch.where(on, x - x % 8, 0).amax(1)
    y0 = torch.where(on, y - y % 4, 0).amax(1)
    lane = torch.arange(32)
    cx, cy = x0[:, None] + lane % 8, y0[:, None] + lane // 8
    inside = (cx < w) & (cy < h)
    has = on.any(1)
    assert torch.equal(on[has], inside[has])  # clipped at the frame's edges
    assert torch.equal(tp[has][inside[has]], (cy * w + cx)[has][inside[has]])
    # every 8 x 4 cell that holds a pixel of the frame is one warp's
    assert int(has.sum()) == -(-w // 8) * -(-h // 4)


@pytest.mark.parametrize("rng", ["threefry", "reference"])
def test_plain_frustum_k1_with_tile_packets(rng, monkeypatch):
    """At 64x48 with an inactive pixel in every warp, 2 spp: the plain
    frustum K1 walks each sample's primary rays in the packets of the
    kernel's warps (both samples in one pass, each sample's packets apart)
    and renders the plain K1's image bit for bit, with equal rays."""
    w, h = 64, 48
    scene = build_small_scene(w, h)
    cfg = RenderConfig(width=w, height=h, spp=2, max_bounces=5, rng=rng)
    ws = world_geometry(pack_scene(scene, cfg, "cpu"))
    cam = scene.camera.device_params()
    _, uv = pixel_grid(w, h, "cpu")
    n = uv.shape[0]
    tp = megakernel.tile_pixels(n, w, h)
    act = torch.ones(n, dtype=torch.bool)
    act[tp[torch.arange(tp.shape[0]), torch.arange(tp.shape[0]) % 32]] = False
    packets = []
    plain = walk.frustum_closest_walk_reference
    monkeypatch.setattr(walk, "frustum_closest_walk_reference",
                        lambda *a, **k: packets.append(k["packet_ids"]) or plain(*a, **k))
    fc, fr = megakernel.sample_wave(ws, cfg.replace(frustum_primary=True), uv, act,
                                    cam, 0, 0, 5, 2)
    monkeypatch.undo()
    idx = act.nonzero()[:, 0]
    assert len(packets) == 1  # one pass: both samples' packet walks, over the warps
    warps = megakernel.pixel_warps(n, w, h)[idx]
    assert torch.equal(packets[0], torch.cat([warps, warps + n]))
    kc, kr = megakernel.sample_wave(ws, cfg, uv, act, cam, 0, 0, 5, 2)
    assert torch.equal(fc, kc) and int(fr) == int(kr) > 0
    assert (fc[~act] == 0).all()
