"""K7's device tables and warp map, and K4's phase 1 with warp-tile
packets, on the CPU.

packing.misslink_tables (the 32-byte node rows and 48-byte triangle rows
the K7 kernel reads) against the records they restate, bit for bit; the
warp map by which K7 and K1 take a wave (every slot exactly once); what
the plain K7 leaves in the slots it does not walk; and the plain phase 1,
whose K6 packets are now the kernel's 8 x 4 warp tiles, inside the plain
split against the JAX split path at 32x24 (interpret mode). The kernels are held to these plain
versions on the card (tests/test_torch_cuda.py).

Seven items: pytest-xdist queues test files by their number of tests, so a
file with more than tests/test_parallel.py's seven would start before that
long file and could delay it."""

import numpy as np
import pytest
import torch

from test_torch_split_jax import MB, H, W, _assert_close, _jax_render, _port_image
from test_torch_split_jax import jax_world  # noqa: F401 (a fixture)
from rayzen_tpu_torch import RenderConfig
from rayzen_tpu_torch.demo import build_demo_scene, build_small_scene
from rayzen_tpu_torch.ops import megakernel, walk
from rayzen_tpu_torch.ops.camera_rays import pixel_grid
from rayzen_tpu_torch.packing import pack_scene, world_geometry
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _world(builder):
    scene = builder(64, 48)
    cfg = RenderConfig(width=64, height=48, spp=1, max_bounces=3)
    return world_geometry(pack_scene(scene, cfg, "cpu")), scene


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("builder", [build_small_scene, build_demo_scene],
                         ids=["small", "demo"])
def test_misslink_tables_match_records(builder):
    """Per node: the box bit for bit, left_first, count and miss decoded from
    the two int words equal to the record's; per leaf triangle left_first + k
    (k < count): v0, e1, e2, the transparency and the encoded material equal
    to the record's inlined ones, bit for bit."""
    ws, _ = _world(builder)
    rec, nodes, tris, K = ws.records, ws.ml_nodes, ws.ml_tris, ws.leaf_k
    assert nodes.shape == (rec.shape[0], 8) and nodes.dtype == torch.float32
    assert tris.shape == (ws.num_triangles, 12) and tris.dtype == torch.float32
    assert torch.equal(_bits(nodes[:, :6]), _bits(rec[:, :6]))
    words = _bits(nodes[:, 6:8]).long() & 0xFFFFFFFF
    left, count, miss = rec[:, 6:9].long().unbind(1)
    assert torch.equal(words[:, 0], left)
    assert torch.equal((words[:, 1] >> 24) - 1, count)
    assert torch.equal((words[:, 1] & 0xFFFFFF) - 1, miss)
    assert (count == -1).any() and (count > 0).any() and (miss == -1).any()
    leaves = (count >= 0).nonzero()[:, 0]
    n_checked = 0
    for k in range(K):
        on = leaves[count[leaves] > k]
        row = tris[left[on] + k]
        inlined = rec[on, 9 + 9 * k: 18 + 9 * k]
        for j, cols in enumerate((slice(0, 3), slice(4, 7), slice(8, 11))):
            assert torch.equal(_bits(row[:, cols]), _bits(inlined[:, 3 * j: 3 * j + 3]))
        assert torch.equal(_bits(row[:, 3]), _bits(rec[on, 9 + 9 * K + k]))
        assert torch.equal(_bits(row[:, 7]), _bits(rec[on, 9 + 10 * K + k]))
        assert (row[:, 11] == 0).all()
        n_checked += on.numel()
    # every world triangle sits in exactly one leaf
    assert n_checked == ws.num_triangles


@pytest.mark.parametrize("wave", [(37, 23, 300), (37, 23, None), (1920, 1080, None)],
                         ids=["ragged", "frame_37x23", "frame_1080p"])
def test_tile_map_takes_every_slot_once(wave):
    """The warp map K7 and K1 share (megakernel.tile_pixels, csrc/common.cuh
    tile_pixel): a wave that is not a whole frame is taken linearly, 32
    consecutive slots a warp; a whole frame in 8 x 4-pixel warp tiles. Either
    way each slot is some lane's exactly once and the padding is -1."""
    w, h, n = wave
    n = w * h if n is None else n
    tp = megakernel.tile_pixels(n, w, h)
    assert tp.shape[1] == 32 and tp.shape[0] % (megakernel.K1_THREADS // 32) == 0
    flat = tp.reshape(-1)
    assert torch.equal(flat[flat >= 0].sort().values, torch.arange(n))
    assert ((flat == -1) | (flat >= 0)).all()
    if n != w * h:
        assert torch.equal(flat[:n], torch.arange(n))
        return
    # a warp's lanes lie in one 8 x 4 tile of the frame
    x, y = tp % w, tp // w
    on = tp >= 0
    big, small = torch.iinfo(torch.int64).max, torch.iinfo(torch.int64).min
    span_x = (torch.where(on, x, small).amax(1) - torch.where(on, x, big).amin(1))
    span_y = (torch.where(on, y, small).amax(1) - torch.where(on, y, big).amin(1))
    live = on.any(1)
    assert (span_x[live] < 8).all() and (span_y[live] < 4).all()
    assert ((tp[0] % w) < 8).all() and ((tp[0] // w) < 4).all()


def test_plain_k7_leaves_dead_slots_as_the_kernel_does():
    """The contract K7 keeps for the slots it does not walk, on the plain
    version (the card tests hold the kernel to it bit for bit): an inactive
    slot reads t = 1e30, tri = -1, cross = 0 and menc = 0 from the closest
    walk and vis = 1 from the shadow walk; the live rays hit and are
    shadowed."""
    ws, scene = _world(build_demo_scene)
    w, h = 64, 48
    _, uv = pixel_grid(w, h, "cpu")
    cam = megakernel._pack_camera(scene.camera.device_params(), "cpu")
    z = torch.zeros_like(uv[:, 0])
    ray = megakernel._raygen_tiles(uv[:, 0], uv[:, 1], z, z, cam)
    o, d = torch.stack(ray[:3], 1), torch.stack(ray[3:], 1)
    act = torch.from_numpy(np.random.RandomState(3).uniform(size=w * h) < 0.7)
    t, tri, cross, menc = walk.closest_walk_misslink(ws, o, d, act, w, h)
    assert (tri[~act] == -1).all() and (t[~act] == 1e30).all()
    assert (cross[~act] == 0).all() and (menc[~act] == 0).all()
    assert (tri[act] >= 0).any()
    hit = walk.decode_hit(ws, o, d, t, tri, cross, menc)
    ldir = torch.tensor([0.3, 0.9, 0.1])
    ldir = (ldir / ldir.norm()).expand_as(o).contiguous()
    so = hit.point + ldir * 1e-3
    vis, rays = walk.shadow_walk_misslink(ws, so, ldir, 50.0, hit.found, width=w,
                                          height=h)
    assert int(rays) == int(hit.found.sum())
    assert (vis[~hit.found] == 1).all() and (vis < 1).any()


def test_plain_phase1_with_tile_packets_matches_jax_split(jax_world, monkeypatch):
    """The plain split with the frustum primary, its phase-1 packets the
    kernel's 8 x 4 warp tiles (megakernel.pixel_warps), against the JAX
    split path with frustum_primary at 32x24: the split tests' bar (1e-6,
    rays equal)."""
    knobs = dict(split_bounce=2, split_rebin="octant", frustum_primary=True)
    _jcfg, _arrays, tws, cam = jax_world
    _, uv = pixel_grid(W, H, "cpu")
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=MB, **knobs)
    act = torch.ones(uv.shape[0], dtype=torch.bool)
    packets = []
    plain = walk.frustum_closest_walk_reference

    def spy(*a, packet_ids=None, **kw):
        packets.append(packet_ids)
        return plain(*a, packet_ids=packet_ids, **kw)

    monkeypatch.setattr(walk, "frustum_closest_walk_reference", spy)
    port = _port_image(*megakernel.sample_wave_split(tws, cfg, uv, act, cam, 0, 0, MB))
    assert len(packets) == 1
    assert torch.equal(packets[0], megakernel.pixel_warps(W * H, W, H))
    _assert_close(port, _jax_render(jax_world, **knobs))
