"""The port's CUDA kernels (K1-K3, K5, K6, K7, K8, the tiered, wide and
frustum K1, K1 with sample fusion, K4's phase 1 and continuation, and the
K9 instantiations) against their plain PyTorch versions on the card, the
regenerating K1 also bit for bit against the lockstep loop (its warp-tiled
K9 form), the live-ray walks K2/K3 and K7 against each other, K4's
continuation forms against each other, and the per-wave path's staged
variants against their plain runs; the frame loop's frames launch their
kernels (K1, K7, K2/K3) and equal the plain Renderer's, its async dispatch
makes no synchronising call, a failed build makes frames raise; the LBVH
built on the card equals the CPU build, and deforming frames make no
synchronising call. Marked
``cuda``: they skip
where torch sees no CUDA device, and run on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(--noconftest: tests/conftest.py sets up JAX, which these tests do not use
and that machine need not have; the kernels are built from
rayzen_tpu_torch/csrc at first use)."""

import numpy as np
import pytest
import torch

from rayzen_tpu_torch import RenderConfig, ext
from rayzen_tpu_torch.integrator import render_rays
from rayzen_tpu_torch.demo import build_small_scene
from rayzen_tpu_torch.ops import megakernel, walk
from rayzen_tpu_torch.ops.camera_rays import pixel_grid
from rayzen_tpu_torch.packing import pack_scene, world_geometry

pytestmark = pytest.mark.cuda

W, H = 48, 32


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    dev = torch.device("cuda", 0)
    scene = build_small_scene(64, 48)
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=5)
    ws = world_geometry(pack_scene(scene, cfg, dev))
    cam = scene.camera.device_params()
    _, uv = pixel_grid(W, H, dev)
    z = torch.zeros_like(uv[:, 0])
    ray = megakernel._raygen_tiles(uv[:, 0], uv[:, 1], z, z,
                                   megakernel._pack_camera(cam, dev))
    o, d = torch.stack(ray[:3], 1), torch.stack(ray[3:], 1)
    # the same scene with the treelet view (the tiered K1 and K8 walk it)
    tws = world_geometry(pack_scene(scene, cfg.replace(tiered="on", treelet_rows=8), dev))
    return dict(dev=dev, cfg=cfg, ws=ws, tws=tws, cam=cam, uv=uv, o=o, d=d)


def test_k2_matches_plain_with_t_init(setup):
    ws, o, d = setup["ws"], setup["o"], setup["d"]
    act = torch.rand(o.shape[0], device=o.device) < 0.9
    t_init = torch.full((o.shape[0],), 4.0, device=o.device)
    for ti in (None, t_init):
        before = ext.LAUNCHES["closest_hit_bvh2"]
        k = walk.closest_walk(ws, o, d, act, ti)
        assert ext.LAUNCHES["closest_hit_bvh2"] == before + 1
        p = walk.closest_walk_reference(ws, o, d, act, ti)
        for a, b in zip(k, p):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_k3_matches_plain(setup):
    ws, o, d = setup["ws"], setup["o"], setup["d"]
    hit = walk.closest_hit_bvh2(ws, o, d, torch.ones_like(o[:, 0], dtype=torch.bool))
    ldir = torch.tensor([0.3, 0.9, 0.1], device=o.device)
    ldir = (ldir / ldir.norm()).expand_as(o).contiguous()
    so = hit.point + ldir * 1e-3
    kv, kr = walk.shadow_walk_bvh2(ws, so, ldir, 50.0, hit.found)
    pv = walk.shadow_walk_reference(ws, so, ldir, 50.0, hit.found)
    torch.testing.assert_close(kv, pv, rtol=0, atol=1e-6)
    assert int(kr) == int(hit.found.sum()) and (kv < 1).any()


@pytest.mark.parametrize("rng", ["threefry", "reference"])
def test_k1_matches_plain(setup, rng):
    cfg = setup["cfg"].replace(rng=rng)
    uv, ws, cam = setup["uv"], setup["ws"], setup["cam"]
    act = torch.ones(uv.shape[0], dtype=torch.bool, device=uv.device)
    kc, kr = megakernel.sample_wave(ws, cfg, uv, act, cam, 0, 0, 5, 2)
    pc, pr = megakernel.sample_wave_reference(ws, cfg, uv, act, cam, 0, 0, 5, 2)
    err = (kc - pc).abs().amax(-1).cpu().numpy()
    assert (err < 1e-4).mean() >= 0.998
    assert kr.dtype == torch.int64 and int(kr) == int(pr)


def test_k8_matches_plain_and_whole_tree(setup):
    tws, o, d = setup["tws"], setup["o"], setup["d"]
    assert tws.tiered
    act = torch.rand(o.shape[0], device=o.device) < 0.9
    before = ext.LAUNCHES["closest_hit_tiered"]
    k = walk.closest_walk_tiered(tws, o, d, act)
    assert ext.LAUNCHES["closest_hit_tiered"] == before + 1
    p = walk.tiered_closest_walk_reference(tws, o, d, act)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    counted, lanes, slots = walk.live_lane_counts(tws, o, d, act, kind="tiered")
    assert all(torch.equal(a, b) for a, b in zip(counted, k))
    assert 0 < lanes <= slots and slots % 32 == 0
    whole = walk.closest_walk(tws, o, d, act)  # K2 on the whole tree
    assert (k[1] != whole[1]).sum() == 0
    hit = walk.decode_hit(tws, o, d, *k)
    ldir = torch.tensor([0.3, 0.9, 0.1], device=o.device)
    ldir = (ldir / ldir.norm()).expand_as(o).contiguous()
    so = hit.point + ldir * 1e-3
    kv, kr = walk.shadow_walk_tiered(tws, so, ldir, 50.0, hit.found)
    pv = walk.tiered_shadow_walk_reference(tws, so, ldir, 50.0, hit.found)
    wv, _ = walk.shadow_walk_bvh2(tws, so, ldir, 50.0, hit.found)
    assert torch.equal(kv, pv)
    torch.testing.assert_close(kv, wv, rtol=0, atol=1e-6)
    cv, _lanes, _slots = walk.live_lane_counts(tws, so, ldir, hit.found,
                                               kind="tiered", max_dist=50.0)
    assert torch.equal(cv, kv)
    assert int(kr) == int(hit.found.sum()) and (kv < 1).any()


@pytest.mark.parametrize("rng", ["threefry", "reference"])
def test_tiered_k1_matches_plain(setup, rng):
    cfg = setup["cfg"].replace(rng=rng)
    uv, tws, cam = setup["uv"], setup["tws"], setup["cam"]
    act = torch.ones(uv.shape[0], dtype=torch.bool, device=uv.device)
    before = ext.LAUNCHES["sample_wave_tiered"]
    kc, kr = megakernel.sample_wave(tws, cfg, uv, act, cam, 0, 0, 5, 2)
    assert ext.LAUNCHES["sample_wave_tiered"] == before + 1
    pc, pr = megakernel.sample_wave_reference(tws, cfg, uv, act, cam, 0, 0, 5, 2)
    err = (kc - pc).abs().amax(-1).cpu().numpy()
    assert (err < 1e-4).mean() >= 0.998
    assert kr.dtype == torch.int64 and int(kr) == int(pr)


def test_kernel_overflow_poisons_nan(setup):
    dev = setup["dev"]
    n = 300  # deeper than the stack: the walk must stop and poison
    inner = np.zeros((n, 16), np.float32)
    inner[:, 0:3] = inner[:, 6:9] = -1e9
    inner[:, 3:6] = inner[:, 9:12] = 1e9
    inner[:, 12], inner[:, 14] = np.arange(1, n + 1), -1  # ladder: both children
    inner[:, 13], inner[:, 15] = np.arange(1, n + 1), -1  # -> the next node
    inner[n - 1, 12:16] = [0, 0, 1, 1]
    ws = setup["ws"]
    ladder = type(ws)(**{**ws.__dict__, "inner_table": torch.from_numpy(inner).to(dev),
                         "tree_depth": 0})
    o = torch.zeros(64, 3, device=dev)
    d = torch.zeros(64, 3, device=dev)
    d[:, 2] = 1.0
    act = torch.ones(64, dtype=torch.bool, device=dev)
    t, _tri, _cross, menc = walk.closest_walk(ladder, o, d, act)
    assert torch.isnan(t).all() and torch.isnan(menc).all()
    vis, _ = walk.shadow_walk_bvh2(ladder, o, d, 50.0, act)
    assert torch.isnan(vis).all()


def test_mixed_devices_raise(setup):
    ws, o, d = setup["ws"], setup["o"], setup["d"]
    with pytest.raises(ValueError):
        walk.closest_walk(ws, o, d.cpu(), torch.ones(o.shape[0], dtype=torch.bool))


def _split_pair(setup, **knobs):
    """(kernel, plain) split sample of the 48x32 wave, and K1's."""
    cfg = setup["cfg"].replace(**knobs)
    uv, ws, cam = setup["uv"], setup["ws"], setup["cam"]
    act = torch.ones(uv.shape[0], dtype=torch.bool, device=uv.device)
    args = (ws, cfg, uv, act, cam, 1, 2, 5)
    return (megakernel.sample_wave_split(*args),
            megakernel.sample_wave_split_reference(*args),
            megakernel.sample_wave(ws, cfg, uv, act, cam, 1, 2, 5))


@pytest.mark.parametrize("knobs", [
    dict(split_bounce=2), dict(split_bounce=2, split_rebin="octant"),
    dict(split_bounce=2, split_rebin="octcell"),
    dict(split_bounce=2, split_rebin="octant", split_every=True),
    dict(split_bounce=1, split_every=True, octant_bounce_walks=True),
], ids=["rank", "octant", "octcell", "every", "every_k9"])
def test_split_matches_plain(setup, knobs):
    octant = "_octant" if knobs.get("octant_bounce_walks") else ""
    before = dict(ext.LAUNCHES)
    (kc, kr), (pc, pr), (fc, fr) = _split_pair(setup, **knobs)
    n_cont = 5 - knobs["split_bounce"] if knobs.get("split_every") else 1
    assert ext.LAUNCHES["sample_wave_phase1" + octant] == before["sample_wave_phase1" + octant] + 1
    assert ext.LAUNCHES["continuation" + octant] == before["continuation" + octant] + n_cont
    assert (kc - pc).abs().max().item() <= 1e-6 and int(kr) == int(pr)
    assert (kc - fc).abs().max().item() <= 1e-6 and int(kr) == int(fr)


# K4's continuation alone: (width, height, holes in active, split_bounce,
# rebin); 640x480 at split_bounce 1 leaves more live rays (~150k) than the
# persistent grid has lanes (132 SMs x 1,024)
CONT_CASES = [(48, 32, False, 2, "rank"), (37, 23, True, 2, "octant"),
              (37, 23, True, 1, "octcell"), (640, 480, False, 1, "octant")]


@pytest.mark.parametrize("case", CONT_CASES,
                         ids=["rank", "ragged_octant", "ragged_b1_octcell",
                              "b1_more_rays_than_lanes"])
def test_continuation_matches_plain(setup, case):
    """K4's continuation reads the live rays' rows through the compaction's
    permutation and live count (left on the device) and adds into phase 1's
    colour and ray total in place: against the plain version its rays and
    written rows are equal and its colour within the split tests' bar, dead
    pixels untouched, to the end (b_stop 5) and for one bounce with the
    rows written back (split_every); its K9 form gives the plain form's
    results bit for bit, and each form's counting instantiation its own."""
    w, h, holes, sb, rebin = case
    dev, ws, cam = setup["dev"], setup["ws"], setup["cam"]
    cfg = setup["cfg"].replace(width=w, height=h, rng="reference", split_bounce=sb,
                               split_rebin=rebin)
    _, uv = pixel_grid(w, h, dev)
    act = torch.ones(uv.shape[0], dtype=torch.bool, device=dev)
    if holes:
        act = torch.arange(uv.shape[0], device=dev) % 11 != 4
    c1, r1, st = megakernel.sample_wave_phase1(ws, cfg, uv, act, cam, 3, 0, 5)
    _d, order, live = megakernel._compaction_permutation(
        st[10] > 0.5, st[3], st[4], st[5], rebin, origins=(st[0], st[1], st[2]))
    n_live = int(live)
    assert n_live == int((st[10] > 0.5).sum()) > 0
    dead = order[n_live:].long()

    def run(fn, cfg_, b_stop):
        color, rays, state = c1.clone(), r1.clone(), st.clone()
        out = fn(ws, cfg_, state, order, live, color, rays, 3, 0, 5, sb, b_stop,
                 b_stop < 5)
        return color, rays, state, out

    for b_stop in (5, sb + 1):
        forms = {}
        for octant in (False, True):
            c_ = cfg.replace(octant_bounce_walks=octant)
            name = "continuation" + ("_octant" if octant else "")
            before = ext.LAUNCHES[name]
            kc, kr, ks, _ = run(megakernel.continuation, c_, b_stop)
            assert ext.LAUNCHES[name] == before + 1
            pc, pr, ps, _ = run(megakernel.continuation_reference, c_, b_stop)
            assert int(kr) == int(pr) > int(r1) and torch.equal(ks, ps)
            assert ((kc - pc).abs() / pc.abs().clamp_min(1.0)).max().item() <= 1e-6
            assert torch.equal(kc[dead], c1[dead])
            assert torch.equal(ks[:, dead], st[:, dead])
            cc, cr, cs, (lanes, slots) = run(megakernel.continuation_lane_counts,
                                             c_, b_stop)
            assert torch.equal(cc, kc) and int(cr) == int(kr) and torch.equal(cs, ks)
            assert 0 < lanes <= slots and slots % 32 == 0
            forms[octant] = (kc, kr, ks)
        (a, ar, as_), (b, br, bs) = forms[False], forms[True]
        assert torch.equal(a, b) and int(ar) == int(br) and torch.equal(as_, bs)
    for form in megakernel.CONTINUATION_FORMS:
        b = megakernel.sample_budget(form)
        assert b["threads"] == 128 and 0 < b["regs"] <= 64
        assert b["warps_per_sm"] == 32


# Waves of the K9 and K6 forms' checks: (width, height, spp, rng, holes);
# 37x23 is no multiple of the 16x8 block tile.
FORM_WAVES = [(48, 32, 2, "reference", False), (37, 23, 1, "threefry", True),
              (37, 23, 8, "reference", True)]


def _form_wave(setup, wave):
    w, h, spp, rng, holes = wave
    cfg = setup["cfg"].replace(width=w, height=h, rng=rng)
    _, uv = pixel_grid(w, h, setup["dev"])
    act = torch.ones(uv.shape[0], dtype=torch.bool, device=uv.device)
    if holes:
        act = torch.arange(uv.shape[0], device=uv.device) % 29 != 3
    return cfg, uv, act, spp


@pytest.mark.parametrize("wave", FORM_WAVES, ids=["48x32", "ragged", "ragged_spp8"])
@pytest.mark.parametrize("tiered", [False, True])
def test_octant_k1_matches_plain_and_k1(setup, tiered, wave):
    """The K9 form (the warp-tiled lockstep loop) renders its plain version's
    image and the same view's (regenerating) K1 image bit for bit."""
    ws = setup["tws"] if tiered else setup["ws"]
    cfg, uv, act, spp = _form_wave(setup, wave)
    ocfg = cfg.replace(octant_bounce_walks=True)
    cam = setup["cam"]
    name = "sample_wave" + ("_tiered" if tiered else "") + "_octant"
    before = ext.LAUNCHES[name]
    kc, kr = megakernel.sample_wave(ws, ocfg, uv, act, cam, 0, 0, 5, spp)
    assert ext.LAUNCHES[name] == before + 1
    pc, pr = megakernel.sample_wave_reference(ws, ocfg, uv, act, cam, 0, 0, 5, spp)
    fc, fr = megakernel.sample_wave(ws, cfg, uv, act, cam, 0, 0, 5, spp)
    assert (kc - pc).abs().max().item() <= 1e-6 and int(kr) == int(pr)
    torch.testing.assert_close(kc, fc, rtol=0, atol=0)  # the same hits as K1
    assert int(kr) == int(fr)


def _light_rays(hit, o):
    ldir = torch.tensor([0.3, 0.9, 0.1], device=o.device)
    ldir = (ldir / ldir.norm()).expand_as(o).contiguous()
    return hit.point + ldir * 1e-3, ldir


def test_k5_matches_plain_and_k2(setup):
    ws, o, d = setup["ws"], setup["o"], setup["d"]
    act = torch.rand(o.shape[0], device=o.device) < 0.9
    before = ext.LAUNCHES["closest_hit_bvh8"]
    k = walk.closest_walk_bvh8(ws, o, d, act)
    assert ext.LAUNCHES["closest_hit_bvh8"] == before + 1
    p = walk.wide_closest_walk_reference(ws, o, d, act)
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    k2 = walk.closest_walk(ws, o, d, act)
    hit = k2[1] >= 0
    assert hit.any() and torch.equal(k[0][hit], k2[0][hit])
    assert ((k[1] != k2[1]) & (k[0] != k2[0])).sum() == 0  # ties only
    kh = walk.decode_hit(ws, o, d, *k2)
    so, ldir = _light_rays(kh, o)
    kv, kr = walk.shadow_walk_bvh8(ws, so, ldir, 50.0, kh.found)
    pv = walk.wide_shadow_walk_reference(ws, so, ldir, 50.0, kh.found)
    v3, _ = walk.shadow_walk_bvh2(ws, so, ldir, 50.0, kh.found)
    torch.testing.assert_close(kv, pv, rtol=0, atol=1e-6)
    torch.testing.assert_close(kv, v3, rtol=0, atol=1e-6)
    assert int(kr) == int(kh.found.sum()) and (kv < 1).any()


@pytest.mark.parametrize("frame", [(0, 0), (W, H)], ids=["linear", "tiles"])
def test_k6_matches_plain_and_k2(setup, frame):
    """K6 over 32 consecutive rays a packet and over the frame's warp tiles:
    bit for bit its plain version with the same packets (closest and
    shadow, and their counting forms), K2's t, K3's vis where lit."""
    ws, o, d = setup["ws"], setup["o"], setup["d"]
    act = torch.rand(o.shape[0], device=o.device) < 0.9
    before = dict(ext.LAUNCHES)
    k = walk.closest_walk_frustum(ws, o, d, act, *frame)
    p = walk.frustum_closest_walk_reference(ws, o, d, act, width=frame[0],
                                            height=frame[1])
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    counted, lanes, slots = walk.live_lane_counts(ws, o, d, act, kind="frustum",
                                                  width=frame[0], height=frame[1])
    assert all(torch.equal(a, b) for a, b in zip(counted, k))
    assert 0 < lanes <= slots and slots % 32 == 0
    k2 = walk.closest_walk(ws, o, d, act)
    hit = k2[1] >= 0
    assert hit.any() and torch.equal(k[0][hit], k2[0][hit])
    kh = walk.decode_hit(ws, o, d, *k2)
    so, ldir = _light_rays(kh, o)
    kv, kr = walk.shadow_walk_frustum(ws, so, ldir, 50.0, kh.found, 0.05, 1e-3,
                                      *frame)
    pv = walk.frustum_shadow_walk_reference(ws, so, ldir, 50.0, kh.found,
                                            width=frame[0], height=frame[1])
    v3, _ = walk.shadow_walk_bvh2(ws, so, ldir, 50.0, kh.found)
    lit = pv > 0.05
    assert torch.equal(kv, pv)
    assert torch.equal(kv > 0.05, lit) and torch.equal(v3 > 0.05, lit)
    torch.testing.assert_close(kv[lit], v3[lit], rtol=0, atol=1e-6)
    assert int(kr) == int(kh.found.sum()) and (kv < 1).any()
    cv, _lanes, _slots = walk.live_lane_counts(
        ws, so, ldir, kh.found, kind="frustum", max_dist=50.0, width=frame[0],
        height=frame[1])
    assert torch.equal(cv, kv)
    for name in ("closest_hit_frustum", "shadow_walk_frustum"):
        assert ext.LAUNCHES[name] == before[name] + 1


@pytest.mark.parametrize("wave", [(64, 48, 2), (37, 23, 1), (37, 23, 8)],
                         ids=["64x48", "ragged", "ragged_spp8"])
@pytest.mark.parametrize("knobs", [
    dict(wide_nodes=True), dict(wide_nodes=True, octant_bounce_walks=True),
    dict(frustum_primary=True),
    dict(frustum_primary=True, octant_bounce_walks=True),
], ids=["wide", "wide_octant", "frustum", "frustum_octant"])
@pytest.mark.parametrize("rng", ["threefry", "reference"])
def test_wide_and_frustum_k1_match_plain_and_k1(setup, knobs, rng, wave):
    """With an inactive pixel in every warp: the K1 form renders its plain
    version's and K1's image (the frustum forms' plain version walks every
    sample's primary rays in the packets of the kernel's warps, 8 x 4 pixel
    tiles)."""
    dev, ws, cam = setup["dev"], setup["ws"], setup["cam"]
    w, h, spp = wave
    cfg = setup["cfg"].replace(width=w, height=h, rng=rng)
    _, uv = pixel_grid(w, h, dev)
    act = torch.arange(uv.shape[0], device=dev) % 29 != 3
    name = ("sample_wave" + ("_wide" if knobs.get("wide_nodes") else "")
            + ("_frustum" if knobs.get("frustum_primary") else "")
            + ("_octant" if knobs.get("octant_bounce_walks") else ""))
    before = ext.LAUNCHES[name]
    kc, kr = megakernel.sample_wave(ws, cfg.replace(**knobs), uv, act, cam, 0, 0, 5, spp)
    assert ext.LAUNCHES[name] == before + 1
    pc, pr = megakernel.sample_wave_reference(ws, cfg.replace(**knobs), uv, act,
                                              cam, 0, 0, 5, spp)
    fc, fr = megakernel.sample_wave(ws, cfg, uv, act, cam, 0, 0, 5, spp)
    assert (kc - pc).abs().max().item() <= 1e-6 and int(kr) == int(pr)
    torch.testing.assert_close(kc, fc, rtol=0, atol=0)  # the same hits as K1
    assert int(kr) == int(fr)


@pytest.mark.parametrize("octant", [False, True])
def test_frustum_phase1_matches_plain(setup, octant):
    knobs = dict(split_bounce=2, frustum_primary=True, octant_bounce_walks=octant)
    name = "sample_wave_phase1_frustum" + ("_octant" if octant else "")
    before = ext.LAUNCHES[name]
    (kc, kr), (pc, pr), (fc, fr) = _split_pair(setup, **knobs)
    assert ext.LAUNCHES[name] == before + 1
    assert (kc - pc).abs().max().item() <= 1e-6 and int(kr) == int(pr)
    assert (kc - fc).abs().max().item() <= 1e-6 and int(kr) == int(fr)


def test_wide_kernel_overflow_poisons_nan(setup):
    """A wide ladder deeper than the stack (each node pushes 8 children, one
    of them the next rung): the K5 walks stop and poison."""
    dev, ws = setup["dev"], setup["ws"]
    n = 40
    inner8 = np.zeros((n, 72), np.float32)
    box = np.array([-1e9, -1e9, -1e9, 1e9, 1e9, 1e9], np.float32)
    inner8[:, :48] = np.tile(box, 8)
    inner8[:, 48:56] = np.minimum(np.arange(n)[:, None] + 1, n - 1)
    inner8[:, 56:64] = -1  # all internal
    inner8[n - 1, 56:64] = 0  # the last rung: padding only
    ladder = type(ws)(**{**ws.__dict__, "wide_stack": 0,
                         "inner8_table": torch.from_numpy(inner8).to(dev)})
    o = torch.zeros(64, 3, device=dev)
    d = torch.zeros(64, 3, device=dev)
    d[:, 2] = 1.0
    act = torch.ones(64, dtype=torch.bool, device=dev)
    t, _tri, _cross, menc = walk.closest_walk_bvh8(ladder, o, d, act)
    assert torch.isnan(t).all() and torch.isnan(menc).all()
    vis, _ = walk.shadow_walk_bvh8(ladder, o, d, 50.0, act)
    assert torch.isnan(vis).all()


def test_k7_matches_plain_and_k2(setup):
    """K7 closest: the plain version's triangle and t to the bit, and K2's;
    K7 shadow: the plain version's vis exactly, inactive rays 1."""
    ws, o, d = setup["ws"], setup["o"], setup["d"]
    act = torch.rand(o.shape[0], device=o.device) < 0.9
    before = ext.LAUNCHES["closest_hit_misslink"]
    k = walk.closest_walk_misslink(ws, o, d, act)
    assert ext.LAUNCHES["closest_hit_misslink"] == before + 1
    p = walk.misslink_closest_walk_reference(ws, o, d, act)
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    k2 = walk.closest_walk(ws, o, d, act)
    assert torch.equal(k[1], k2[1]) and torch.equal(k[0], k2[0])
    hit = walk.decode_hit(ws, o, d, *k)
    ldir = torch.tensor([0.3, 0.9, 0.1], device=o.device)
    ldir = (ldir / ldir.norm()).expand_as(o).contiguous()
    so = hit.point + ldir * 1e-3
    kv, kr = walk.shadow_walk_misslink(ws, so, ldir, 50.0, hit.found)
    pv = walk.misslink_shadow_walk_reference(ws, so, ldir, 50.0, hit.found)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    assert int(kr) == int(hit.found.sum()) and (kv < 1).any()
    assert (kv[~hit.found] == 1).all()


# K7's waves: the share of slots that are live (None: a wave of no slots)
# and whether the wave is a whole W x H frame, whose rays the kernel takes in
# warp tiles; 6.6% is the demo's share of paths alive after bounce 1.
K7_WAVES = [(0.0, True), (0.066, True), (0.5, True), (1.0, True),
            (0.5, False), (None, True)]


@pytest.mark.parametrize("wave", K7_WAVES, ids=["dead", "live6.6", "live50",
                                                 "live100", "live50_linear",
                                                 "empty"])
def test_live_walks_match_plain_and_k7(setup, wave):
    """The live-ray launch (each live slot walked by its own thread, in warp
    tiles on a whole frame) of K7 and of K2/K3 gives every slot the plain
    version's result bit for bit: closest (t, tri, cross, menc; dead slots
    T_FAR, -1, 0, 0) and shadow (vis; dead slots 1); K2 finds K7's triangle
    and t; the counting forms walk to the same results and count at most 32
    active lanes per warp step."""
    share, tiled = wave
    ws, o, d = setup["ws"], setup["o"], setup["d"]
    n = 0 if share is None else o.shape[0]
    o, d = o[:n].contiguous(), d[:n].contiguous()
    act = torch.from_numpy(np.random.RandomState(11).uniform(size=n) < (share or 0))
    act = act.to(o.device)
    frame = (W, H) if tiled else (0, 0)
    before = dict(ext.LAUNCHES)
    k = walk.closest_walk_misslink(ws, o, d, act, *frame)
    k2 = walk.closest_walk(ws, o, d, act, None, *frame)
    for name in ("closest_hit_misslink", "closest_hit_bvh2"):
        assert ext.LAUNCHES[name] == before[name] + (n > 0)
    for a, b in zip(k, walk.misslink_closest_walk_reference(ws, o, d, act)):
        assert torch.equal(a, b)
    for a, b in zip(k2, walk.closest_walk_reference(ws, o, d, act)):
        assert torch.equal(a, b)
    assert torch.equal(k2[1], k[1]) and torch.equal(k2[0], k[0])
    assert (k[1][~act] == -1).all() and (k[3][~act] == 0).all()
    for kind, out in (("misslink", k), ("bvh2", k2)):
        counted, lanes, slots = walk.live_lane_counts(ws, o, d, act, kind=kind,
                                                      width=frame[0],
                                                      height=frame[1])
        assert all(torch.equal(a, b) for a, b in zip(counted, out))
        assert 0 <= lanes <= slots and slots % 32 == 0
        assert (lanes > 0) == bool(act.any())
    hit = walk.decode_hit(ws, o, d, *k)
    ldir = torch.tensor([0.3, 0.9, 0.1], device=o.device)
    ldir = (ldir / ldir.norm()).expand_as(o).contiguous()
    so = hit.point + ldir * 1e-3
    shadows = {}
    for kind, fn, plain in (
            ("misslink", walk.shadow_walk_misslink, walk.misslink_shadow_walk_reference),
            ("bvh2", walk.shadow_walk_bvh2, walk.shadow_walk_reference)):
        kv, kr = fn(ws, so, ldir, 50.0, hit.found, width=frame[0], height=frame[1])
        assert torch.equal(kv, plain(ws, so, ldir, 50.0, hit.found))
        assert int(kr) == int(hit.found.sum()) and (kv[~hit.found] == 1).all()
        cv, lanes, slots = walk.live_lane_counts(ws, so, ldir, hit.found, kind=kind,
                                                 max_dist=50.0, width=frame[0],
                                                 height=frame[1])
        assert torch.equal(cv, kv) and 0 <= lanes <= slots
        shadows[kind] = kv
    assert torch.equal(shadows["bvh2"], shadows["misslink"])


def test_live_walk_budget():
    """Every standalone walk (K7, K2, K3, K8 and K6) compiles and holds its
    register budget (__launch_bounds__: at least 32 resident warps per
    SM)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    for form in walk.LIVE_FORMS:
        b = walk.live_budget(form)
        assert b["threads"] == 128 and 0 < b["regs"] <= 64
        assert b["warps_per_sm"] >= 32


PHASE1_FORMS = [{}, dict(octant_bounce_walks=True), dict(frustum_primary=True),
                dict(frustum_primary=True, octant_bounce_walks=True)]


@pytest.mark.parametrize("wave", [(48, 32, False), (37, 23, True)],
                         ids=["48x32", "ragged_holes"])
@pytest.mark.parametrize("knobs", PHASE1_FORMS,
                         ids=["plain", "octant", "frustum", "frustum_octant"])
def test_phase1_matches_plain(setup, knobs, wave):
    """K4's phase 1 on K1's warp tiles: its 13 state rows equal the plain
    version's exactly and its colour within the split tests' bar (rays
    equal); the counting form writes the same colour, rays and rows."""
    w, h, holes = wave
    cfg = setup["cfg"].replace(width=w, height=h, rng="reference", split_bounce=2,
                               **knobs)
    _, uv = pixel_grid(w, h, setup["dev"])
    act = torch.ones(uv.shape[0], dtype=torch.bool, device=uv.device)
    if holes:
        act = torch.arange(uv.shape[0], device=uv.device) % 11 != 4
    args = (setup["ws"], cfg, uv, act, setup["cam"], 3, 0, 5)
    kc, kr, ks = megakernel.sample_wave_phase1(*args)
    pc, pr, ps = megakernel.sample_wave_phase1_reference(*args)
    assert torch.equal(ks, ps) and int(kr) == int(pr)
    assert ((kc - pc).abs() / pc.abs().clamp_min(1.0)).max().item() <= 1e-6
    cc, cr, lanes, slots = megakernel.walk_lane_counts(*args, phase1=True)
    assert torch.equal(cc, kc) and int(cr) == int(kr) and 0 < lanes <= slots
    if not knobs:
        b = megakernel.sample_budget("phase1")
        assert b["threads"] == megakernel.K1_THREADS
        assert 0 < b["regs"] <= 64 and b["warps_per_sm"] == 32


@pytest.mark.parametrize("kernels", ["pallas-ml", "pallas-bvh2", "pallas-nomega"])
def test_staged_variants_launch_their_kernels(setup, kernels):
    """Each staged variant on CUDA tensors launches its walks (and no K1)
    and renders the frame of the same config run on CPU tensors, where the
    plain walks stand in, within float32 rounding of the torch glue."""
    cfg = setup["cfg"].replace(kernels=kernels, rng="threefry", max_bounces=3)
    ws_cpu_arrays = pack_scene(build_small_scene(64, 48), cfg, "cpu")
    arrays = pack_scene(build_small_scene(64, 48), cfg, setup["dev"])
    frag, uv = pixel_grid(W, H, setup["dev"])
    ext.reset_launches()
    img, rays = render_rays(arrays, frag, uv, setup["cam"], cfg, with_stats=True)
    got = {k: v for k, v in ext.LAUNCHES.items() if v}
    expect = {"pallas-ml": {"closest_hit_misslink", "shadow_walk_misslink"},
              "pallas-bvh2": {"closest_hit_bvh2", "shadow_walk_bvh2"},
              "pallas-nomega": {"closest_hit_frustum", "closest_hit_bvh2",
                                "shadow_walk_bvh2"}}[kernels]
    assert set(got) == expect
    cfrag, cuv = pixel_grid(W, H, "cpu")
    pimg, prays = render_rays(ws_cpu_arrays, cfrag, cuv, setup["cam"], cfg,
                              with_stats=True)
    assert int(rays) == int(prays)
    assert (img.cpu() - pimg).abs().max().item() <= 1e-4


def test_fused_k1_matches_plain(setup):
    """K1 with sample_fuse=2 at 4 spp sums in the plain version's order."""
    cfg = setup["cfg"].replace(rng="threefry", sample_fuse=2)
    uv, ws, cam = setup["uv"], setup["ws"], setup["cam"]
    act = torch.ones(uv.shape[0], dtype=torch.bool, device=uv.device)
    kc, kr = megakernel.sample_wave(ws, cfg, uv, act, cam, 0, 0, 5, 4)
    pc, pr = megakernel.sample_wave_reference(ws, cfg, uv, act, cam, 0, 0, 5, 4)
    err = (kc - pc).abs().amax(-1).cpu().numpy()
    assert (err < 1e-4).mean() >= 0.998
    assert int(kr) == int(pr)


# The regenerating, warp-tiled K1 (rz_sample_wave, _tiered, _wide): at
# ragged frame sizes (37x23 is no multiple of the 16x8 block tile), with
# holes in ``active``, on a wave that is not a whole frame (mapped linearly),
# at 1, 2, 3 and 8 spp, with sample_fuse 2 and 3, in both RNG flows. Each
# frame is held to the plain version (relative 1e-6 of max(1, |plain|), the
# split tests' bar; rays equal), to a second launch bit for bit, to the same
# view's K9 form bit for bit (the warp-tiled lockstep loop).
REGEN_CASES = [
    dict(size=(37, 23), spp=1, fuse=1, rng="threefry", holes=False, part=False),
    dict(size=(37, 23), spp=3, fuse=3, rng="reference", holes=True, part=False),
    dict(size=(37, 23), spp=8, fuse=2, rng="threefry", holes=True, part=False),
    dict(size=(48, 32), spp=3, fuse=1, rng="reference", holes=False, part=False),
    dict(size=(37, 23), spp=2, fuse=1, rng="threefry", holes=True, part=True),
    dict(size=(37, 23), spp=3, fuse=1, rng="reference", holes=True, part=False),
]

# the K1 forms (megakernel.BUDGET_POLICIES): the view's walks and the knobs
# that select them
FORMS = {"bvh2": {}, "tiered": {}, "wide": dict(wide_nodes=True),
         "octant": dict(octant_bounce_walks=True),
         "tiered_octant": dict(octant_bounce_walks=True),
         "wide_octant": dict(wide_nodes=True, octant_bounce_walks=True),
         "frustum": dict(frustum_primary=True),
         "frustum_octant": dict(frustum_primary=True, octant_bounce_walks=True)}


def _regen_inputs(setup, view, case):
    dev = setup["dev"]
    w, h = case["size"]
    cfg = setup["cfg"].replace(width=w, height=h, spp=case["spp"], rng=case["rng"],
                               sample_fuse=case["fuse"], **FORMS[view])
    _, uv = pixel_grid(w, h, dev)
    if case["part"]:  # every third pixel: not a whole frame
        uv = uv[::3].contiguous()
    act = torch.ones(uv.shape[0], dtype=torch.bool, device=dev)
    if case["holes"]:
        act = torch.arange(uv.shape[0], device=dev) % 7 != 2
    ws = setup["tws"] if view.startswith("tiered") else setup["ws"]
    return ws, cfg, uv, act


@pytest.mark.parametrize("case", REGEN_CASES,
                         ids=["ragged", "holes_fuse3", "spp8_fuse2", "full_tiles",
                              "part_wave", "holes"])
@pytest.mark.parametrize("view", ["bvh2", "tiered", "wide"])
def test_regen_k1_matches_plain_and_lockstep(setup, view, case):
    ws, cfg, uv, act = _regen_inputs(setup, view, case)
    cam, spp = setup["cam"], case["spp"]
    name = "sample_wave" + {"bvh2": "", "tiered": "_tiered", "wide": "_wide"}[view]
    before = ext.LAUNCHES[name]
    kc, kr = megakernel.sample_wave(ws, cfg, uv, act, cam, 0, 3, 5, spp)
    kc2, kr2 = megakernel.sample_wave(ws, cfg, uv, act, cam, 0, 3, 5, spp)
    assert ext.LAUNCHES[name] == before + 2
    assert torch.equal(kc, kc2) and int(kr) == int(kr2)
    pc, pr = megakernel.sample_wave_reference(ws, cfg, uv, act, cam, 0, 3, 5, spp)
    assert ((kc - pc).abs() / pc.abs().clamp_min(1.0)).max().item() <= 1e-6
    assert int(kr) == int(pr) and int(kr) > 0
    assert (kc[~act] == 0).all()
    oc, orr = megakernel.sample_wave(ws, cfg.replace(octant_bounce_walks=True), uv,
                                     act, cam, 0, 3, 5, spp)
    assert torch.equal(kc, oc) and int(kr) == int(orr)


@pytest.mark.parametrize("case", [REGEN_CASES[1], REGEN_CASES[5]],
                         ids=["holes_fuse3", "holes"])
@pytest.mark.parametrize("view", megakernel.BUDGET_POLICIES)
def test_counting_k1_renders_k1s_frame(setup, view, case):
    """Every K1 form compiles to at most 64 registers and 32 resident warps
    per SM (__launch_bounds__(128, 8)), in blocks of the K1_THREADS threads
    that the plain version's warp map (tile_pixels) assumes; the counting
    instantiation of each form renders that form's frame bit for bit and
    counts at most 32 active lanes per warp step, with sample fusion and
    without (fusion turns the K6 primary off, so the fused frustum cases
    count the K1 and K9 forms)."""
    budget = megakernel.sample_budget(view)
    assert budget["threads"] == megakernel.K1_THREADS == 128
    assert 0 < budget["regs"] <= 64 and budget["warps_per_sm"] == 32
    ws, cfg, uv, act = _regen_inputs(setup, view, case)
    knobs = FORMS[view]
    name = ("sample_wave" + ("_tiered" if view.startswith("tiered") else "")
            + ("_wide" if knobs.get("wide_nodes") else "")
            + ("_frustum" if knobs.get("frustum_primary") and case["fuse"] == 1
               else "")
            + ("_octant" if knobs.get("octant_bounce_walks") else "") + "_count")
    before = ext.LAUNCHES[name]
    cc, cr, active, slots = megakernel.walk_lane_counts(ws, cfg, uv, act,
                                                        setup["cam"], 0, 3, 5, 3)
    kc, kr = megakernel.sample_wave(ws, cfg, uv, act, setup["cam"], 0, 3, 5, 3)
    assert torch.equal(cc, kc) and int(cr) == int(kr)
    assert 0 < active <= slots and slots % 32 == 0
    assert ext.LAUNCHES[name] == before + 1


# ---- the frame loop on the card ---------------------------------------------


def _renderer(dev, tmp_path, **knobs):
    from rayzen_tpu_torch.renderer import Renderer

    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=5,
                       cache_dir=str(tmp_path), **knobs)
    return Renderer(build_small_scene(W, H), cfg, async_compile=False,
                    use_cache=False, device=dev)


def test_renderer_frames_run_their_kernels(setup, tmp_path):
    """Path-traced frames launch K1 once each, preview frames K7, chunked
    frames K2/K3 (and no K1); each frame is its plain version's (the same
    Renderer on the CPU) to 1e-6 with the same ray count."""
    dev = setup["dev"]
    for knobs, mode, kernels in (
            (dict(), "pt", {"sample_wave"}),
            (dict(), "preview", {"closest_hit_misslink"}),
            (dict(tiered="off", chunk_tris=100), "pt",
             {"closest_hit_bvh2", "shadow_walk_bvh2"})):
        r, plain = _renderer(dev, tmp_path, **knobs), _renderer("cpu", tmp_path, **knobs)
        assert (r.arrays_list is not None) == ("chunk_tris" in knobs)
        for i in range(2):
            ext.reset_launches()
            frame = r.render_frame(mode=mode)
            ran = {k for k, v in ext.LAUNCHES.items() if v}
            assert ran == kernels, (mode, ran)
            if mode == "pt" and "chunk_tris" not in knobs:
                assert ext.LAUNCHES["sample_wave"] == 1
            ref = plain.render_frame(mode=mode)
            assert np.abs(frame - ref).max() <= 1e-6, (mode, i)
            h, hp = r.profiler.history[-1], plain.profiler.history[-1]
            if mode == "pt":
                assert round(h["mrays_per_s"] * h["total"] * 1e3) == round(
                    hp["mrays_per_s"] * hp["total"] * 1e3)


def test_render_frame_async_makes_no_synchronising_call(setup, tmp_path):
    """With overlays on and after a warm frame, path-traced dispatches (the
    camera upload, the refit, K1, the composite) run under CUDA's sync
    debug mode "error"; the frames resolve to the sync loop's."""
    knobs = dict(show_fps_overlay=True, debug_show_lights=True, debug_show_bvh=True)
    r, s = _renderer(setup["dev"], tmp_path, **knobs), _renderer(setup["dev"], tmp_path, **knobs)
    r.render_frame(), s.render_frame()
    r.profiler.fps_ema = s.profiler.fps_ema = 20.0
    r._overlay_operands()  # the box operands are built (read back) once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = []
        for _ in range(4):
            r.scene.camera.rotate(5.0, 0.0)
            r.sync_camera()
            pending.append(r.render_frame_async(mode="pt"))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for p in pending:
        s.scene.camera.rotate(5.0, 0.0)
        s.sync_camera()
        s.profiler.fps_ema = 20.0
        np.testing.assert_array_equal(p.resolve(), s.render_frame(mode="pt"))


def test_failed_kernel_build_makes_frames_raise(setup, tmp_path, monkeypatch):
    def boom():
        raise RuntimeError("injected nvcc failure")

    monkeypatch.setattr(ext, "lib", boom)
    r = _renderer(setup["dev"], tmp_path)
    assert r.path_tracer_failed and not r.path_tracer_ready
    for mode in ("auto", "pt", "preview"):
        with pytest.raises(RuntimeError, match="failed to build"):
            r.render_frame(mode=mode)


def test_lbvh_on_cuda_matches_cpu(setup):
    """The LBVH built on the card equals the CPU build bit for bit (random
    soups, and the coincident centroids that leave the tree to the index
    tie-break)."""
    from rayzen_tpu_torch.accel.lbvh import lbvh_for_triangles

    rng = np.random.RandomState(5)
    soups = [(rng.uniform(-3, 3, (n, 1, 3)) + rng.uniform(-0.2, 0.2, (n, 3, 3)))
             for n in (2, 3, 1000, 20000)]
    soups.append(np.tile(rng.uniform(-1, 1, (1, 3, 3)), (300, 1, 1)))
    for tris in soups:
        t = torch.from_numpy(tris.astype(np.float32))
        cpu, gpu = lbvh_for_triangles(t), lbvh_for_triangles(t.to(setup["dev"]))
        for k, v in cpu.items():
            assert torch.equal(v, gpu[k].cpu()), (k, t.shape[0])


def test_render_deforming_makes_no_synchronising_call(setup):
    """Deforming frames (vertices displaced on the card, the LBVH, the
    tables, K1) run under CUDA's sync debug mode "error" after a warm frame,
    each launching K1 once, and match the plain frames (the same inputs on
    the CPU) as test_k1_matches_plain holds K1 to its plain version."""
    from rayzen_tpu_torch.deform import render_deforming
    from rayzen_tpu_torch.light import Light, pack_lights
    from rayzen_tpu_torch.material import Material, pack_materials

    dev = setup["dev"]
    g = 12
    xs = torch.linspace(-1.0, 1.0, g + 1)
    gx, gz = torch.meshgrid(xs, xs, indexing="ij")
    p = torch.stack([gx, torch.zeros_like(gx), gz], -1)
    a, b, c, d = p[:-1, :-1], p[1:, :-1], p[1:, 1:], p[:-1, 1:]
    base = torch.cat([torch.stack([a, b, c], 2), torch.stack([a, c, d], 2)]).reshape(-1, 3, 3)
    tri_mat = torch.zeros(base.shape[0], dtype=torch.int32)
    mats = torch.from_numpy(pack_materials(
        [Material(albedo=(0.8, 0.3, 0.2), metallic=0.1, roughness=0.5)]))
    lights = torch.from_numpy(pack_lights([Light.point((2.0, 4.0, 2.0), power=60.0)]))
    cfg = RenderConfig(width=W, height=H, spp=2, max_bounces=3)
    cam = setup["cam"]

    # the inputs go up before the frames (a copy from pageable memory syncs)
    tables = {on: [x.to(on) for x in (tri_mat, mats, lights)]
              for on in (torch.device("cpu"), dev)}

    def frame(verts, t):
        y = 0.3 * torch.sin(2.0 * verts[..., 0] + 3.0 * t) * torch.cos(verts[..., 2] + t)
        moved = torch.stack([verts[..., 0], y, verts[..., 2]], -1)
        return render_deforming(moved, *tables[verts.device], cam, cfg,
                                with_stats=True)

    gbase = base.to(dev)
    frame(gbase, 0.0)
    torch.cuda.synchronize()
    ext.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frames = [frame(gbase, t) for t in (0.0, 0.7, 1.4)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ext.LAUNCHES["sample_wave"] == 3
    for t, (img, rays) in zip((0.0, 0.7, 1.4), frames):
        ref, ref_rays = frame(base, t)
        err = (img.cpu() - ref).abs().amax(-1).numpy()
        assert (err < 1e-4).mean() >= 0.998 and int(rays) == int(ref_rays)
