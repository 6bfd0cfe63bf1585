"""The wide-node walks (K5) of the port against the JAX package: the BVH8
collapse and the wide tables bit for bit, the plain K5 walks against the
port's plain K2/K3 walks (the same t, the same triangle but on exact ties),
the plain wide K1 against the JAX megakernel with wide_nodes (interpret
mode), the wide stack bound, and the rules that select the wide walks.

Seven tests: pytest-xdist queues test files by their number of tests, so a
file with more than tests/test_parallel.py's seven would start before that
long file and could delay it."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_rays
from rayzen_tpu import config as jconfig
from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu.image_io import ssim
from rayzen_tpu.integrator import render_radiance_with_stats
from rayzen_tpu_torch import RenderConfig, convert, pack_scene
from rayzen_tpu_torch import config as tconfig
from rayzen_tpu_torch import demo as tdemo
from rayzen_tpu_torch import packing as tpack
from rayzen_tpu_torch.integrator import check_config, render_rays
from rayzen_tpu_torch.ops import megakernel, walk
from rayzen_tpu_torch.ops.camera_rays import pixel_grid
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H, MB = 32, 24, 4
BVH8_FIELDS = ("bvh8_child_node", "bvh8_child_ref", "bvh8_child_count",
               "bvh8_leaf_start", "bvh8_leaf_n", "bvh8_leaf_perm")


def _jax_leaves(x):
    return {f.name: (getattr(x, f.name) if f.metadata.get("static")
                     else np.asarray(getattr(x, f.name)))
            for f in dataclasses.fields(x)}


def test_bvh8_pack_and_tables_match_jax(tmp_path):
    for kind in ("small", "demo"):
        _check_bvh8_pack(kind, tmp_path)


def _check_bvh8_pack(kind, tmp_path):
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    build = {"small": (jdemo.build_small_scene, tdemo.build_small_scene),
             "demo": (jdemo.build_demo_scene, tdemo.build_demo_scene)}[kind]
    js, ts = (b(64, 48) for b in build)
    ja = jpack.pack_scene(js, jconfig.RenderConfig(width=64, height=48,
                                                   cache_dir=str(tmp_path)))
    ta = tpack.pack_scene(ts, tconfig.RenderConfig(width=64, height=48), "cpu")
    for name in BVH8_FIELDS:
        jv, tv = np.asarray(getattr(ja, name)), getattr(ta, name).numpy()
        assert tv.dtype == jv.dtype and tv.shape == jv.shape, name
        np.testing.assert_array_equal(tv, jv, err_msg=name)
    jw, tw = jpack.world_geometry(ja), tpack.world_geometry(ta)
    ji, ti = np.asarray(jw.inner8_table), tw.inner8_table.numpy()
    assert ti.shape == ji.shape == (ja.bvh8_child_node.shape[0], 72)
    np.testing.assert_array_equal(ti[:, :66], ji[:, :66])
    assert (ti[:, 66:] == 0).all()
    np.testing.assert_array_equal(tw.leaf8_table.numpy(), np.asarray(jw.leaf8_table))
    # the wide tree's levels and exact stack need (7 per level at most)
    assert 1 <= tw.wide_depth < tw.tree_depth
    assert tw.wide_depth < tw.wide_stack <= 7 * tw.wide_depth + 1
    if kind == "demo":  # 303 wide nodes over 842 BVH2 inner rows
        assert ti.shape[0] == 303 and (tw.wide_depth, tw.wide_stack) == (4, 22)


def test_wide_stack_bound_is_exact():
    # root: 3 internal children; child 1 has 8 internal children (leaf-only
    # nodes 4..11); children 2, 3 have none. The walk pops child 1 first in
    # the worst case and holds 2 siblings + 8 grandchildren.
    n = 12
    ref = np.zeros((n, 8), np.int32)
    cnt = np.zeros((n, 8), np.int32)  # padding
    ref[0, :3], cnt[0, :3] = [1, 2, 3], -1
    ref[1, :], cnt[1, :] = np.arange(4, 12), -1
    cnt[2:, 0] = 3  # one leaf child each
    assert tpack.wide_stack_bound(ref, cnt) == (3, 10)
    # a ladder: every node's 8 internal children include the next rung
    k = 12
    ref = np.repeat(np.minimum(np.arange(k) + 1, k - 1)[:, None], 8, 1).astype(np.int32)
    cnt = np.full((k, 8), -1, np.int32)
    cnt[k - 1] = 2
    assert tpack.wide_stack_bound(ref, cnt) == (k, 7 * (k - 1) + 1)


@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    """The small scene packed by the JAX package, its refit tables carried
    into the port, the camera, and the JAX wide render at 32x24."""
    jpack._blas_cache.clear()
    scene = jdemo.build_small_scene(W, H)
    jcfg = jconfig.RenderConfig(width=W, height=H, spp=1, max_bounces=MB,
                                kernels="pallas",
                                cache_dir=str(tmp_path_factory.mktemp("blas")))
    arrays = jpack.pack_scene(scene, jcfg)
    tws = convert.world_arrays_from_numpy(
        _jax_leaves(jpack.world_geometry(arrays)), "cpu")
    cam = scene.camera.device_params()
    jimg, jrays = render_radiance_with_stats(
        arrays, {k: jnp.asarray(v) for k, v in cam.items()},
        jcfg.replace(wide_nodes=True))
    return tws, cam, np.asarray(jimg), int(jrays)


def _primary(tws, cam, w=48, h=32):
    _, uv = pixel_grid(w, h, "cpu")
    z = torch.zeros_like(uv[:, 0])
    r = megakernel._raygen_tiles(uv[:, 0], uv[:, 1], z, z,
                                 megakernel._pack_camera(cam, "cpu"))
    return torch.stack(r[:3], 1), torch.stack(r[3:], 1)


def _random(n=512, seed=7):
    o, d = random_rays(n, seed=seed, spread=2.5)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("rays", ["primary", "random"])
def test_plain_wide_walks_match_plain_k2_k3(jax_world, rays):
    tws, cam = jax_world[:2]
    o, d = _primary(tws, cam) if rays == "primary" else _random()
    _check_closest(tws, o, d)
    o, d = _primary(tws, cam) if rays == "primary" else _random(seed=9)
    _check_shadow(tws, o, d)


def _check_closest(tws, o, d):
    act = torch.from_numpy(np.random.RandomState(8).uniform(size=o.shape[0]) < 0.9)
    k2 = walk.closest_walk_reference(tws, o, d, act)
    work = walk.Work()
    k5 = walk.wide_closest_walk_reference(tws, o, d, act, work=work)
    hit = k2[1] >= 0
    assert hit.any() and not hit.all()
    assert torch.equal(k5[0][hit], k2[0][hit])  # t bit for bit
    assert torch.equal(k5[1] >= 0, hit)  # no hit K2 lacks
    ties = (k5[1] != k2[1]) & hit
    assert torch.equal(k5[0][ties], k2[0][ties])  # other triangles: ties only
    assert ties.sum() == 0  # none on this scene
    same = ~ties
    for a, b in zip(k5[2:], k2[2:]):
        torch.testing.assert_close(a[same], b[same], rtol=0, atol=0)
    assert work.counts()["nodes8"] > 0 and work.counts()["nodes"] == 0


def _check_shadow(tws, o, d):
    act = torch.ones(o.shape[0], dtype=torch.bool)
    hit = walk.closest_hit_bvh2(tws, o, d, act)
    ldir = torch.tensor([0.3, 0.9, 0.1])
    ldir = (ldir / ldir.norm()).expand_as(o).contiguous()
    so = hit.point + ldir * 1e-3
    v3 = walk.shadow_walk_reference(tws, so, ldir, 50.0, hit.found)
    v5, r5 = walk.shadow_walk_bvh8(tws, so, ldir, 50.0, hit.found)  # CPU: plain
    assert (v3 < 1).any() and int(r5) == int(hit.found.sum())
    torch.testing.assert_close(v5, v3, rtol=0, atol=1e-6)


def test_plain_wide_k1_matches_jax_wide_render(jax_world):
    tws, cam, jimg, jrays = jax_world
    _, uv = pixel_grid(W, H, "cpu")
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=MB, wide_nodes=True)
    total, rays = megakernel.sample_wave(
        tws, cfg, uv, torch.ones(uv.shape[0], dtype=torch.bool), cam, 0, 0, MB)
    img = torch.clamp(total, 0.0, 1.0).reshape(H, W, 3).numpy()
    assert rays.dtype == torch.int64 and int(rays) == jrays
    assert ssim(img, jimg) >= 0.995 and np.abs(img - jimg).mean() < 2e-3


def test_wide_depth_checks_raise(jax_world):
    tws, cam = jax_world[:2]
    k = 12  # a ladder tree: 7 * 11 + 1 = 78 stack entries > 64
    ref = np.repeat(np.minimum(np.arange(k) + 1, k - 1)[:, None], 8, 1)
    cnt = np.full((k, 8), -1)
    cnt[k - 1] = 2
    depth, need = tpack.wide_stack_bound(ref, cnt)
    deep = dataclasses.replace(tws, wide_depth=depth, wide_stack=need)
    o, d = _primary(tws, cam, 8, 4)
    act = torch.ones(o.shape[0], dtype=torch.bool)
    with pytest.raises(ValueError, match="stack entries"):
        walk.check_wide(deep)
    with pytest.raises(ValueError, match="stack entries"):
        walk.wide_closest_walk_reference(deep, o, d, act)
    with pytest.raises(ValueError, match="stack entries"):
        walk.wide_shadow_walk_reference(deep, o, d, 5.0, act)
    _, uv = pixel_grid(8, 4, "cpu")
    with pytest.raises(ValueError, match="stack entries"):
        megakernel.sample_wave(deep, RenderConfig(width=8, height=4,
                                                  wide_nodes=True),
                               uv, act, cam, 0, 0, 3)
    walk.check_depth(deep)  # the BVH2 walks are not bound by it


SW, SH = 24, 20


@pytest.fixture(scope="module")
def small():
    scene = tdemo.build_small_scene(SW, SH)
    cfg = RenderConfig(width=SW, height=SH, spp=1, max_bounces=4)
    frag, uv = pixel_grid(SW, SH, "cpu")
    return scene, cfg, frag, uv, scene.camera.device_params()


def test_wide_selection_rules(small, monkeypatch):
    """On a tiered scene wide_nodes runs the tiered K1 and logs; with
    split_bounce it runs the fused wide K1."""
    _wide_on_tiered_scene(small, monkeypatch)
    monkeypatch.undo()
    _split_with_wide(small, monkeypatch)


def _wide_on_tiered_scene(small, monkeypatch):
    scene, cfg, _frag, uv, cam = small
    cfg = cfg.replace(tiered="on", treelet_rows=8)
    ws = tpack.world_geometry(pack_scene(scene, cfg, "cpu"))
    assert ws.tiered
    logged = []
    monkeypatch.setattr(megakernel.log, "info", logged.append)
    act = torch.ones(uv.shape[0], dtype=torch.bool)
    base = megakernel.sample_wave(ws, cfg, uv, act, cam, 0, 0, 4)
    assert not logged

    def refuse(*a, **k):
        raise AssertionError("ran a wide walk on the treelet view")

    monkeypatch.setattr(walk, "wide_closest_walk_reference", refuse)
    monkeypatch.setattr(walk, "wide_shadow_walk_reference", refuse)
    wide = megakernel.sample_wave(ws, cfg.replace(wide_nodes=True), uv, act,
                                  cam, 0, 0, 4)
    assert len(logged) == 1 and "wide_nodes ignored" in logged[0]
    torch.testing.assert_close(wide[0], base[0], rtol=0, atol=0)
    assert int(wide[1]) == int(base[1])
    c = megakernel._consts(cfg.replace(wide_nodes=True), 0, 0, 4, 1, True)
    assert not c.wide and not c.frustum


def _split_with_wide(small, monkeypatch):
    scene, cfg, frag, uv, cam = small
    cfg = cfg.replace(split_bounce=2, wide_nodes=True)
    check_config(cfg)
    arrays = pack_scene(scene, cfg, "cpu")

    def refuse(*a):
        raise AssertionError("took the split")

    monkeypatch.setattr(megakernel, "sample_wave_split", refuse)
    calls = []
    plain = walk.wide_closest_walk_reference
    monkeypatch.setattr(walk, "wide_closest_walk_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    img, rays = render_rays(arrays, frag, uv, cam, cfg, with_stats=True)
    assert calls  # the wide K1's plain version ran
    base, brays = render_rays(arrays, frag, uv, cam,
                              cfg.replace(split_bounce=0, wide_nodes=False),
                              with_stats=True)
    torch.testing.assert_close(img, base, rtol=0, atol=0)
    assert int(rays) == int(brays)
