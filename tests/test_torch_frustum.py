"""The packet-frustum walks (K6) of the port against the JAX package: the
plain K6 walks, with packets of 32 consecutive ray ids and with the
kernel's warp tiles of the frame, against pallas_closest_hit_frustum /
pallas_shadow_walk_frustum (interpret mode) and against the port's plain
K2/K3, the plain K1 with frustum_primary against the JAX megakernel with
it, and the rules that select the frustum walk.

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
from rayzen_tpu.ops.camera_rays import generate_rays
from rayzen_tpu.ops.camera_rays import pixel_grid as jpixel_grid
from rayzen_tpu.ops.pallas_traverse import (
    pallas_closest_hit_frustum,
    pallas_shadow_walk_frustum,
)
from rayzen_tpu_torch import RenderConfig, convert, pack_scene
from rayzen_tpu_torch import demo as tdemo
from rayzen_tpu_torch.integrator import check_config, render_rays
from rayzen_tpu_torch.ops import megakernel, walk
from rayzen_tpu_torch.ops.camera_rays import pixel_grid
from rayzen_tpu_torch.packing import world_geometry
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H, MB = 32, 24, 4


def _jax_leaves(x):
    return {f.name: (getattr(x, f.name) if f.metadata.get("static")
                     else np.asarray(getattr(x, f.name)))
            for f in dataclasses.fields(x)}


@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    """The small scene packed by the JAX package, its refit tables (JAX's
    and carried into the port), the camera, the 48x32 primary rays, and
    the JAX frustum_primary render at 32x24."""
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    scene = jdemo.build_small_scene(W, H)
    jcfg = jconfig.RenderConfig(width=W, height=H, spp=1, max_bounces=MB,
                                kernels="pallas",
                                cache_dir=str(tmp_path_factory.mktemp("blas")))
    arrays = jpack.pack_scene(scene, jcfg)
    jws = jpack.world_geometry(arrays)
    tws = convert.world_arrays_from_numpy(_jax_leaves(jws), "cpu")
    cam = {k: jnp.asarray(v) for k, v in scene.camera.device_params().items()}
    _, uv = jpixel_grid(48, 32)
    o, d = generate_rays(uv, jnp.zeros_like(uv), cam["inv_proj"],
                         cam["inv_view"], cam["position"])
    jimg, jrays = render_radiance_with_stats(
        arrays, cam, jcfg.replace(frustum_primary=True))
    return dict(jws=jws, tws=tws, cam=scene.camera.device_params(),
                o=np.asarray(o), d=np.asarray(d), jimg=np.asarray(jimg),
                jrays=int(jrays))


def _t(x):
    return torch.from_numpy(np.array(x))


# the packets of the port's K6: 32 consecutive ray ids, and the kernel's 8 x
# 4 warp tiles of the 48 x 32 frame the rays cover
FRAMES = ((0, 0), (48, 32))


def test_plain_frustum_closest_matches_jax_frustum(jax_world):
    jw = jax_world
    act = np.random.RandomState(3).uniform(size=jw["o"].shape[0]) < 0.9
    jh = pallas_closest_hit_frustum(jw["jws"], jnp.asarray(jw["o"]),
                                    jnp.asarray(jw["d"]), jnp.asarray(act),
                                    interpret=True)
    for frame in FRAMES:
        th = walk.closest_hit_frustum(jw["tws"], _t(jw["o"]), _t(jw["d"]),
                                      _t(act), *frame)
        _assert_jax_closest(jh, th)


def _assert_jax_closest(jh, th):
    jt, tt = np.asarray(jh.t), th.t.numpy()
    jtri, ttri = np.asarray(jh.tri), th.tri.numpy()
    np.testing.assert_array_equal(th.found.numpy(), np.asarray(jh.found))
    assert th.found.any() and not th.found.all()
    f = th.found.numpy()
    # t to the bar of the K2 walk against JAX (XLA fuses multiply-adds)
    np.testing.assert_allclose(tt[f], jt[f], rtol=4.6e-7)
    diff = jtri != ttri  # another triangle only on an exact t tie
    assert np.all(np.abs(jt[diff] - tt[diff]) <= 4.6e-7 * np.abs(jt[diff]))
    assert diff.sum() == 0  # none on this scene


def test_plain_frustum_shadow_matches_jax_frustum(jax_world):
    jw = jax_world
    o, d = _t(jw["o"]), _t(jw["d"])
    act = torch.ones(o.shape[0], dtype=torch.bool)
    hit = walk.closest_hit_bvh2(jw["tws"], o, d, act)
    ldir = torch.tensor([0.3, 0.9, 0.1])
    ldir = (ldir / ldir.norm()).expand_as(o).contiguous()
    so = hit.point + ldir * 1e-3
    jv, jr = pallas_shadow_walk_frustum(
        jw["jws"], jnp.asarray(so.numpy()), jnp.asarray(ldir.numpy()), 50.0,
        jnp.asarray(hit.found.numpy()), interpret=True)
    jv = np.asarray(jv)
    lit = jv > 0.05
    # the plain K3 stops each ray at min_visibility
    v3 = walk.shadow_walk_reference(jw["tws"], so, ldir, 50.0, hit.found).numpy()
    np.testing.assert_array_equal(v3 > 0.05, lit)
    for frame in FRAMES:
        tv, tr = walk.shadow_walk_frustum(jw["tws"], so, ldir, 50.0, hit.found,
                                          0.05, 1e-3, *frame)
        tv = tv.numpy()
        np.testing.assert_array_equal(tv > 0.05, lit)
        assert lit.any() and not lit.all() and int(tr) == int(jr)
        np.testing.assert_allclose(tv[lit], jv[lit], rtol=0, atol=1e-6)
        np.testing.assert_allclose(tv[lit], v3[lit], rtol=0, atol=1e-6)


def test_plain_frustum_k1_matches_jax_frustum_render(jax_world):
    jw = jax_world
    _, uv = pixel_grid(W, H, "cpu")
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=MB,
                       frustum_primary=True)
    total, rays = megakernel.sample_wave(
        jw["tws"], cfg, uv, torch.ones(uv.shape[0], dtype=torch.bool),
        jw["cam"], 0, 0, MB)
    img = torch.clamp(total, 0.0, 1.0).reshape(H, W, 3).numpy()
    assert rays.dtype == torch.int64 and int(rays) == jw["jrays"]
    assert ssim(img, jw["jimg"]) >= 0.995
    assert np.abs(img - jw["jimg"]).mean() < 2e-3


@pytest.mark.parametrize("rays", ["primary", "random"])
def test_plain_frustum_packets_match_plain_k2(jax_world, rays):
    """Packets of 1, 32 and 4096 rays."""
    tws = jax_world["tws"]
    if rays == "primary":
        o, d = _t(jax_world["o"]), _t(jax_world["d"])
    else:
        o, d = (_t(x) for x in random_rays(512, seed=11, spread=2.5))
    act = torch.from_numpy(np.random.RandomState(12).uniform(size=o.shape[0]) < 0.9)
    k2 = walk.closest_walk_reference(tws, o, d, act)
    for packet in (1, 32, 4096):
        _check_packets(tws, o, d, act, k2, packet)


def _check_packets(tws, o, d, act, k2, packet):
    work = walk.Work()
    k6 = walk.frustum_closest_walk_reference(tws, o, d, act, packet=packet,
                                             work=work)
    hit = k2[1] >= 0
    assert hit.any() and (k6[1] >= 0)[hit].all()
    assert torch.equal(k6[0][hit], k2[0][hit])  # t bit for bit
    assert torch.equal(k6[1][hit], k2[1][hit])  # no ties on this scene
    # a K6 ray tests the leaves the frustum reaches without a box test of
    # its own, so it may hit a triangle in a leaf whose box K2's slab test
    # misses by rounding (1 primary ray of 1,536 here at packet 32 and 4096)
    extra = (k6[1] >= 0) & ~hit
    assert extra.sum() <= 0.001 * o.shape[0]
    assert work.counts()["packet_nodes"] > 0


def test_frustum_depth_check_raises(jax_world):
    tws = jax_world["tws"]
    deep = dataclasses.replace(tws, tree_depth=walk.STACK_DEPTH)
    o, d = _t(jax_world["o"][:8]), _t(jax_world["d"][:8])
    act = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="stack entries"):
        walk.frustum_closest_walk_reference(deep, o, d, act)
    with pytest.raises(ValueError, match="stack entries"):
        walk.frustum_shadow_walk_reference(deep, o, d, 5.0, act)


SW, SH = 24, 20


@pytest.fixture(scope="module")
def small():
    scene = tdemo.build_small_scene(SW, SH)
    cfg = RenderConfig(width=SW, height=SH, spp=1, max_bounces=4)
    frag, uv = pixel_grid(SW, SH, "cpu")
    return scene, cfg, frag, uv, scene.camera.device_params()


def _count_frustum(monkeypatch):
    calls = []
    plain = walk.frustum_closest_walk_reference
    monkeypatch.setattr(walk, "frustum_closest_walk_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    return calls


def test_frustum_selection_rules(small, monkeypatch):
    """frustum_primary is ignored with wide nodes and on a tiered scene;
    with split_bounce it runs in phase 1."""
    for knobs in (dict(wide_nodes=True), dict(tiered="on", treelet_rows=8)):
        _frustum_is_ignored(small, knobs, monkeypatch)
        monkeypatch.undo()
    _split_with_frustum(small, monkeypatch)


def _frustum_is_ignored(small, knobs, monkeypatch):
    scene, cfg, _frag, uv, cam = small
    cfg = cfg.replace(**knobs)
    ws = world_geometry(pack_scene(scene, cfg, "cpu"))
    act = torch.ones(uv.shape[0], dtype=torch.bool)
    base = megakernel.sample_wave(ws, cfg, uv, act, cam, 0, 0, 4)
    calls = _count_frustum(monkeypatch)
    fr = megakernel.sample_wave(ws, cfg.replace(frustum_primary=True), uv, act,
                                cam, 0, 0, 4)
    assert not calls
    assert not megakernel._consts(cfg.replace(frustum_primary=True), 0, 0, 4, 1,
                                  ws.tiered).frustum
    torch.testing.assert_close(fr[0], base[0], rtol=0, atol=0)
    assert int(fr[1]) == int(base[1])


def _split_with_frustum(small, monkeypatch):
    scene, cfg, frag, uv, cam = small
    cfg = cfg.replace(split_bounce=2, frustum_primary=True)
    check_config(cfg)
    arrays = pack_scene(scene, cfg, "cpu")
    base, brays = render_rays(arrays, frag, uv, cam,
                              cfg.replace(split_bounce=0), with_stats=True)
    calls, splits = _count_frustum(monkeypatch), []
    split = megakernel.sample_wave_split
    monkeypatch.setattr(megakernel, "sample_wave_split",
                        lambda *a: splits.append(1) or split(*a))
    img, rays = render_rays(arrays, frag, uv, cam, cfg, with_stats=True)
    assert len(splits) == 1 and len(calls) == 1  # phase 1's primary walk
    assert (img - base).abs().max().item() <= 1e-6 and int(rays) == int(brays)
