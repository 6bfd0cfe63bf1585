"""K7, the stackless miss-link walks: the port's plain versions
(ops/walk.py) against the JAX Pallas kernels (pallas_closest_hit /
pallas_shadow_walk in interpret mode) and against the plain K2/K3 walks;
and the portable walks over the same records (ops/traverse.py) against the
JAX package's jitted ones and the brute-force oracles. All on the demo
scene's JAX tables (carried across by convert.py), at 2,048 primary rays
and 2,048 random rays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_rays
from rayzen_tpu import config as jconfig
from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu.ops.camera_rays import generate_rays, pixel_grid
from rayzen_tpu.ops import traverse as jtrav
from rayzen_tpu.ops.pallas_traverse import pallas_closest_hit, pallas_shadow_walk
from rayzen_tpu_torch import convert
from rayzen_tpu_torch.ops import traverse, walk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 64, 32  # 2,048 primary rays


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX WorldArrays, the port's copy, primary rays, random rays) on the
    demo scene."""
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    scene = jdemo.build_demo_scene(W, H)
    jcfg = jconfig.RenderConfig(width=W, height=H,
                                cache_dir=str(tmp_path_factory.mktemp("blas")))
    jws = jpack.world_geometry(jpack.pack_scene(scene, jcfg))
    tws = convert.world_arrays_from_numpy(
        {f.name: (getattr(jws, f.name) if f.metadata.get("static")
                  else np.asarray(getattr(jws, f.name)))
         for f in dataclasses.fields(jws)}, "cpu")
    cam = scene.camera.device_params()
    _, uv = pixel_grid(W, H)
    o, d = generate_rays(uv, jnp.zeros_like(uv), jnp.asarray(cam["inv_proj"]),
                         jnp.asarray(cam["inv_view"]), jnp.asarray(cam["position"]))
    ro, rd = random_rays(W * H, seed=11, spread=4.0)
    act = np.random.RandomState(12).uniform(size=W * H) < 0.9
    return jws, tws, {"primary": (np.asarray(o), np.asarray(d), np.ones(W * H, bool)),
                      "random": (ro, rd, act)}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kind", ["primary", "random"])
def test_plain_k7_closest_matches_jax_kernel(world, kind):
    """Same triangle on every ray, t within 1e-6 relative, menc equal, the
    decoded normals within 1e-6."""
    jws, tws, rays = world
    o, d, act = rays[kind]
    jh = pallas_closest_hit(jws, jnp.asarray(o), jnp.asarray(d), jnp.asarray(act),
                            interpret=True)
    t, tri, cross, menc = walk.misslink_closest_walk_reference(tws, _t(o), _t(d), _t(act))
    th = walk.decode_hit(tws, _t(o), _t(d), t, tri, cross, menc)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jh.tri))
    f = np.asarray(jh.found)
    assert f.sum() > 100 and not f.all()
    np.testing.assert_allclose(t.numpy()[f], np.asarray(jh.t)[f], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(th.mat.numpy(), np.asarray(jh.mat))
    np.testing.assert_array_equal(th.inst.numpy(), np.asarray(jh.inst))
    jmenc = np.where(np.asarray(jh.mat) >= 0, (np.asarray(jh.mat) + 1.0), 0.0)
    np.testing.assert_array_equal(np.abs(menc.numpy()), jmenc)
    np.testing.assert_allclose(th.normal.numpy()[f], np.asarray(jh.normal)[f],
                               rtol=0, atol=1e-6)


def _shadow_rays(tws, o, d, act):
    """Rays from the primary hits toward each light (toward the point light
    they end at the light: max_dist), and random rays with random max_dist."""
    t, tri, _c, _m = walk.closest_walk_reference(tws, _t(o), _t(d), _t(act))
    hit = tri >= 0
    p = _t(o) + _t(d) * t[:, None]
    out = []
    for li in range(tws.lights.shape[0]):
        g = tws.lights[li]
        if float(g[3]) == 1.0:
            lv = g[:3] - p
            dist = torch.clamp_min(lv.norm(dim=1), 0.001)
            ld, md = lv / dist[:, None], dist
        else:
            ld = (g[:3] / g[:3].norm()).expand_as(p).contiguous()
            md = torch.full_like(p[:, 0], 1e30)
        out.append((p + ld * 1e-3, ld, md, hit))
    return out


@pytest.mark.parametrize("kind", ["primary", "random"])
def test_plain_k7_shadow_matches_jax_kernel(world, kind):
    """vis equal on every ray (inactive rays 1), transparent blockers
    included; toward each light from the primary hits, or along random rays
    with random max_dist."""
    jws, tws, rays = world
    o, d, act = rays[kind]
    cases = _shadow_cases(tws, kind, o, d, act)
    partial = False  # a transparent blocker seen
    for so, sd, md, sa in cases:
        jv, jr = pallas_shadow_walk(jws, *(jnp.asarray(x.numpy()) for x in (so, sd, md, sa)),
                                    interpret=True)
        tv, tr = walk.shadow_walk_misslink(tws, so, sd, md, sa)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert tr.dtype == torch.int64 and int(tr) == int(jr)
        assert (tv < 1).any()
        partial |= bool(((tv > 0) & (tv < 1)).any())
    assert partial


def test_plain_k7_matches_plain_k2_k3(world):
    """The miss-link walk and the BVH2 stack walk find the same triangle and
    t on every ray (both keep the packet walk's order and strict t <
    t_best), and the same shadow vis."""
    _jws, tws, rays = world
    for o, d, act in rays.values():
        o, d, act = _t(o), _t(d), _t(act)
        k7 = walk.misslink_closest_walk_reference(tws, o, d, act)
        k2 = walk.closest_walk_reference(tws, o, d, act)
        assert (k7[1] == k2[1]).all(), f"{int((k7[1] != k2[1]).sum())} tri mismatches"
        torch.testing.assert_close(k7[0], k2[0], rtol=0, atol=0)
        torch.testing.assert_close(k7[3], k2[3], rtol=0, atol=0)
        md = torch.full_like(o[:, 0], 6.0)
        torch.testing.assert_close(
            walk.shadow_walk_misslink(tws, o, d, md, act)[0],
            walk.shadow_walk_bvh2(tws, o, d, md, act)[0], rtol=0, atol=0)


def _shadow_cases(tws, kind, o, d, act):
    if kind == "primary":
        return _shadow_rays(tws, o, d, act)
    md = torch.from_numpy(np.random.RandomState(13).uniform(
        0.5, 8.0, size=o.shape[0]).astype(np.float32))
    return [(_t(o), _t(d), md, _t(act))]


def test_portable_walks_match_jax(world):
    """traverse_world against the jitted JAX traverse_world: same triangle
    on every ray, t within 1e-6 relative, the normals (face_normal of the
    world triangle) within 1e-6, material and instance equal; shadow_walk's
    vis within 1e-6 of JAX's (XLA may fuse the Moller-Trumbore products
    into multiply-adds, which moves t by ulps), ray counts equal."""
    jws, tws, rays = world
    jwalk, jshadow = jax.jit(jtrav.traverse_world), jax.jit(jtrav.shadow_walk)
    for kind, (o, d, act) in rays.items():
        jh = jwalk(jws, jnp.asarray(o), jnp.asarray(d), jnp.asarray(act))
        th = traverse.traverse_world(tws, _t(o), _t(d), _t(act))
        np.testing.assert_array_equal(th.tri.numpy(), np.asarray(jh.tri), err_msg=kind)
        f = np.asarray(jh.found)
        np.testing.assert_array_equal(th.found.numpy(), f)
        np.testing.assert_allclose(th.t.numpy()[f], np.asarray(jh.t)[f], rtol=1e-6)
        np.testing.assert_allclose(th.normal.numpy()[f], np.asarray(jh.normal)[f],
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(th.mat.numpy(), np.asarray(jh.mat))
        np.testing.assert_array_equal(th.inst.numpy(), np.asarray(jh.inst))
        for so, sd, md, sa in _shadow_cases(tws, kind, o, d, act):
            jv, jr = jshadow(jws, *(jnp.asarray(x.numpy()) for x in (so, sd, md, sa)))
            tv, tr = traverse.shadow_walk(tws, so, sd, md, sa)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
            assert tr.dtype == torch.int64 and int(tr) == int(jr)


def test_brute_force_oracles_agree(world):
    """brute_force_world finds traverse_world's triangle (as the JAX tests
    assert) and JAX's brute-force triangle; shadow_brute's vis equals
    shadow_walk's within 1e-6 (the product is taken in another order)."""
    jws, tws, rays = world
    for kind, (o, d, act) in rays.items():
        bh = traverse.brute_force_world(tws, _t(o), _t(d), _t(act))
        th = traverse.traverse_world(tws, _t(o), _t(d), _t(act))
        jb = jax.jit(jtrav.brute_force_world)(jws, jnp.asarray(o), jnp.asarray(d),
                                              jnp.asarray(act))
        assert bh.found.sum() > 100
        np.testing.assert_array_equal(bh.tri.numpy(), th.tri.numpy(), err_msg=kind)
        np.testing.assert_array_equal(bh.tri.numpy(), np.asarray(jb.tri), err_msg=kind)
        torch.testing.assert_close(bh.t, th.t, rtol=0, atol=0)
        for so, sd, md, sa in _shadow_cases(tws, kind, o, d, act):
            bv, br = traverse.shadow_brute(tws, so, sd, md, sa)
            wv, wr = traverse.shadow_walk(tws, so, sd, md, sa)
            torch.testing.assert_close(bv, wv, rtol=0, atol=1e-6)
            assert int(br) == int(wr) == int(sa.sum())
