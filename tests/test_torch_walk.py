"""Port K2/K3 plain walks vs the JAX Pallas walks (pallas_closest_hit_bvh2 /
pallas_shadow_walk_bvh2 in interpret mode), both reading the JAX
WorldArrays of the small scene (carried across by convert.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_rays
from rayzen_tpu.ops.camera_rays import generate_rays, pixel_grid
from rayzen_tpu.ops.pallas_traverse import (
    pallas_closest_hit_bvh2,
    pallas_shadow_walk_bvh2,
)
from rayzen_tpu.packing import world_geometry
from rayzen_tpu_torch import convert
from rayzen_tpu_torch.ops import walk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def setup(small_arrays, small_camera):
    _, uv = pixel_grid(48, 32)
    o, d = generate_rays(
        uv, jnp.zeros_like(uv), small_camera["inv_proj"],
        small_camera["inv_view"], small_camera["position"],
    )
    jws = world_geometry(small_arrays)
    leaves = {
        f.name: (getattr(jws, f.name) if f.metadata.get("static")
                 else np.asarray(getattr(jws, f.name)))
        for f in dataclasses.fields(jws)
    }
    tws = convert.world_arrays_from_numpy(leaves, "cpu")
    return jws, tws, np.asarray(o), np.asarray(d)


def _t(x):
    return torch.from_numpy(np.array(x))


def _check_closest(jh, th):
    """Same triangle on >= 99.9% of rays, every mismatch an exact t tie;
    t to rtol 1e-6 where found."""
    jtri, ttri = np.asarray(jh.tri), th.tri.numpy()
    jt, tt = np.asarray(jh.t), th.t.numpy()
    same = jtri == ttri
    assert same.mean() >= 0.999, f"{(~same).sum()} tri mismatches"
    assert np.all(np.abs(jt[~same] - tt[~same]) <= 1e-6 * np.abs(jt[~same]))
    np.testing.assert_array_equal(np.asarray(jh.found), th.found.numpy())
    f = np.asarray(jh.found)
    np.testing.assert_allclose(tt[f], jt[f], rtol=1e-6)
    np.testing.assert_allclose(
        th.normal.numpy()[f & same], np.asarray(jh.normal)[f & same], atol=1e-6
    )
    np.testing.assert_array_equal(th.mat.numpy()[same], np.asarray(jh.mat)[same])
    np.testing.assert_array_equal(th.inst.numpy()[same], np.asarray(jh.inst)[same])


def test_closest_primary_rays(setup):
    jws, tws, o, d = setup
    act = np.ones(o.shape[0], bool)
    jh = pallas_closest_hit_bvh2(jws, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(act), interpret=True)
    th = walk.closest_hit_bvh2(tws, _t(o), _t(d), _t(act))
    assert th.found.any() and not th.found.all()
    _check_closest(jh, th)


def test_closest_random_rays_with_t_init(setup):
    jws, tws, _, _ = setup
    o, d = random_rays(512, seed=3, spread=2.5)
    act = np.random.RandomState(4).uniform(size=512) < 0.9
    t_init = np.random.RandomState(5).uniform(0.5, 6.0, size=512).astype(np.float32)
    for ti in (None, t_init):
        jh = pallas_closest_hit_bvh2(
            jws, jnp.asarray(o), jnp.asarray(d), jnp.asarray(act),
            interpret=True, t_init=None if ti is None else jnp.asarray(ti),
        )
        th = walk.closest_hit_bvh2(
            tws, _t(o), _t(d), _t(act), t_init=None if ti is None else _t(ti)
        )
        _check_closest(jh, th)
        if ti is not None:  # hits at or past t_init are ignored
            f = th.found.numpy()
            assert f.any() and (th.t.numpy()[f] < ti[f]).all()


def _shadow_rays(jws, tws, o, d):
    """Shadow rays toward both scene lights from the primary hit points."""
    th = walk.closest_hit_bvh2(tws, _t(o), _t(d), torch.ones(o.shape[0], dtype=torch.bool))
    p = th.point.numpy()
    out = []
    for light in np.asarray(jws.lights):
        if light[3] == 1.0:  # point light (missed rays' points sit at 1e30)
            lv = (light[:3] - p).astype(np.float64)
            dist = np.maximum(np.linalg.norm(lv, axis=1), 1e-3).astype(np.float32)
            ld = (lv / dist[:, None]).astype(np.float32)
            md = dist
        else:
            ld = np.broadcast_to(light[:3] / np.linalg.norm(light[:3]), p.shape)
            ld = np.ascontiguousarray(ld, np.float32)
            md = np.full(p.shape[0], 1e30, np.float32)
        out.append(((p + ld * 1e-3).astype(np.float32), ld, md, th.found.numpy()))
    return out


def test_shadow_toward_lights(setup):
    jws, tws, o, d = setup
    n_blocked = 0
    for so, sd, md, act in _shadow_rays(jws, tws, o, d):
        jv, jr = pallas_shadow_walk_bvh2(
            jws, jnp.asarray(so), jnp.asarray(sd), jnp.asarray(md),
            jnp.asarray(act), interpret=True,
        )
        tv, tr = walk.shadow_walk_bvh2(tws, _t(so), _t(sd), _t(md), _t(act))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
        assert int(tr) == int(jr) == act.sum()
        assert tr.dtype == torch.int64
        n_blocked += int((tv.numpy() < 1.0).sum())
    assert n_blocked > 0  # the scene casts shadows: the walk did real work


def test_shadow_random_rays_transparent_blockers(setup):
    jws, tws, _, _ = setup
    o, d = random_rays(512, seed=8, spread=2.0)
    act = np.ones(512, bool)
    md = np.random.RandomState(9).uniform(0.5, 8.0, size=512).astype(np.float32)
    jv, _ = pallas_shadow_walk_bvh2(jws, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(md), jnp.asarray(act), interpret=True)
    tv, _ = walk.shadow_walk_bvh2(tws, _t(o), _t(d), _t(md), _t(act))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    # partial transmission through the glass cube shows up as 0 < vis < 1
    assert ((tv > 0.0) & (tv < 1.0)).any()


def test_all_inactive(setup):
    _, tws, o, d = setup
    off = torch.zeros(o.shape[0], dtype=torch.bool)
    th = walk.closest_hit_bvh2(tws, _t(o), _t(d), off)
    assert not th.found.any() and (th.tri == -1).all()
    assert (th.t == walk.T_FAR).all() and (th.menc == 0).all()
    vis, rays = walk.shadow_walk_bvh2(tws, _t(o), _t(d), 50.0, off)
    assert (vis == 1.0).all() and int(rays) == 0


def test_work_counts_the_steps_and_changes_no_hit(setup):
    _, tws, o, d = setup
    act = torch.ones(o.shape[0], dtype=torch.bool)
    plain = walk.closest_walk_reference(tws, _t(o), _t(d), act)
    work = walk.Work()
    counted = walk.closest_walk_reference(tws, _t(o), _t(d), act, work=work)
    for a, b in zip(plain, counted):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    n = work.counts()
    # every ray pops the root; a node runs at most two leaves of K triangles
    assert n["nodes"] >= o.shape[0]
    assert 0 < n["tris"] <= 2 * tws.leaf_k * n["nodes"]
    idle = walk.Work()
    walk.shadow_walk_reference(tws, _t(o), _t(d), 50.0, ~act, work=idle)
    assert idle.counts() == {"nodes": 0, "nodes8": 0, "packet_nodes": 0,
                             "ml_nodes": 0, "ml_chain": 0, "tris": 0}


def test_100_rays_padding(setup):
    # 100 rays: the JAX side pads to a whole packet, the port does not
    jws, tws, o, d = setup
    o, d = o[:100], d[:100]
    act = np.ones(100, bool)
    jh = pallas_closest_hit_bvh2(jws, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(act), interpret=True)
    th = walk.closest_hit_bvh2(tws, _t(o), _t(d), _t(act))
    assert th.t.shape == (100,)
    _check_closest(jh, th)
