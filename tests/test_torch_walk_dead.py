"""The plain K2/K3 on a wave with holes in ``active`` against the JAX
launchers (pallas_closest_hit_bvh2 / pallas_shadow_walk_bvh2, interpret
mode): an inactive slot gets what the JAX launcher gives an inactive ray
(t = t_init or T_FAR, no triangle, material -1; vis 1), and the live rays
their walks' results. The kernels' live-ray launch (csrc/walk_kernels.cu)
is held to these plain versions on the card (tests/test_torch_cuda.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
def wave(small_arrays, small_camera):
    _, uv = pixel_grid(40, 24)
    o, d = generate_rays(uv, jnp.zeros_like(uv), small_camera["inv_proj"],
                         small_camera["inv_view"], small_camera["position"])
    jws = world_geometry(small_arrays)
    tws = convert.world_arrays_from_numpy(
        {f.name: (getattr(jws, f.name) if f.metadata.get("static")
                  else np.asarray(getattr(jws, f.name)))
         for f in dataclasses.fields(jws)}, "cpu")
    act = np.random.RandomState(3).uniform(size=o.shape[0]) < 0.6
    return jws, tws, np.array(o), np.array(d), act


def test_closest_dead_slots_match_jax(wave):
    jws, tws, o, d, act = wave
    t_init = np.random.RandomState(4).uniform(2.0, 30.0, size=o.shape[0])
    t_init = np.where(np.arange(o.shape[0]) % 2 == 0, t_init, 1e30).astype(np.float32)
    for ti in (None, t_init):
        jh = pallas_closest_hit_bvh2(
            jws, jnp.asarray(o), jnp.asarray(d), jnp.asarray(act), interpret=True,
            t_init=None if ti is None else jnp.asarray(ti))
        th = walk.closest_hit_bvh2(tws, torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(act),
                                   None if ti is None else torch.from_numpy(ti))
        dead = ~act
        for name in ("t", "tri", "found", "mat", "inst"):
            np.testing.assert_array_equal(getattr(th, name).numpy()[dead],
                                          np.asarray(getattr(jh, name))[dead])
        assert (th.tri[torch.from_numpy(dead)] == -1).all()
        same = th.tri.numpy() == np.asarray(jh.tri)
        assert same[act].mean() >= 0.999 and th.found.numpy()[act].any()
        np.testing.assert_allclose(th.t.numpy()[act & same],
                                   np.asarray(jh.t)[act & same], rtol=1e-6)


def test_shadow_dead_slots_match_jax(wave):
    jws, tws, o, d, act = wave
    th = walk.closest_hit_bvh2(tws, torch.from_numpy(o), torch.from_numpy(d),
                               torch.ones(o.shape[0], dtype=torch.bool))
    p = th.point.numpy()
    ld = np.ascontiguousarray(np.broadcast_to(
        np.float32([0.3, 0.9, 0.2]) / np.linalg.norm([0.3, 0.9, 0.2]), p.shape),
        np.float32)
    so = (p + ld * 1e-3).astype(np.float32)
    md = np.full(p.shape[0], 1e30, np.float32)
    sact = act & th.found.numpy()
    jv, jr = pallas_shadow_walk_bvh2(jws, jnp.asarray(so), jnp.asarray(ld),
                                     jnp.asarray(md), jnp.asarray(sact),
                                     interpret=True)
    tv, tr = walk.shadow_walk_bvh2(tws, torch.from_numpy(so), torch.from_numpy(ld),
                                   torch.from_numpy(md), torch.from_numpy(sact))
    np.testing.assert_array_equal(tv.numpy()[~sact], np.asarray(jv)[~sact])
    assert (tv[torch.from_numpy(~sact)] == 1.0).all()
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    assert int(tr) == int(jr) == int(sact.sum())
    assert (tv < 1.0).any()
