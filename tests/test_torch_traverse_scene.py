"""The object-space BLAS walk and the SceneArrays-level walks of the port
(ops/traverse.py: traverse_blas, traverse_scene, brute_force_scene) against
the JAX package's on the same scenes, each packed by its own package from
the same meshes: a 300-triangle soup with 256 random rays (SAH and
midpoint builds), the small demo scene with 512 random rays, an empty mesh
beside a cube, and inactive rays. Same triangle (and instance, and found)
on every ray, t within 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_rays
from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu import procedural as jproc
from rayzen_tpu.config import RenderConfig as JConfig
from rayzen_tpu.mesh import Mesh as JMesh
from rayzen_tpu.ops import traverse as jtrav
from rayzen_tpu.scene import GameObject as JObject, Scene as JScene
from rayzen_tpu_torch import demo, procedural
from rayzen_tpu_torch.accel.builder import brute_force_closest_hit
from rayzen_tpu_torch.config import RenderConfig
from rayzen_tpu_torch.mesh import Mesh
from rayzen_tpu_torch.ops import traverse
from rayzen_tpu_torch.packing import pack_scene
from rayzen_tpu_torch.scene import GameObject, Scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-6


def random_soup(n, seed=0, spread=2.0, size=0.5):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-spread, spread, size=(n, 1, 3))
    b = a + rng.uniform(-size, size, size=(n, 2, 3))
    return np.concatenate([a, b], axis=1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_t_close(got, want, mask):
    got, want = np.asarray(got)[mask], np.asarray(want)[mask]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def assert_same_hits(port, jax_hit):
    found = np.asarray(jax_hit.found)
    np.testing.assert_array_equal(port.found.numpy(), found)
    np.testing.assert_array_equal(port.tri.numpy(), np.asarray(jax_hit.tri))
    np.testing.assert_array_equal(port.inst.numpy(), np.asarray(jax_hit.inst))
    assert_t_close(port.t.numpy(), jax_hit.t, found)


@pytest.fixture(scope="module")
def small():
    """The small demo scene packed by each package, and 512 random rays."""
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    jarr = jpack.pack_scene(jdemo.build_small_scene(64, 48), JConfig(width=64, height=48))
    tarr = pack_scene(demo.build_small_scene(64, 48), RenderConfig(width=64, height=48),
                      "cpu")
    return jarr, tarr


@pytest.mark.parametrize("method", ["sah", "midpoint"])
def test_traverse_blas_matches_jax(method):
    """traverse_blas over the soup's one BLAS: JAX's triangles on all 256
    rays, t within 1e-6 relative, and the float64 brute force's triangle
    wherever it finds one."""
    verts = random_soup(300, seed=11)
    jpack._blas_cache.clear()
    jscene = JScene()
    jscene.game_objects.append(JObject(JMesh.from_triangles(verts)))
    jarr = jpack.pack_scene(jscene, JConfig(split_method=method))
    scene = Scene()
    scene.game_objects.append(GameObject(Mesh.from_triangles(verts)))
    cfg = RenderConfig(split_method=method)
    arr = pack_scene(scene, cfg, "cpu")
    meta = arr.instance_meta[0]
    assert meta.node_offset == jarr.instance_meta[0].node_offset
    assert meta.tri_offset == jarr.instance_meta[0].tri_offset

    o, d = random_rays(256, seed=12, spread=3.0)
    jt, jtri = jtrav.traverse_blas(jarr, jnp.asarray(o), jnp.asarray(d),
                                   jnp.ones(256, bool), meta.node_offset,
                                   meta.tri_offset, leaf_size=cfg.leaf_size)
    t, tri = traverse.traverse_blas(arr, _t(o), _t(d), torch.ones(256, dtype=torch.bool),
                                    meta.node_offset, meta.tri_offset,
                                    leaf_size=cfg.leaf_size)
    assert tri.dtype == torch.int32 and t.dtype == torch.float32
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
    hit = tri.numpy() >= 0
    assert 20 < hit.sum() < 256
    assert_t_close(t.numpy(), jt, hit)
    assert (t.numpy()[~hit] == np.float32(1e30)).all()

    packed = np.stack([arr.tri_v0.numpy(), (arr.tri_v0 + arr.tri_e1).numpy(),
                       (arr.tri_v0 + arr.tri_e2).numpy()], axis=1)[:300]
    for i in range(256):
        ref_idx, ref_t = brute_force_closest_hit(o[i], d[i], packed)
        assert (tri[i] >= 0) == (ref_idx >= 0), i
        if ref_idx >= 0:
            assert np.isclose(float(t[i]), ref_t, rtol=1e-4), i


def test_traverse_and_brute_force_scene_match_jax(small):
    """traverse_scene and brute_force_scene on 512 random rays (90% active):
    found, instance and triangle equal to JAX's, t within 1e-6 relative;
    and the walk equal to the brute force on found, instance and
    triangle."""
    jarr, tarr = small
    o, d = random_rays(512, seed=21, spread=4.0)
    act = np.random.RandomState(22).uniform(size=512) < 0.9
    jo, jd, ja = jnp.asarray(o), jnp.asarray(d), jnp.asarray(act)
    to, td, ta = _t(o), _t(d), _t(act)
    walked = traverse.traverse_scene(tarr, to, td, ta)
    brute = traverse.brute_force_scene(tarr, to, td, ta)
    assert_same_hits(walked, jtrav.traverse_scene(jarr, jo, jd, ja))
    assert_same_hits(brute, jtrav.brute_force_scene(jarr, jo, jd, ja))
    found = walked.found.numpy()
    assert 50 < found.sum() < act.sum()
    np.testing.assert_array_equal(brute.found.numpy(), found)
    np.testing.assert_array_equal(brute.tri.numpy(), walked.tri.numpy())
    np.testing.assert_array_equal(brute.inst.numpy(), walked.inst.numpy())
    np.testing.assert_allclose(brute.point.numpy()[found], walked.point.numpy()[found],
                               rtol=1e-5, atol=1e-5)


def test_empty_mesh_instance_is_inert():
    """An empty mesh beside a cube (the demo's missing car.obj slot): the
    ray down the z axis hits the cube's instance at t = 4, as in JAX, and
    the empty instance's count-0 root leaf falls through to its miss link
    in traverse_blas."""
    jpack._blas_cache.clear()
    jscene = JScene()
    jscene.game_objects.append(JObject(JMesh()))
    jscene.game_objects.append(JObject(jproc.cube(0)))
    jarr = jpack.pack_scene(jscene, JConfig())
    scene = Scene()
    scene.game_objects.append(GameObject(Mesh()))
    scene.game_objects.append(GameObject(procedural.cube(0)))
    arr = pack_scene(scene, RenderConfig(), "cpu")
    o = np.asarray([[0.0, 0.0, 5.0], [0.5, 0.25, 5.0]], np.float32)
    d = np.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], np.float32)
    h = traverse.traverse_scene(arr, _t(o), _t(d), torch.ones(2, dtype=torch.bool))
    assert h.found.all()
    assert h.inst.tolist() == [1, 1]
    assert np.isclose(float(h.t[0]), 4.0, atol=1e-5)
    assert_same_hits(h, jtrav.traverse_scene(jarr, jnp.asarray(o), jnp.asarray(d),
                                             jnp.ones(2, bool)))
    empty = arr.instance_meta[0]
    assert empty.num_triangles == 0
    t, tri = traverse.traverse_blas(arr, _t(o), _t(d), torch.ones(2, dtype=torch.bool),
                                    empty.node_offset, empty.tri_offset)
    assert tri.tolist() == [-1, -1] and (t == 1e30).all()


def test_inactive_rays_report_no_hit(small):
    """No active ray: traverse_scene, brute_force_scene and traverse_blas
    report no hit (t = T_FAR, tri = -1), as JAX's traverse_scene does."""
    jarr, tarr = small
    o, d = random_rays(64, seed=5)
    none = torch.zeros(64, dtype=torch.bool)
    jh = jtrav.traverse_scene(jarr, jnp.asarray(o), jnp.asarray(d), jnp.zeros(64, bool))
    assert not np.asarray(jh.found).any()
    for fn in (traverse.traverse_scene, traverse.brute_force_scene):
        h = fn(tarr, _t(o), _t(d), none)
        assert not h.found.any()
        assert (h.tri == -1).all() and (h.inst == -1).all() and (h.t == 1e30).all()
    meta = tarr.instance_meta[0]
    t, tri = traverse.traverse_blas(tarr, _t(o), _t(d), none, meta.node_offset,
                                    meta.tri_offset)
    assert (tri == -1).all() and (t == 1e30).all()
