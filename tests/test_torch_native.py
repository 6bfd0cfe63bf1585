"""The port's native (C++) runtime (accel/native.py, built by g++ into the
port's own native/build/): its BLAS and TLAS builds and its OBJ parse are
identical to the port's numpy builder and parser and to the JAX package's,
on random soups and assets/meshes/monkey.obj, with the n-gon, slash,
out-of-range-index and missing-file cases of tests/test_native.py; the
packer builds its BLAS with it; RAYZEN_NATIVE=0 switches it off."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from rayzen_tpu.accel import builder as jax_builder
from rayzen_tpu.mesh import parse_obj as jax_parse_obj
from rayzen_tpu_torch import RenderConfig, packing, procedural
from rayzen_tpu_torch.accel import builder, native
from rayzen_tpu_torch.demo import ASSET_DIR
from rayzen_tpu_torch.mesh import Mesh, parse_obj, save_obj
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MONKEY = os.path.join(ASSET_DIR, "monkey.obj")


@pytest.fixture(scope="module", autouse=True)
def runtime():
    if not native.available():
        pytest.fail("the native runtime did not build (g++ is in this image)")


def random_soup(n, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-2, 2, size=(n, 1, 3))
    b = a + rng.uniform(-0.5, 0.5, size=(n, 2, 3))
    return np.concatenate([a, b], axis=1).astype(np.float32)


def assert_same_bvh(got, *refs):
    for ref in refs:
        for f in dataclasses.fields(builder.BLAS):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_library_is_the_ports_own():
    assert native.LIB_PATH == os.path.join(REPO, "rayzen_tpu_torch", "native",
                                           "build", "librayzen_native.so")
    assert os.path.exists(native.LIB_PATH)
    code = ("from rayzen_tpu_torch.accel import native; "
            "print(native.available())")
    env = dict(os.environ, PYTHONPATH=REPO, RAYZEN_NATIVE="0")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "False", res.stderr


@pytest.mark.parametrize("method", ["sah", "midpoint"])
def test_blas_matches_numpy_builders(method):
    monkey = Mesh.load_from_obj(MONKEY).vertices
    for verts in [random_soup(n, seed=n + 1) for n in (0, 1, 4, 5, 64, 500)] + [monkey]:
        got = native.build_blas(verts, leaf_size=4, split_method=method)
        assert_same_bvh(got, builder.build_blas(verts, 4, method),
                        jax_builder.build_blas(verts, 4, method))


def test_tlas_matches_and_the_packer_uses_native(tmp_path):
    rng = np.random.RandomState(3)
    bmin = rng.uniform(-5, 5, (11, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0.1, 2, (11, 3)).astype(np.float32)
    assert_same_bvh(native.build_tlas(bmin, bmax), builder.build_tlas(bmin, bmax),
                    jax_builder.build_tlas(bmin, bmax))

    assert packing.build_blas is native.build_blas
    mesh = procedural.blob(subdivisions=2)
    cfg = RenderConfig(cache_dir=str(tmp_path), rebuild_bvh=True)
    packing._blas_cache.clear()
    assert_same_bvh(packing._mesh_blas(mesh, cfg),
                    builder.build_blas(mesh.vertices, cfg.leaf_size, cfg.split_method))


def test_obj_parse_matches_python_parsers(tmp_path):
    text = open(MONKEY).read()
    verts = native.parse_obj_file(MONKEY)
    np.testing.assert_array_equal(verts, jax_parse_obj(text).vertices)
    np.testing.assert_array_equal(verts, parse_obj(text).vertices)
    np.testing.assert_array_equal(Mesh.load_from_obj(MONKEY, 2).vertices, verts)
    torus = procedural.torus(major_segments=8, minor_segments=6)
    p = str(tmp_path / "t.obj")
    save_obj(torus, p)
    np.testing.assert_array_equal(native.parse_obj_file(p), torus.vertices)


def test_obj_edge_cases(tmp_path):
    q = tmp_path / "q.obj"
    q.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\n"
                 "f 1/1/1 2//1 3/1 4\n")
    assert native.parse_obj_file(str(q)).shape == (2, 3, 3)  # a fanned quad
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                   "f 1 2 9\n"  # out of range
                   "f 0 1 2\n"  # zero (invalid 1-based)
                   "f -1 2 3\n"  # negative
                   "f 1 2 3\n"  # valid
                   "f 1 notanint 3\n")  # malformed token
    for path in (q, bad):
        got = native.parse_obj_file(str(path))
        np.testing.assert_array_equal(got, jax_parse_obj(path.read_text()).vertices)
        np.testing.assert_array_equal(got, parse_obj(path.read_text()).vertices)
    assert native.parse_obj_file(str(bad)).shape == (1, 3, 3)
    missing = str(tmp_path / "nope.obj")
    assert native.parse_obj_file(missing) is None
    assert Mesh.load_from_obj(missing).num_triangles == 0
