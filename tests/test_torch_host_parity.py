"""The port's host functions against the JAX package's: PPM files byte for
byte (image_io), the BVH disk format in both directions and the numpy
brute-force oracle (accel/builder), the sin hash ``ref_rand`` bit for bit
against jitted JAX (ops/rng), the TLAS over the instances' world AABBs on
the demo scene (packing.build_scene_tlas), the host Ray, composite_traced
(overlay), and the names each package exports at its top level."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayzen_tpu
import rayzen_tpu_torch
from conftest import random_rays
from rayzen_tpu import demo as jdemo
from rayzen_tpu import image_io as jio
from rayzen_tpu import packing as jpack
from rayzen_tpu.accel import builder as jbuilder
from rayzen_tpu.config import RenderConfig as JConfig
from rayzen_tpu.ops import intersect as jintersect
from rayzen_tpu.ops import rng as jrng
from rayzen_tpu_torch import demo, image_io, overlay, packing
from rayzen_tpu_torch.accel import builder
from rayzen_tpu_torch.config import RenderConfig
from rayzen_tpu_torch.ops import intersect, rng
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def random_soup(n, seed=0):
    rng_ = np.random.RandomState(seed)
    a = rng_.uniform(-1, 1, (n, 1, 3))
    b = a + rng_.uniform(-0.3, 0.3, (n, 2, 3))
    return np.concatenate([a, b], axis=1).astype(np.float32)


def assert_same_bvh(got, want):
    for f in dataclasses.fields(builder.BLAS):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("flip", [True, False])
def test_ppm_files_match_jax_and_round_trip(tmp_path, flip):
    """write_ppm's file is JAX's byte for byte, from float and from uint8
    images; read_ppm reads either package's file back (the rows flipped
    when written flipped), and skips comment lines."""
    img = np.random.RandomState(1).uniform(0, 1, (8, 10, 3)).astype(np.float32)
    for src in (img, image_io.to_uint8(img)):
        mine, theirs = str(tmp_path / "port.ppm"), str(tmp_path / "jax.ppm")
        image_io.write_ppm(mine, src, flip_vertical=flip)
        jio.write_ppm(theirs, src, flip_vertical=flip)
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
        want = image_io.to_uint8(img)
        want = want[::-1] if flip else want
        for path in (mine, theirs):
            back = image_io.read_ppm(path)
            assert back.dtype == np.uint8 and back.shape == (8, 10, 3)
            np.testing.assert_array_equal(back, want)
            np.testing.assert_array_equal(jio.read_ppm(path), back)
    commented = str(tmp_path / "comment.ppm")
    with open(commented, "wb") as f:
        f.write(b"P6\n# a comment\n2 1\n255\n" + bytes(range(6)))
    np.testing.assert_array_equal(image_io.read_ppm(commented).ravel(), np.arange(6))


def test_bvh_files_load_in_either_package(tmp_path):
    """A BLAS saved by either package loads in the other with equal arrays
    and dtypes, with and without the .npz suffix in the path."""
    verts = random_soup(50)
    bvh = builder.build_blas(verts)
    assert_same_bvh(bvh, jbuilder.build_blas(verts))
    builder.save_bvh(str(tmp_path / "port"), bvh)
    jbuilder.save_bvh(str(tmp_path / "jax.npz"), bvh)
    for name in ("port", "port.npz", "jax", "jax.npz"):
        assert_same_bvh(builder.load_bvh(str(tmp_path / name)), bvh)
        assert_same_bvh(jbuilder.load_bvh(str(tmp_path / name)), bvh)
    tlas = builder.build_tlas(verts.min(axis=1), verts.max(axis=1))
    builder.save_bvh(str(tmp_path / "tlas"), tlas)
    assert_same_bvh(jbuilder.load_bvh(str(tmp_path / "tlas")), tlas)


def test_brute_force_closest_hit_matches_jax():
    """The numpy oracle gives JAX's (index, t) on 64 random rays through a
    200-triangle soup, and (-1, inf) for an empty soup."""
    verts = random_soup(200, seed=3) * 2.0
    o, d = random_rays(64, seed=4, spread=2.5)
    hits = 0
    for i in range(64):
        got = builder.brute_force_closest_hit(o[i], d[i], verts)
        assert got == jbuilder.brute_force_closest_hit(o[i], d[i], verts), i
        hits += got[0] >= 0
    assert 5 < hits < 64
    assert builder.brute_force_closest_hit(o[0], d[0], verts[:0]) == (-1, np.inf)


def test_ref_rand_matches_jitted_jax_bit_for_bit():
    """ref_rand over (..., 2) float32 inputs, from small seeds to the large
    arguments the hash sees late in a path, equals jax.jit(ref_rand) on the
    CPU in every bit."""
    jitted = jax.jit(jrng.ref_rand)
    for seed, hi, shape in ((0, 2000.0, (4096, 2)), (1, 1.0, (16, 64, 2)),
                            (2, 3e5, (2048, 2)), (3, 3e7, (2048, 2))):
        uv = np.random.RandomState(seed).uniform(-hi, hi, shape).astype(np.float32)
        want = np.asarray(jitted(jnp.asarray(uv)))
        got = rng.ref_rand(torch.from_numpy(uv))
        assert got.dtype == torch.float32 and got.shape == shape[:-1]
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
        assert (got >= 0).all() and (got < 1).all()


def test_build_scene_tlas_matches_jax():
    """The TLAS over the demo's instance world AABBs (its empty car.obj
    slot included) equals JAX's in every array, at the packed transforms
    and after moving two instances."""
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    jarr = jpack.pack_scene(jdemo.build_demo_scene(64, 48), JConfig(width=64, height=48))
    arr = packing.pack_scene(demo.build_demo_scene(64, 48),
                             RenderConfig(width=64, height=48), "cpu")
    assert_same_bvh(packing.build_scene_tlas(arr), jpack.build_scene_tlas(jarr))
    moved = np.array(arr.transforms.numpy())
    moved[1, :3, 3] += (0.75, -0.5, 2.0)
    moved[3, :3, :3] = moved[3, :3, :3] @ np.diag([1.0, -1.0, 1.0]).astype(np.float32)
    assert_same_bvh(packing.build_scene_tlas(arr.with_transforms(moved)),
                    jpack.build_scene_tlas(dataclasses.replace(
                        jarr, transforms=jnp.asarray(moved))))


def test_ray_composite_traced_and_package_names():
    """Ray.point_at equals JAX's Ray (float32, broadcast over t);
    composite_traced is composite_core, the one overlay function; and every
    class and function the JAX package exports at its top level, the port
    exports too."""
    o, d = [1.0, 2.0, 3.0], [0.0, 0.6, 0.8]
    t = np.asarray([[0.0], [0.5], [7.25]], np.float32)
    ray = intersect.Ray(o, d)
    assert ray.origin.dtype == torch.float32 and ray.direction.shape == (3,)
    got = ray.point_at(torch.from_numpy(t))
    want = np.asarray(jintersect.Ray(o, d).point_at(jnp.asarray(t)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(ray.point_at(2.0)[2]) == np.float32(3.0) + np.float32(0.8) * 2
    assert overlay.composite_traced is overlay.composite_core
    exported = {n for n, v in vars(rayzen_tpu).items()
                if not n.startswith("_") and not inspect.ismodule(v)}
    assert exported - set(vars(rayzen_tpu_torch)) == set()
