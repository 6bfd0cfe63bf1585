"""The port's deforming path (deform.py: the LBVH built on the CPU, the
walks' tables, render_deforming) against the JAX package on a wavy 8 x 8
grid (128 triangles) at 32x24: the tables bit for bit; the portable walk
and the plain K2 on them against the brute-force oracle; the frame of the
plain K1 and of kernels="xla" within 1e-4 of JAX's kernels="xla" frame
with equal ray counts, at rng_key 0 (1 spp) and 3 (2 spp: K1 sums both
samples in one launch, in JAX's order); three animated frames that differ;
and the stack guard (a shrunk STACK_DEPTH poisons the whole frame)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayzen_tpu.config import RenderConfig as JaxConfig
from rayzen_tpu.deform import render_deforming as jax_render_deforming
from rayzen_tpu.deform import world_from_deforming as jax_world_from_deforming
from rayzen_tpu_torch import RenderConfig
from rayzen_tpu_torch.camera import Camera
from rayzen_tpu_torch.deform import render_deforming, world_from_deforming
from rayzen_tpu_torch.light import Light, pack_lights
from rayzen_tpu_torch.material import Material, pack_materials
from rayzen_tpu_torch.ops import walk
from rayzen_tpu_torch.ops.traverse import brute_force_world, traverse_world
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 32, 24


def wavy_grid(g: int, t: float) -> np.ndarray:
    """(2*g*g, 3, 3) triangle grid over [-1,1]^2 with y = 0.3 sin(2x + 3t)
    cos(z + t) (tests/test_deform.py's)."""
    xs = np.linspace(-1.0, 1.0, g + 1)

    def p(i, j):
        x, z = xs[i], xs[j]
        return [x, 0.3 * np.sin(2.0 * x + 3.0 * t) * np.cos(z + t), z]

    tris = []
    for i in range(g):
        for j in range(g):
            a, b, c, d = p(i, j), p(i + 1, j), p(i + 1, j + 1), p(i, j + 1)
            tris += [[a, b, c], [a, c, d]]
    return np.asarray(tris, dtype=np.float32)


@pytest.fixture(scope="module")
def scene():
    verts = wavy_grid(8, 0.0)
    mats = pack_materials(
        [Material(albedo=(0.8, 0.3, 0.2), metallic=0.1, roughness=0.5)])
    lights = pack_lights([Light.point((2.0, 4.0, 2.0), power=60.0)])
    tri_mat = np.zeros((verts.shape[0],), np.int32)
    cam = Camera(position=np.array([0.0, 1.5, 2.5], np.float32),
                 target=np.array([0.0, -0.5, -0.8], np.float32),
                 aspect_ratio=W / H).device_params()
    return verts, tri_mat, mats, lights, cam


def test_tables_match_jax(scene):
    verts, tri_mat, mats, lights, _ = scene
    ref, ref_depth = jax_world_from_deforming(
        jnp.asarray(verts), jnp.asarray(tri_mat), jnp.asarray(mats),
        jnp.asarray(lights), with_depth=True)
    ws, depth = world_from_deforming(verts, tri_mat, mats, lights,
                                     with_depth=True, device="cpu")
    # every column is a copy, a gather or the same float32 subtraction
    for f in ("records", "inner_table", "leaf_table", "tri_v0", "tri_e1",
              "tri_e2", "tri_mat", "tri_inst", "tri_nsign", "materials", "lights"):
        np.testing.assert_array_equal(getattr(ws, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert ws.leaf_k == ref.leaf_k == 1 and ws.tree_depth == 0
    assert int(depth) == int(ref_depth) and depth.dtype == torch.int32
    assert ws.inner8_table is None and not ws.tiered and ws.ml_nodes is None


def test_walks_on_deform_tables_match_brute(scene):
    verts, tri_mat, mats, lights, _ = scene
    ws = world_from_deforming(verts, tri_mat, mats, lights, device="cpu")
    rng = np.random.default_rng(0)
    o = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    o[:, 1] = 2.0
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    act = torch.ones(256, dtype=torch.bool)
    brute = brute_force_world(ws, o, d, act)
    assert brute.found.any()
    for hit in (traverse_world(ws, o, d, act), walk.closest_hit_bvh2(ws, o, d, act)):
        assert torch.equal(hit.found, brute.found)
        assert torch.equal(hit.tri, brute.tri)
        torch.testing.assert_close(hit.t[hit.found], brute.t[brute.found],
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("rng_key,spp", [(0, 1), (3, 2)])
def test_frames_match_jax(scene, rng_key, spp):
    verts, tri_mat, mats, lights, cam = scene
    jcfg = JaxConfig(width=W, height=H, spp=spp, max_bounces=2, kernels="xla")
    ref, ref_rays = jax_render_deforming(
        jnp.asarray(verts), jnp.asarray(tri_mat), jnp.asarray(mats),
        jnp.asarray(lights), {k: jnp.asarray(v) for k, v in cam.items()}, jcfg,
        rng_key=rng_key, with_stats=True)
    ref = np.asarray(ref)
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    for kernels in ("xla", "pallas"):  # the portable walks; the plain K1
        img, rays = render_deforming(verts, tri_mat, mats, lights, cam,
                                     cfg.replace(kernels=kernels),
                                     rng_key=rng_key, with_stats=True,
                                     device="cpu")
        assert img.shape == (H, W, 3) and rays.dtype == torch.int64
        assert np.abs(img.numpy() - ref).max() < 1e-4, kernels
        assert int(rays) == int(ref_rays), kernels


def test_animated_frames_differ(scene):
    _, tri_mat, mats, lights, cam = scene
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=2)
    frames = [render_deforming(torch.from_numpy(wavy_grid(8, t)), tri_mat, mats,
                               lights, cam, cfg).numpy() for t in (0.0, 0.7, 1.4)]
    for img in frames:
        assert np.isfinite(img).all()
    assert not np.allclose(frames[0], frames[1])
    assert not np.allclose(frames[1], frames[2])


def test_stack_guard_poisons_the_frame(scene, monkeypatch):
    verts, tri_mat, mats, lights, cam = scene
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=2)
    _, depth = world_from_deforming(verts, tri_mat, mats, lights,
                                    with_depth=True, device="cpu")
    assert int(depth) + 1 > 4
    for kernels in ("xla", "pallas"):
        c = cfg.replace(kernels=kernels)
        ok = render_deforming(verts, tri_mat, mats, lights, cam, c, device="cpu")
        assert torch.isfinite(ok).all()
        with monkeypatch.context() as m:
            m.setattr(walk, "STACK_DEPTH", 4)
            bad = render_deforming(verts, tri_mat, mats, lights, cam, c,
                                   device="cpu")
        assert torch.isnan(bad).all(), kernels
