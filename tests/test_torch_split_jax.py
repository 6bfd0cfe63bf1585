"""The split-bounce wavefront (K4) and the octant-masked bounce walks (K9)
of the port against the JAX package on the small scene at 32x24: the plain
split against the JAX split path, the plain octant K1 against the JAX
megakernel with octant_bounce_walks (interpret mode), and the plain octant
walk against the plain K2."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_rays
from rayzen_tpu import config as jconfig
from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu.integrator import render_radiance_with_stats
from rayzen_tpu_torch import RenderConfig, convert
from rayzen_tpu_torch.ops import megakernel, walk
from rayzen_tpu_torch.ops.camera_rays import pixel_grid
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H, MB = 32, 24, 4


def _jax_leaves(x):
    return {f.name: (getattr(x, f.name) if f.metadata.get("static")
                     else np.asarray(getattr(x, f.name)))
            for f in dataclasses.fields(x)}


@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    """The small scene packed by the JAX package, its refit tables carried
    into the port, and the camera."""
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    scene = jdemo.build_small_scene(W, H)
    jcfg = jconfig.RenderConfig(width=W, height=H, spp=1, max_bounces=MB,
                                kernels="pallas",
                                cache_dir=str(tmp_path_factory.mktemp("blas")))
    arrays = jpack.pack_scene(scene, jcfg)
    tws = convert.world_arrays_from_numpy(
        _jax_leaves(jpack.world_geometry(arrays)), "cpu")
    return jcfg, arrays, tws, scene.camera.device_params()


def _jax_render(jax_world, **knobs):
    jcfg, arrays, _tws, cam = jax_world
    jimg, jrays = render_radiance_with_stats(
        arrays, {k: jnp.asarray(v) for k, v in cam.items()},
        jcfg.replace(**knobs))
    return np.asarray(jimg), int(jrays)


def _port_image(total, rays, spp=1):
    img = torch.clamp(total / float(spp), 0.0, 1.0).reshape(H, W, 3).numpy()
    assert rays.dtype == torch.int64 and rays.dim() == 0
    return img, int(rays)


def _assert_close(port, jax, atol=1e-6):
    (timg, trays), (jimg, jrays) = port, jax
    assert np.abs(timg - jimg).max() <= atol
    assert trays == jrays


def test_plain_split_matches_jax_split_path(jax_world):
    knobs = dict(split_bounce=2, split_rebin="octant")
    _jcfg, _arrays, tws, cam = jax_world
    _, uv = pixel_grid(W, H, "cpu")
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=MB, **knobs)
    port = _port_image(*megakernel.sample_wave_split(
        tws, cfg, uv, torch.ones(uv.shape[0], dtype=torch.bool), cam, 0, 0, MB))
    _assert_close(port, _jax_render(jax_world, **knobs))


def test_plain_octant_k1_matches_jax_megakernel(jax_world):
    _jcfg, _arrays, tws, cam = jax_world
    _, uv = pixel_grid(W, H, "cpu")
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=MB,
                       octant_bounce_walks=True)
    port = _port_image(*megakernel.sample_wave(
        tws, cfg, uv, torch.ones(uv.shape[0], dtype=torch.bool), cam, 0, 0, MB))
    _assert_close(port, _jax_render(jax_world, octant_bounce_walks=True))


def test_plain_octant_walk_matches_plain_k2(jax_world):
    tws = jax_world[2]
    o, d = (torch.from_numpy(x) for x in random_rays(512, seed=5, spread=2.5))
    act = torch.from_numpy(np.random.RandomState(6).uniform(size=512) < 0.9)
    k2 = walk.closest_walk_reference(tws, o, d, act)
    k9 = megakernel.octant_walk_reference(tws, o, d, act)
    assert k2[1].ge(0).any() and (k2[1] != k9[1]).sum() == 0
    for a, b in zip(k9, k2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
