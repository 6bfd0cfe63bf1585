"""Port K1 plain version (sample_wave_reference) vs the JAX full-sample
megakernel (render_radiance(kernels="pallas"), interpret mode on the CPU),
on the small scene with both sides reading the JAX WorldArrays."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayzen_tpu.config import RenderConfig as JConfig
from rayzen_tpu.demo import build_small_scene
from rayzen_tpu.integrator import render_radiance_with_stats
from rayzen_tpu.light import Light
from rayzen_tpu.packing import pack_scene, world_geometry
from rayzen_tpu_torch import convert
from rayzen_tpu_torch.config import RenderConfig as TConfig
from rayzen_tpu_torch.image_io import ssim
from rayzen_tpu_torch.ops import megakernel
from rayzen_tpu_torch.ops.camera_rays import pixel_grid
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _render_both(scene, cfg, tmp_path):
    """(JAX image, JAX rays, port image, port rays) for one config."""
    jcfg = JConfig(**{**dataclasses.asdict(cfg), "kernels": "pallas",
                      "cache_dir": str(tmp_path)})
    arrays = pack_scene(scene, jcfg)
    cam = {k: jnp.asarray(v) for k, v in scene.camera.device_params().items()}
    jimg, jrays = render_radiance_with_stats(arrays, cam, jcfg)

    jws = world_geometry(arrays)
    tws = convert.world_arrays_from_numpy(
        {f.name: (getattr(jws, f.name) if f.metadata.get("static")
                  else np.asarray(getattr(jws, f.name)))
         for f in dataclasses.fields(jws)},
        "cpu",
    )
    _, uv = pixel_grid(cfg.width, cfg.height, "cpu")
    total, rays = megakernel.sample_wave(
        tws, cfg, uv, torch.ones(uv.shape[0], dtype=torch.bool),
        scene.camera.device_params(), 0, 0, cfg.max_bounces, n_samples=cfg.spp,
    )
    assert rays.dtype == torch.int64 and rays.dim() == 0
    timg = torch.clamp(total / float(cfg.spp), 0.0, 1.0)
    timg = timg.reshape(cfg.height, cfg.width, 3).numpy()
    return np.asarray(jimg), int(jrays), timg, int(rays)


def _check_threefry(jimg, jrays, timg, trays):
    """max abs < 1e-4 on >= 99.8% of pixels; equal ray counts."""
    err = np.abs(timg - jimg).max(axis=-1)
    assert (err < 1e-4).mean() >= 0.998, f"max err {err.max()}"
    assert trays == jrays


@pytest.fixture(scope="module")
def scene():
    return build_small_scene(64, 48)


def test_threefry_48x32(scene, tmp_path):
    cfg = TConfig(width=48, height=32, spp=1, max_bounces=5, rng="threefry")
    _check_threefry(*_render_both(scene, cfg, tmp_path))


def test_reference_rng_48x32(scene, tmp_path):
    cfg = TConfig(width=48, height=32, spp=1, max_bounces=5)
    jimg, jrays, timg, trays = _render_both(scene, cfg, tmp_path)
    assert ssim(timg, jimg) >= 0.995
    assert np.abs(timg - jimg).mean() < 2e-3
    assert trays == jrays


@pytest.mark.parametrize("n_lights", [0, 1, 3])
def test_light_count_variants(n_lights, tmp_path):
    base = build_small_scene(32, 24)
    lights = {
        0: [],
        1: [Light.point((4.0, 5.0, 2.0), power=100.0)],
        3: list(base.lights) + [Light.directional((0.2, 1.0, -0.4), power=1.5)],
    }[n_lights]
    base.lights = lights
    cfg = TConfig(width=32, height=24, spp=1, max_bounces=2, rng="threefry")
    _check_threefry(*_render_both(base, cfg, tmp_path))


def test_mirror_heavy_scene_rr(tmp_path):
    """All-mirror materials keep throughput ~0.95^b, so Russian roulette's
    survive-and-boost branch dominates."""
    s = build_small_scene(32, 24)
    for m in s.materials:
        m.reflectivity = 1.0
        m.transparency = 0.0
    cfg = TConfig(width=32, height=24, spp=1, max_bounces=5, rng="threefry")
    _check_threefry(*_render_both(s, cfg, tmp_path))


def test_sinf_libm_is_bitwise_jnp_sin():
    """The sin hash's sine is bit-identical to jnp.sin (XLA's CPU sinf) over
    the range the sampler feeds it, and on the reduction boundaries."""
    rs = np.random.RandomState(7)
    x = np.concatenate([
        rs.uniform(-130.0, 130.0, 100_000),
        10.0 ** rs.uniform(-8, 10.7, 200_000) * rs.choice([-1, 1], 200_000),
        [0.0, -0.0, 0.785398, 0.7853982, 119.99, 120.0, -120.0, 3.4e38],
    ]).astype(np.float32)
    ours = megakernel.sinf_libm(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jnp.sin(jnp.asarray(x))))
