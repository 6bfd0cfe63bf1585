"""The per-wave path's samplers and primary rays against the JAX package:
ReferenceSampler (the sin hash) and HashSampler (lowbias32) draws bit for
bit against jitted JAX for bounces 0-4, and generate_rays to float32
rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayzen_tpu import integrator as jint
from rayzen_tpu.config import RenderConfig as JConfig
from rayzen_tpu.ops import camera_rays as jcam
from rayzen_tpu.ops import rng as jrng
from rayzen_tpu_torch import RenderConfig
from rayzen_tpu_torch import integrator
from rayzen_tpu_torch.demo import build_demo_scene
from rayzen_tpu_torch.ops import camera_rays
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 64, 48


def _draws_jax(cfg, frag, uv, samp, key):
    """Jitter and the draws of bounces 0-4 under jax.jit: bounce 0 a Python
    int (trace_wave's peeled bounce), 1-4 traced (its while_loop's)."""

    @jax.jit
    def run(frag, uv, samp, b):
        s = jint._make_sampler(cfg, frag, uv, W, H, key)
        s.start_sample(samp)
        out = [s.camera_jitter(), *s.bounce_draws(samp, 0)]
        for k in range(1, 5):
            out += s.bounce_draws(samp, b + (k - 1))
        return out

    return [np.asarray(x) for x in run(jnp.asarray(frag), jnp.asarray(uv), samp,
                                       jnp.int32(1))]


def _draws_port(cfg, frag, uv, samp, key):
    s = integrator._make_sampler(cfg, torch.from_numpy(frag), torch.from_numpy(uv),
                                 W, H, key)
    s.start_sample(samp)
    out = [s.camera_jitter()]
    for b in range(5):
        out += s.bounce_draws(samp, b)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("rng,samp,key", [
    ("reference", 0, 0), ("reference", 3, 7), ("threefry", 1, 0),
    ("threefry", 2, 5),
])
def test_sampler_draws_are_bitwise_jax(rng, samp, key):
    """Every draw equal to the bit: the sin hash reproduces XLA's CPU
    arithmetic (libm sinf, two fused multiply-adds) in the per-wave path
    too. The sin-hash index is the progressive key samp + key * spp in
    float32, as render_rays computes it; the hash flow keys the pixel."""
    frag, uv = (np.asarray(x) for x in jcam.pixel_grid(W, H))
    jcfg, tcfg = JConfig(width=W, height=H, spp=64, rng=rng), RenderConfig(
        width=W, height=H, spp=64, rng=rng)
    if rng == "reference":
        jsamp = jnp.float32(samp) + jnp.float32(key) * 64.0
        tsamp = integrator._sample_index(tcfg, samp, key)
        assert tsamp == float(jsamp)
    else:
        jsamp = tsamp = samp
    for j, t in zip(_draws_jax(jcfg, frag, uv, jsamp, key),
                    _draws_port(tcfg, frag, uv, tsamp, key)):
        assert t.dtype == j.dtype == np.float32
        np.testing.assert_array_equal(t, j)


def test_reference_sampler_seed_flow():
    """start_sample/_tempseed of the port's ReferenceSampler equal the JAX
    sampler's (seed = uv * (fragX + fragY + samp + 1))."""
    frag, uv = (np.asarray(x) for x in jcam.pixel_grid(W, H))
    js = jrng.ReferenceSampler(jnp.asarray(uv), jnp.asarray(frag))
    ts = integrator.ReferenceSampler(torch.from_numpy(uv), torch.from_numpy(frag))
    for samp in (0.0, 17.0, 449.0):
        js.start_sample(jnp.float32(samp))
        ts.start_sample(samp)
        np.testing.assert_array_equal(ts.seed.numpy(), np.asarray(js.seed))
        for b in range(5):
            np.testing.assert_array_equal(ts._tempseed(b).numpy(),
                                          np.asarray(jax.jit(js._tempseed)(b)))


def test_generate_rays_matches_jax():
    """Primary rays of the demo camera with a jitter: origins exact,
    directions within float32 rounding of the two 4x4 products."""
    cam = build_demo_scene(W, H).camera.device_params()
    _, uv = jcam.pixel_grid(W, H)
    jitter = np.random.RandomState(3).uniform(-1e-3, 1e-3, (W * H, 2)).astype(np.float32)
    jo, jd = jax.jit(jcam.generate_rays)(
        uv, jnp.asarray(jitter), *(jnp.asarray(cam[k]) for k in ("inv_proj", "inv_view",
                                                                 "position")))
    to, td = camera_rays.generate_rays(
        torch.from_numpy(np.asarray(uv)), torch.from_numpy(jitter), cam["inv_proj"],
        cam["inv_view"], cam["position"])
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2e-7)
