"""The hybrid staged variant "pallas-nomega" (the K6 packet-frustum walk
for the primary hit, K2/K3 for the rest) and K1's sample fusion
(sample_fuse) against the JAX package: demo scene, 32x24, 3 bounces."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_wave import assert_matches, port_render, renders  # noqa: F401
from rayzen_tpu import config as jconfig
from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu.integrator import render_radiance_with_stats as jrender
from rayzen_tpu_torch import RenderConfig, convert
from rayzen_tpu_torch.ops import megakernel, walk
from rayzen_tpu_torch.ops.camera_rays import pixel_grid
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H, MB = 32, 24, 3


def test_nomega_variant_matches_jax(renders, monkeypatch):
    """The primary hit of each sample on the frustum walk (one call per
    sample), the bounces and shadows on K2/K3; the frame is JAX's "pallas-
    nomega" frame (JAX's packets are 4,096 rays, the port's 32: a closest
    hit does not depend on the packet)."""
    jax, scene, cfg = renders
    calls = []
    plain = walk._PLAIN_CLOSEST["frustum"]
    monkeypatch.setitem(walk._PLAIN_CLOSEST, "frustum",
                        lambda *a: calls.append(1) or plain(*a))
    cfg = cfg.replace(kernels="pallas-nomega", rng="threefry")
    assert_matches(port_render(scene, cfg), jax("pallas-nomega", rng="threefry"))
    assert calls == [1]


def test_sample_fuse_matches_jax_fused_megakernel(tmp_path):
    """sample_fuse=2 at 4 spp: the plain K1 sums sub-block s = samples s,
    s + 2 in order, then the sub-blocks, ((c0 + c2) + (c1 + c3)) to the bit,
    as the JAX megakernel (interpret mode) does; its frame matches JAX's
    fused frame at least as closely as the unfused sum does, rays equal.
    Fusion turns the frustum primary walk off (megakernel.py:521-525)."""
    jpack._blas_cache.clear()
    scene = jdemo.build_demo_scene(W, H)
    jcfg = jconfig.RenderConfig(width=W, height=H, spp=4, max_bounces=MB,
                                kernels="pallas", rng="threefry", sample_fuse=2,
                                cache_dir=str(tmp_path))
    arrays = jpack.pack_scene(scene, jcfg)
    cam = scene.camera.device_params()
    jimg, jrays = jrender(arrays, {k: jnp.asarray(v) for k, v in cam.items()}, jcfg)
    jimg = np.asarray(jimg)
    jws = jpack.world_geometry(arrays)
    tws = convert.world_arrays_from_numpy(
        {f.name: (getattr(jws, f.name) if f.metadata.get("static")
                  else np.asarray(getattr(jws, f.name)))
         for f in dataclasses.fields(jws)}, "cpu")
    cfg = RenderConfig(**{**dataclasses.asdict(jcfg)})
    _, uv = pixel_grid(W, H, "cpu")
    act = torch.ones(W * H, dtype=torch.bool)

    def k1(c, samp=0, n=4):
        return megakernel.sample_wave(tws, c, uv, act, cam, samp, 0, MB, n_samples=n)

    fused, frays = k1(cfg)
    one = [k1(cfg, s, 1)[0] for s in range(4)]
    zero = torch.zeros_like(one[0])
    torch.testing.assert_close(
        fused, (zero + ((zero + one[0]) + one[2])) + ((zero + one[1]) + one[3]),
        rtol=0, atol=0)
    unfused, urays = k1(cfg.replace(sample_fuse=1))
    assert int(frays) == int(urays) == jrays

    def img(total):
        return torch.clamp(total / 4.0, 0.0, 1.0).reshape(H, W, 3).numpy()

    d_fused, d_unfused = np.abs(img(fused) - jimg), np.abs(img(unfused) - jimg)
    assert d_fused.max() <= 1e-5
    assert (d_fused == 0).sum() >= (d_unfused == 0).sum()
    assert megakernel.sample_fuse(cfg, 4) == 2 and megakernel.sample_fuse(cfg, 3) == 1
    c = megakernel._consts(cfg.replace(frustum_primary=True), 0, 0, MB, 4)
    assert c.fuse == 2 and not c.frustum
    assert megakernel._consts(cfg.replace(frustum_primary=True), 0, 0, MB, 3).frustum
