"""The per-wave path on the CPU against the JAX package: the portable path
(kernels="xla") and the brute-force tracer against JAX's renders of the
same config, and the port's K1 past the single-tree budget (tiered="off")
against the JAX XLA path that JAX takes there. Demo scene, 32x24, 1 spp, 3
bounces; each package packs its own copy of the scene."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayzen_tpu import config as jconfig
from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu.integrator import render_radiance_with_stats as jrender
from rayzen_tpu_torch import RenderConfig, demo, integrator, pack_scene
from rayzen_tpu_torch import packing as tpack
from rayzen_tpu_torch.image_io import ssim
from rayzen_tpu_torch.ops import megakernel
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H, MB = 32, 24, 3


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """jax(kernels, tracer, **knobs) -> JAX's (image, rays), memoised; the
    port's demo scene, camera and pack."""
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    jscene = jdemo.build_demo_scene(W, H)
    jcfg = jconfig.RenderConfig(width=W, height=H, spp=1, max_bounces=MB,
                                cache_dir=str(tmp_path_factory.mktemp("blas")))
    jarrays = jpack.pack_scene(jscene, jcfg)
    jcam = {k: jnp.asarray(v) for k, v in jscene.camera.device_params().items()}
    memo = {}

    def jax(kernels, tracer="bvh", **knobs):
        key = (kernels, tracer, tuple(sorted(knobs.items())))
        if key not in memo:
            img, rays = jrender(jarrays, jcam,
                                jcfg.replace(kernels=kernels, **knobs), tracer=tracer)
            memo[key] = np.asarray(img), int(rays)
        return memo[key]

    scene = demo.build_demo_scene(W, H)
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    return jax, scene, cfg


def port_render(scene, cfg, tracer="bvh"):
    img, rays = integrator.render_radiance_with_stats(
        pack_scene(scene, cfg, "cpu"), scene.camera.device_params(), cfg,
        tracer=tracer)
    assert rays.dtype == torch.int64 and rays.dim() == 0
    return img.numpy(), int(rays)


def assert_matches(port, jax, max_abs=1e-4, mean_abs=1e-6):
    """Equal ray counts (every path takes the same turns) and colours within
    float32 rounding: the two packages evaluate the same expressions, but
    XLA fuses some products into multiply-adds and its cos/sin differ from
    torch's by ulps, so a colour may move by ~1e-5."""
    (timg, trays), (jimg, jrays) = port, jax
    d = np.abs(timg - jimg)
    assert trays == jrays
    assert d.max() <= max_abs and d.mean() <= mean_abs, (d.max(), d.mean())


def test_xla_path_matches_jax_xla_path(renders):
    jax, scene, cfg = renders
    assert_matches(port_render(scene, cfg.replace(kernels="xla")), jax("xla"))


def test_brute_tracer_matches_jax_brute(renders):
    jax, scene, cfg = renders
    cfg = cfg.replace(kernels="xla")
    assert_matches(port_render(scene, cfg, tracer="brute"), jax("xla", "brute"))


def test_k1_past_budget_matches_jax_xla_path(renders, monkeypatch):
    """tiered="off" past the single-tree budget (forced tiny): JAX's "auto"
    leaves its megakernel for the XLA path (integrator.py:365-384); the port
    packs no treelet view and keeps K1 (its plain version here). The frames
    agree within the golden bars and by ray count. They are not equal to the
    bit: K1 and the XLA path evaluate the same path with other float
    arithmetic (the jitter's scaling, the normal, fused products), which
    moves colours by ~1e-5 and may send an odd path another way."""
    jax, scene, cfg = renders
    monkeypatch.setattr(tpack, "SINGLE_TREE_VMEM_BUDGET", 1024)
    monkeypatch.setattr(jpack, "SINGLE_TREE_VMEM_BUDGET", 1024)
    cfg = cfg.replace(kernels="auto", tiered="off")
    arrays = pack_scene(scene, cfg, "cpu")
    assert tpack.single_tree_table_bytes(
        arrays.bvh2_child_node.shape[0], arrays.bvh2_leaf_node.shape[0],
        cfg.leaf_size) > tpack.SINGLE_TREE_VMEM_BUDGET
    assert arrays.tre_child_node.shape[1] == 1  # no treelet view
    calls = []
    k1 = megakernel.sample_wave
    monkeypatch.setattr(megakernel, "sample_wave",
                        lambda *a, **k: calls.append(1) or k1(*a, **k))
    port = port_render(scene, cfg)
    assert calls == [1]  # one K1 launch for the frame
    (timg, trays), (jimg, jrays) = port, jax("auto")
    assert ssim(timg, jimg) >= 0.995 and np.abs(timg - jimg).mean() < 2e-3
    assert trays == jrays
