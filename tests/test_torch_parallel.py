"""The port's tiled rendering (parallel.py) on the CPU: a frame cut into 8
tiles on `cpu` equals the single-device frame bit for bit with equal int64
ray counts, at 40x24 and at 37x13 (481 rays: the last tile padded with
inactive rays), on the portable path and on the plain K1; the
single-device frame is within 1e-4 of JAX's render_radiance of the same
config (kernels="xla") with equal rays. The small scene, 1 spp, 3 bounces
(2 at 37x13), as tests/test_parallel.py. Also make_mesh, the Renderer over
a device list against the single-device Renderer, the scene's replicas
(made once per scene arrays, and after new transforms only the transforms
copied again), and the CLI's --multichip through python -m."""

import dataclasses
import os
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu.config import RenderConfig as JaxConfig
from rayzen_tpu.integrator import render_radiance_with_stats as jax_render
from rayzen_tpu_torch import RenderConfig, demo, renderer
from rayzen_tpu_torch.integrator import render_radiance_with_stats
from rayzen_tpu_torch.packing import _SCENE_ARRAY_FIELDS, pack_scene, pack_scene_host
from rayzen_tpu_torch.parallel import (
    jit_sharded_renderer, make_mesh, render_radiance_sharded, replicate,
)
from rayzen_tpu_torch.renderer import Renderer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small():
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    jscene = jdemo.build_small_scene(64, 48)
    jarrays = jpack.pack_scene(jscene, JaxConfig(width=64, height=48))
    jcam = {k: jnp.asarray(v) for k, v in jscene.camera.device_params().items()}
    scene = demo.build_small_scene(64, 48)
    arrays = pack_scene(scene, RenderConfig(width=64, height=48), "cpu")
    return dict(jarrays=jarrays, jcam=jcam, arrays=arrays,
                cam=scene.camera.device_params())


def test_make_mesh():
    assert make_mesh(8, "cpu") == [torch.device("cpu")] * 8
    assert make_mesh(None, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_mesh(-1, "cpu")


@pytest.mark.parametrize("w,h,bounces", [(40, 24, 3), (37, 13, 2)])
def test_sharded_matches_single_and_jax(small, w, h, bounces):
    jcfg = JaxConfig(width=w, height=h, spp=1, max_bounces=bounces, kernels="xla")
    ref, ref_rays = jax_render(small["jarrays"], small["jcam"], jcfg)
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    mesh = make_mesh(8, "cpu")
    for kernels in ("xla", "auto"):  # the portable path; the plain K1
        c = cfg.replace(kernels=kernels)
        single, rays = render_radiance_with_stats(small["arrays"], small["cam"], c)
        tiled, tiled_rays = render_radiance_sharded(
            small["arrays"], small["cam"], c, mesh, with_stats=True)
        assert torch.equal(tiled, single), kernels
        assert tiled_rays.dtype == rays.dtype == torch.int64
        assert int(tiled_rays) == int(rays) == int(ref_rays), kernels
        assert np.abs(single.numpy() - np.asarray(ref)).max() < 1e-4, kernels
    closure = jit_sharded_renderer(small["arrays"], c, mesh)
    assert torch.equal(closure(small["arrays"], small["cam"]), tiled)


def test_renderer_over_a_device_list_matches_single(tmp_path):
    cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=3,
                       cache_dir=str(tmp_path))

    def frames(**kw):
        r = Renderer(demo.build_demo_scene(32, 24), cfg, async_compile=False,
                     device="cpu", **kw)
        out = [r.render_frame() for _ in range(2)]  # frame 0 at its budget
        rays = [int(r._render(r._camera_params(), 0, first=f)[1])
                for f in (True, False)]
        return out, rays, r

    single, single_rays, _ = frames()
    tiled, tiled_rays, r = frames(mesh=make_mesh(8, "cpu"))
    assert r.mesh == [torch.device("cpu")] * 8 and r.arrays_list is None
    for a, b in zip(single, tiled):
        np.testing.assert_array_equal(a, b)
    assert tiled_rays == single_rays and min(single_rays) > 0


def test_replicas_follow_the_scene_arrays(tmp_path, monkeypatch):
    # numpy tables, so that every copy to the CPU is a new tensor
    host = pack_scene_host(demo.build_small_scene(64, 48))
    cpu = torch.device("cpu")
    first = replicate(host, make_mesh(3, "cpu"))
    assert list(first) == [cpu]
    shifted = host.transforms.copy()
    shifted[:, 0, 3] += 0.25
    moved = host.with_transforms(shifted)
    again = replicate(moved, make_mesh(3, "cpu"), (host, first))
    moved_fields = {"transforms", "inv_transforms"}
    for f in _SCENE_ARRAY_FIELDS:
        assert (getattr(again[cpu], f) is getattr(first[cpu], f)) == (
            f not in moved_fields), f
        np.testing.assert_array_equal(getattr(again[cpu], f).numpy(),
                                      np.asarray(getattr(moved, f)))

    calls = []
    real = renderer.replicate
    monkeypatch.setattr(renderer, "replicate",
                        lambda *a: calls.append(a) or real(*a))
    cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=2,
                       cache_dir=str(tmp_path))
    single = Renderer(demo.build_demo_scene(32, 24), cfg, async_compile=False,
                      device="cpu")
    tiled = Renderer(demo.build_demo_scene(32, 24), cfg, async_compile=False,
                     device="cpu", mesh=make_mesh(4, "cpu"))
    for _ in range(2):
        np.testing.assert_array_equal(tiled.render_frame(), single.render_frame())
    assert len(calls) == 1 and calls[0][2] is None
    t = tiled.scene.transforms()
    t[:, 0, 3] += 0.1
    for r in (single, tiled):
        r.update_transforms(t)
    np.testing.assert_array_equal(tiled.render_frame(), single.render_frame())
    assert len(calls) == 2 and calls[1][2][0] is not tiled.arrays


def test_cli_multichip_writes_a_frame(tmp_path):
    out = tmp_path / "frame.png"
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "rayzen_tpu_torch", "--multichip", "--device", "cpu",
         "--width", "32", "--height", "24", "--spp", "1", "--bounces", "2",
         "--cache-dir", str(tmp_path / "cache"), "--out", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    assert struct.unpack(">II", data[16:24]) == (32, 24)
