"""The port's frame loop (renderer.Renderer on the CPU) against the JAX
package: frame 0 at first_frame_bounces and the next at full bounces
(against JAX's render_radiance_with_stats of the same config, portable
path on both sides), full bounces from frame 0 under accumulate, the
progressive accumulator against JAX's update formula, update_transforms
and the auto topology refresh, a failed kernel build, and the multi-chip
entry points. Demo scene, 32x24, 1 spp, 3 bounces."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayzen_tpu import config as jconfig
from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu.integrator import render_radiance_with_stats as jrender
from rayzen_tpu_torch import RenderConfig, demo, renderer as renderer_mod
from rayzen_tpu_torch.integrator import render_radiance_with_stats
from rayzen_tpu_torch.renderer import Renderer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H, MB = 32, 24, 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The port's config (a cache directory of its own) and jax(bounces) ->
    JAX's portable-path (image, rays) of the demo frame, memoised."""
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    jscene = jdemo.build_demo_scene(W, H)
    jcfg = jconfig.RenderConfig(width=W, height=H, spp=1, max_bounces=MB,
                                kernels="xla",
                                cache_dir=str(tmp_path_factory.mktemp("cache")))
    jarrays = jpack.pack_scene(jscene, jcfg)
    jcam = {k: jnp.asarray(v) for k, v in jscene.camera.device_params().items()}
    memo = {}

    def ref(bounces):
        if bounces not in memo:
            img, rays = jrender(jarrays, jcam, jcfg, max_bounces=bounces)
            memo[bounces] = np.asarray(img), int(rays)
        return memo[bounces]

    return dict(jax=ref, cfg=RenderConfig(**dataclasses.asdict(jcfg)))


def make(cfg, **kw):
    return Renderer(demo.build_demo_scene(W, H), cfg, async_compile=False,
                    device="cpu", **kw)


def assert_matches(img, rays, ref):
    """Equal ray counts; colours within float32 rounding (XLA fuses some
    products into multiply-adds; see test_torch_wave.assert_matches)."""
    jimg, jrays = ref
    d = np.abs(img - jimg)
    assert rays == jrays
    assert d.max() <= 1e-4 and d.mean() <= 1e-6, (d.max(), d.mean())


def test_first_frame_budget_matches_jax(setup):
    """Frame 0 renders first_frame_bounces (1) bounces, frame 1 all of
    them, each the entry point's frame of that budget and JAX's; frame 2
    repeats frame 1 (key 0 without accumulation)."""
    r = make(setup["cfg"])
    f0, f1, f2 = (r.render_frame() for _ in range(3))
    for frame, bounces in ((f0, 1), (f1, MB)):
        img, rays = render_radiance_with_stats(
            r.arrays, r._camera_params(), setup["cfg"], max_bounces=bounces)
        np.testing.assert_array_equal(frame, img.numpy())
        assert rays.dtype == torch.int64
        assert_matches(frame, int(rays), setup["jax"](bounces))
    np.testing.assert_array_equal(f1, f2)
    assert np.abs(f0 - f1).max() > 1e-3
    assert [h["mrays_per_s"] > 0 for h in r.profiler.history] == [True] * 3


def test_accumulate_renders_frame0_at_full_bounces(setup):
    cfg = setup["cfg"].replace(kernels="auto", accumulate=True)
    r = make(cfg, use_cache=False)
    f0 = r.render_frame()
    full, _ = render_radiance_with_stats(r.arrays, r._camera_params(), cfg,
                                         rng_key=0)
    np.testing.assert_array_equal(f0, full.numpy())


def test_accumulator_matches_jax_formula(setup):
    """After 3 frames the accumulator is JAX's accum * (1 - a) + img * a
    (a = 1 / count in float32) over the frames rendered with rng_key = 0,
    1, 2, within one float32 rounding (XLA may fuse the update into a
    multiply-add), and the running mean of those frames within 1e-6."""
    cfg = setup["cfg"].replace(kernels="auto", accumulate=True, spp=2)
    r = make(cfg, use_cache=False)
    out = [r.render_frame() for _ in range(3)]
    assert r._accum_count == 3
    frames = [render_radiance_with_stats(r.arrays, r._camera_params(), cfg,
                                         rng_key=k)[0].numpy() for k in range(3)]
    accum = jnp.asarray(frames[0])
    for n, img in enumerate(frames[1:], start=2):
        a = jnp.float32(1.0 / n)
        accum = accum * (1.0 - a) + jnp.asarray(img) * a
    np.testing.assert_allclose(out[-1], np.asarray(accum), rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(out[-1], np.mean(frames, axis=0), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out[0], frames[0])
    assert np.abs(frames[0] - frames[1]).max() > 1e-3  # fresh samples per frame


def test_update_transforms_changes_frame_and_resets(setup):
    cfg = setup["cfg"].replace(kernels="auto", accumulate=True,
                               auto_refresh_drift=0.0)
    r = make(cfg, use_cache=False)
    before = [r.render_frame() for _ in range(2)][-1]
    assert r._accum_count == 2
    t = r.scene.transforms().copy()
    t[1, 0, 3] += 1.0
    r.update_transforms(t)
    assert r._accum_count == 0 and r._accum is None
    np.testing.assert_array_equal(r.arrays.transforms.numpy(), t)
    np.testing.assert_allclose(r.arrays.inv_transforms.numpy()[1],
                               np.linalg.inv(t[1].astype(np.float64)), atol=1e-6)
    after = r.render_frame()
    assert np.abs(after - before).max() > 1e-3


def test_auto_refresh_fires_past_drift(setup, monkeypatch):
    """refresh_topology runs once an instance moves farther than
    auto_refresh_drift x the scene diagonal since the last topology build,
    and not before; it repacks from the live transforms."""
    r = make(setup["cfg"].replace(auto_refresh_drift=0.25), use_cache=False)
    calls = []
    real = r.refresh_topology
    monkeypatch.setattr(r, "refresh_topology", lambda: (calls.append(1), real()))
    diag = r._scene_diagonal()
    t = r.scene.transforms().copy()
    t[1, 0, 3] += 0.1 * diag
    r.update_transforms(t)
    assert calls == []
    t[1, 0, 3] += 0.3 * diag
    r.update_transforms(t)
    assert calls == [1]
    np.testing.assert_array_equal(r._topo_transforms, t)
    np.testing.assert_array_equal(r.arrays.transforms.numpy(), t)


def test_failed_build_makes_frames_raise(setup, monkeypatch):
    """A failed kernel build sets path_tracer_failed and every later frame
    (path-traced or preview, sync or async) and warmup raise."""
    def boom(device):
        raise RuntimeError("injected build failure")

    monkeypatch.setattr(renderer_mod, "_load_kernels", boom)
    r = Renderer(demo.build_demo_scene(W, H), setup["cfg"], use_cache=False,
                 async_compile=True, device="cpu")
    r.close()
    assert r.path_tracer_failed and not r.path_tracer_ready
    for call in (r.render_frame, lambda: r.render_frame(mode="preview"),
                 r.render_frame_async, lambda: r.warmup(1)):
        with pytest.raises(RuntimeError, match="failed to build"):
            call()


def test_multichip_entry_points_raise(setup, tmp_path):
    """The multi-chip entry points render (parallel.py): Renderer.multi_chip
    tiles every frame over make_mesh's devices and equals the single-device
    Renderer, and the CLI's --multichip writes its frame; what still raises
    is a mesh that is no list of devices."""
    from rayzen_tpu_torch.cli import main

    scene = demo.build_demo_scene(W, H)
    with pytest.raises(TypeError):
        Renderer(scene, setup["cfg"], mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="empty device list"):
        Renderer(scene, setup["cfg"], mesh=[], device="cpu")
    r = Renderer.multi_chip(scene, setup["cfg"], n_devices=3, async_compile=False,
                            device="cpu")
    assert r.mesh == [torch.device("cpu")] * 3
    np.testing.assert_array_equal(r.render_frame(), make(setup["cfg"]).render_frame())
    out = tmp_path / "x.png"
    assert main(["--multichip", "--device", "cpu", "--width", "8", "--height", "8",
                 "--bounces", "2", "--cache-dir", str(tmp_path),
                 "--out", str(out)]) == 0
    assert out.exists()
