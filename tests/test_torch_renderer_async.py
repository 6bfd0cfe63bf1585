"""The port's frame loop beyond the synchronous frame, on the CPU:
render_frame_async(...).resolve() against render_frame (path-traced with
and without accumulation, fused overlays, previews), the fused overlays
against the unfused composite, render_batch's int64 ray count against the
synchronous frames' and its guards, and stack_camera_params. Each
Renderer frame here is the integrator's frame and the overlay composite's,
which tests/test_torch_renderer.py and tests/test_torch_overlay.py hold to
the JAX package. Demo scene, 24x16, 1 spp, 2 bounces."""

import numpy as np
import pytest
import torch

from rayzen_tpu_torch import RenderConfig, demo
from rayzen_tpu_torch.integrator import render_radiance_with_stats
from rayzen_tpu_torch.renderer import PendingFrame, Renderer, stack_camera_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 24, 16
OVERLAYS = dict(show_fps_overlay=True, debug_show_lights=True, debug_show_bvh=True)


@pytest.fixture
def make(tmp_path):
    def make(**knobs):
        cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=2,
                           cache_dir=str(tmp_path), **knobs)
        return Renderer(demo.build_demo_scene(W, H), cfg, async_compile=False,
                        device="cpu")
    return make


MOVES = [("w", 0.3), ("look", (20.0, 0.0)), ("d", 0.2), ("look", (-10.0, 5.0))]


def move(r, i):
    cmd, arg = MOVES[i % len(MOVES)]
    cam = r.scene.camera
    if cmd == "look":
        cam.rotate(*arg)
    else:
        {"w": cam.move_forward, "d": cam.move_right}[cmd](arg)
    r.sync_camera()


@pytest.mark.parametrize("knobs", [dict(), dict(accumulate=True), OVERLAYS],
                         ids=["pt", "accumulate", "overlays"])
def test_async_resolve_equals_render_frame(make, knobs):
    """The same frames sync and with 3 in flight, and a profiler record per
    resolved frame."""
    a, b = make(**knobs), make(**knobs)
    sync, pending = [], []
    for i in range(3):
        if not knobs.get("accumulate"):
            move(a, i), move(b, i)
        # the FPS text: the same EMA in both at each dispatch
        b.profiler.fps_ema = a.profiler.fps_ema = 12.5
        sync.append(a.render_frame(mode="pt"))
        pending.append(b.render_frame_async(mode="pt"))
    assert all(isinstance(p, PendingFrame) for p in pending)
    assert [p.frame_no for p in pending] == [0, 1, 2]
    n = len(b.profiler.history)
    for s, p in zip(sync, pending):
        np.testing.assert_array_equal(p.resolve(), s)
    assert len(b.profiler.history) == n + 3
    assert b.profiler.history[-1]["mrays_per_s"] > 0


def test_async_preview_equals_render_frame(make):
    a, b = make(**OVERLAYS), make(**OVERLAYS)
    b.profiler.fps_ema = a.profiler.fps_ema = 3.0
    np.testing.assert_array_equal(b.render_frame_async(mode="preview").resolve(),
                                  a.render_frame(mode="preview"))
    assert "mrays_per_s" not in b.profiler.history[-1]


def test_fused_overlays_equal_unfused(make):
    """A frame past frame 0 with overlays on takes the fused form; it equals
    render then composite (the unfused calls) bit for bit, and the overlays
    drew."""
    r = make(**OVERLAYS)
    r.render_frame(mode="pt")  # frame 0: the first-frame budget, unfused
    assert r._can_fuse_overlays(use_first=False)
    r.profiler.fps_ema = 42.0
    cam = r._camera_params()
    fused = r.render_frame(mode="pt")
    r.profiler.fps_ema = 42.0
    img, _ = render_radiance_with_stats(r.arrays, cam, r.cfg)
    unfused = r._composite_overlays(img, cam).numpy()
    np.testing.assert_array_equal(fused, unfused)
    assert (fused != img.numpy()).any()


def test_render_batch_counts_int64_rays(make):
    """The batch's last frame is the sync loop's (the FPS text pinned), its
    ray count the sum of the sync frames' in int64, and the frame counter
    advances by the batch."""
    a, b = make(**OVERLAYS), make(**OVERLAYS)
    a.render_frame(mode="pt")
    cams, frames, rays = [], [], 0
    for i in range(3):
        move(a, i)
        cam = a._camera_params()
        cams.append(cam)
        a.profiler.fps_ema = 30.0
        frames.append(a.render_frame(mode="pt"))
        rays += int(render_radiance_with_stats(a.arrays, cam, a.cfg)[1])
    img, total = b.render_batch(stack_camera_params(cams), fps=30.0)
    assert total.dtype == torch.int64 and total.dim() == 0
    assert int(total) == rays
    np.testing.assert_array_equal(img.numpy(), frames[-1])
    assert b.frame_index == 3


def test_render_batch_guards_and_stack(make):
    r = make(accumulate=True)
    cams = [r._camera_params(), r._camera_params()]
    stack = stack_camera_params(cams)
    assert {k: v.shape[0] for k, v in stack.items()} == {k: 2 for k in cams[0]}
    assert all(v.dtype == np.float32 for v in stack.values())
    with pytest.raises(RuntimeError, match="accumulate"):
        r.render_batch(stack)
    lazy = Renderer(demo.build_demo_scene(W, H), r.cfg.replace(accumulate=False),
                    async_compile="lazy", device="cpu")
    assert lazy.path_tracer_ready  # nothing to build on the CPU
    r.warmup(2)
    assert r.frame_index == 0
