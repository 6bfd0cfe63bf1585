"""The port's slice end to end on the CPU (port pack -> port refit -> plain
K1) against the goldens the JAX package is held to, plus the package's
import hygiene and its one-frame CLI."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rayzen_tpu_torch import RenderConfig, pack_scene, render_radiance_with_stats
from rayzen_tpu_torch.__main__ import main as cli_main
from rayzen_tpu_torch.demo import build_demo_scene
from rayzen_tpu_torch.image_io import ssim
from rayzen_tpu_torch.integrator import render_rays
from rayzen_tpu_torch.ops.camera_rays import pixel_grid
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


@pytest.mark.parametrize("w,h", [(96, 64), (256, 192)])
def test_demo_matches_golden(w, h):
    cfg = RenderConfig(width=w, height=h, spp=1, max_bounces=5)
    scene = build_demo_scene(w, h)
    arrays = pack_scene(scene, cfg, "cpu")
    img, rays = render_radiance_with_stats(arrays, scene.camera.device_params(), cfg)
    assert img.shape == (h, w, 3) and img.dtype == torch.float32
    assert rays.dtype == torch.int64 and int(rays) > w * h
    golden = np.load(os.path.join(GOLDEN, f"demo_{w}x{h}.npz"))["image"]
    img = img.numpy()
    assert ssim(img, golden.astype(np.float32)) >= 0.995
    assert np.abs(img - golden.astype(np.float32)).mean() < 2e-3


def test_inactive_pixels_trace_nothing():
    cfg = RenderConfig(width=32, height=24, spp=2, max_bounces=3)
    scene = build_demo_scene(32, 24)
    arrays = pack_scene(scene, cfg, "cpu")
    cam = scene.camera.device_params()
    frag, uv = pixel_grid(32, 24, "cpu")
    full, full_rays = render_rays(arrays, frag, uv, cam, cfg, with_stats=True)
    active = torch.arange(uv.shape[0]) % 3 != 0
    part, part_rays = render_rays(arrays, frag, uv, cam, cfg, active=active,
                                  with_stats=True)
    assert (part[~active] == 0).all()
    torch.testing.assert_close(part[active], full[active], rtol=0, atol=0)
    assert 0 < int(part_rays) < int(full_rays)


def test_import_leaves_jax_out():
    code = (
        "import sys, rayzen_tpu_torch, rayzen_tpu_torch.ops.megakernel, "
        "rayzen_tpu_torch.ops.walk, rayzen_tpu_torch.convert; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'rayzen_tpu' or m.startswith('rayzen_tpu.')]; "
        "assert not bad, bad"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env)


def test_cli_writes_png(tmp_path):
    out = tmp_path / "frame.png"
    assert cli_main(["--width", "32", "--height", "24", "--spp", "1",
                     "--bounces", "3", "--out", str(out), "--device", "cpu"]) == 0
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 100
