"""Pixel grid and primary rays (rayzen_tpu/ops/camera_rays.py).

The port renders in scanline order. rayzen_tpu swizzles pixels into 64x64
tiles (``tile_permutation``) only so that a 4096-ray packet, which walks the
tree by consensus, covers a compact screen region. Here every thread walks
its own ray, and K1 maps its warps to 8x4-pixel screen tiles inside the
kernel (csrc/sample_kernel.cu), so the arrays stay in scanline order.
"""

from __future__ import annotations

import numpy as np
import torch

from .intersect import normalize


def pixel_grid(width: int, height: int, device):
    """Returns (frag, uv): gl_FragCoord.xy (pixel centres, +0.5) and uv in
    [0, 1], both (H*W, 2) float32, row-major with y increasing upward like
    GL — bit-identical to the JAX grid."""
    x = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    y = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    fy, fx = torch.meshgrid(y, x, indexing="ij")  # (H, W)
    frag = torch.stack([fx.reshape(-1), fy.reshape(-1)], dim=-1)
    # the resolution made on the device (fills, no host copy), divided as a
    # tensor
    uv = frag / resolution(width, height, device)
    return frag, uv


def resolution(width: int, height: int, device) -> torch.Tensor:
    """(2,) float32 [width, height] on ``device``, made by two fills: a
    tensor from host data, or an element assigned from Python, is a copy
    that synchronises the stream."""
    return torch.cat([torch.full((1,), float(width), device=device),
                      torch.full((1,), float(height), device=device)])


def upload(x, device) -> torch.Tensor:
    """A host array as a tensor on ``device``, dtype kept, without a stream
    sync: for a CUDA device it is staged in pinned memory and copied with
    non_blocking=True (PyTorch's pinned-memory allocator keeps the staging
    block until the copy has run), where a copy from pageable memory would
    synchronise the stream."""
    t = torch.from_numpy(np.array(x))  # a copy: never aliases the caller's array
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def camera_tensor(x, device):
    """A camera parameter (numpy array or tensor) as float32 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return upload(np.asarray(x, np.float32), device)


def generate_rays(uv, jitter, inv_proj, inv_view, cam_position):
    """The calculateRay kernel (glsl:204-212) batched over rays: uv and
    jitter (R, 2); returns (origin (R, 3), direction (R, 3)). NDC -> eye ->
    world through the inverse projection and view matrices, as two float32
    4x4 products (the JAX package asks XLA for full precision there)."""
    dev = uv.device
    inv_proj = camera_tensor(inv_proj, dev)
    inv_view = camera_tensor(inv_view, dev)
    ndc = (uv + jitter) * 2.0 - 1.0
    ones = torch.ones_like(ndc[:, :1])
    clip = torch.cat([ndc, -ones, ones], dim=-1)
    eye = clip @ inv_proj.T
    # ray_eye = (x, y, -1, 0)  (glsl:209)
    eye = torch.cat([eye[:, :2], -ones, torch.zeros_like(ones)], dim=-1)
    direction = normalize((eye @ inv_view.T)[:, :3])
    origin = camera_tensor(cam_position, dev).expand_as(direction)
    return origin, direction
