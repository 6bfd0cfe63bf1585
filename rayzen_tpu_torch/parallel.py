"""Rendering with the pixels cut into tiles over a list of devices.

Port of rayzen_tpu/parallel.py. The JAX package shards the flattened ray
axis over a 1-D device mesh with shard_map: the scene is replicated to
every chip, each chip path-traces its contiguous tile of rays, and one
psum adds the ray counts. JAX is one controller over all chips; so is this
module, in one process and without torch.distributed: a "mesh" is a list
of torch devices, each tile is rendered on its device by
integrator.render_world_rays with the scene replicated there (``replicate``,
which a caller such as the Renderer keeps across frames; one refit per
distinct device and frame), the colours come back to the first device and
the ray counts are summed there in int64.

The ray axis is padded to a multiple of the tile count with inactive rays.
A device may appear more than once (tiles of one card, or of the CPU in
the tests). Every draw is keyed by the pixel, not by its slot in the wave,
so the tiled frame equals the single-device frame bit for bit (but for the
K6 forms, frustum_primary and "pallas-nomega", whose packets are the warps
of the wave's slots: a tile's packets can differ from the frame's, and so
can a pixel where a box test rounds). Launches go
to each tile's device and nothing waits for the host between them, so the
tiles of different cards should run at once; no run with a second card
has checked that overlap or timed the copies between cards.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch

from .config import RenderConfig
from .integrator import check_config, render_world_rays
from .ops import camera_rays
from .packing import _SCENE_ARRAY_FIELDS, SceneArrays, to_device, world_geometry


def make_mesh(n_devices: Optional[int] = None, device_type: str = "cuda"):
    """``n_devices`` tiles (default: one per device of ``device_type``) over
    the devices of that type, round robin: a list of torch.device. The CPU
    is one device, so ``make_mesh(8, "cpu")`` is eight tiles on it."""
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device")
        devices = [torch.device("cuda", i) for i in range(count)]
    else:
        devices = [torch.device(device_type)]
    n = n_devices or len(devices)
    if n < 1:
        raise ValueError(f"make_mesh: {n} tiles")
    return [devices[k % len(devices)] for k in range(n)]


def _on(device: torch.device):
    """Make ``device`` the current CUDA device (the kernels launch on the
    current device's streams); nothing to do for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def replicate(arrays: SceneArrays, mesh: Sequence, previous=None) -> dict:
    """The scene on every distinct device of ``mesh``: {device:
    SceneArrays}. ``previous`` is an earlier call's (arrays, result): a
    table of ``arrays`` that is the same object as there is not copied
    again, so after SceneArrays.with_transforms only the transforms
    move."""
    prev_arrays, prev = previous if previous is not None else (None, {})
    out = {}
    for d in dict.fromkeys(torch.device(x) for x in mesh):
        kept = prev.get(d)
        out[d] = dataclasses.replace(arrays, **{
            f: (getattr(kept, f) if kept is not None
                and getattr(arrays, f) is getattr(prev_arrays, f)
                else to_device(getattr(arrays, f), d))
            for f in _SCENE_ARRAY_FIELDS})
    return out


def render_radiance_sharded(
    arrays: SceneArrays,
    camera_params: dict,
    cfg: RenderConfig,
    mesh: Sequence,
    max_bounces: Optional[int] = None,
    tracer: str = "bvh",
    rng_key: int = 0,
    with_stats: bool = False,
    replicas: Optional[dict] = None,
):
    """The full (H, W, 3) frame with the ray axis cut into ``len(mesh)``
    contiguous tiles, tile k rendered on mesh[k]; the frame is returned on
    mesh[0], with the traced-ray count over all tiles (0-d int64 there)
    when ``with_stats``. ``replicas`` is ``replicate(arrays, mesh)``, kept
    by a caller that renders many frames of one scene; without it the
    scene is copied to each device on this call."""
    check_config(cfg, tracer)
    mesh = [torch.device(d) for d in mesh]
    if not mesh:
        raise ValueError("render_radiance_sharded: an empty device list")
    home = mesh[0]
    if replicas is None:
        replicas = replicate(arrays, mesh)
    worlds = {}
    for d in dict.fromkeys(mesh):  # one refit a device
        with _on(d):
            worlds[d] = world_geometry(replicas[d])
    frag, uv = camera_rays.pixel_grid(cfg.width, cfg.height, home)
    n_rays, n_tiles = frag.shape[0], len(mesh)
    tile = -(-n_rays // n_tiles)
    pad = tile * n_tiles - n_rays
    frag = torch.nn.functional.pad(frag, (0, 0, 0, pad))
    uv = torch.nn.functional.pad(uv, (0, 0, 0, pad))
    active = torch.arange(tile * n_tiles, device=home) < n_rays

    colors, rays = [], []
    for k, d in enumerate(mesh):
        sl = slice(k * tile, (k + 1) * tile)
        with _on(d):
            c, r = render_world_rays(
                worlds[d], frag[sl].to(d), uv[sl].to(d), camera_params, cfg,
                max_bounces=max_bounces, tracer=tracer, rng_key=rng_key,
                active=active[sl].to(d), with_stats=True)
        colors.append(c.to(home))
        rays.append(r.to(home))
    color = torch.cat(colors)[:n_rays].reshape(cfg.height, cfg.width, 3)
    if with_stats:
        return color, torch.stack(rays).sum()
    return color


def jit_sharded_renderer(arrays: SceneArrays, cfg: RenderConfig, mesh: Sequence,
                         **kw):
    """A (arrays, camera_params) -> frame closure over ``mesh``. JAX's name
    is kept; torch has nothing to compile, so it is a plain closure (and,
    as in JAX, ``arrays`` only stands for the call's signature)."""

    def fn(arrays_, camera_params):
        return render_radiance_sharded(arrays_, camera_params, cfg, mesh, **kw)

    return fn
