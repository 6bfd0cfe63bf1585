"""Path-tracing entry points on the full-sample kernel (K1) and the
split-bounce wavefront (K4).

Port of the megakernel path of rayzen_tpu/integrator.py (render_rays
:346-431, render_radiance :506, render_radiance_with_stats :526): one refit
per frame (packing.world_geometry), then one K1 launch that sums all
``cfg.spp`` samples per pixel, then the /spp clip (glsl:772-773).

Split bounce: under JAX's own condition (:400-404) — ``0 < split_bounce <
max_bounces``, the reference (sin-hash) RNG, a single-tree scene and no
wide nodes — the samples are looped on the host instead, one
megakernel.sample_wave_split per sample (phase 1, a compaction, one or,
with ``split_every``, several continuation launches). Other configs with
``split_bounce`` run the fused K1, as in JAX. ``octant_bounce_walks`` runs
the bounce walks of K1 and of the continuation as K9 (8 octant-masked
sub-walks), over any view.

Walk knobs, selected as in JAX (megakernel.py:503-525): ``wide_nodes`` runs
K1's wide instantiation (the K5 walks for the primary hit, the shadows and
the bounces), and is ignored with an info log on a tiered scene;
``frustum_primary`` runs the primary closest hit of each sample as K6, the
warp-packet frustum walk (shadows and bounces keep K2/K3), on a single-tree
scene without wide nodes, in K1 and in the split path's phase 1.

Ray counts are int64 throughout (the JAX package keeps them in int32, which
overflows past 2^31 rays per call).

Large scenes: ``cfg.tiered`` ("auto", "on", "off") is a pack-time choice
(packing.pack_scene_host). When the pack built the treelet view (past
``SINGLE_TREE_VMEM_BUDGET`` with "auto", always with "on"), K1 runs its
tiered instantiation with the K8 walks, as the JAX megakernel does. With
"off" past the budget the JAX package leaves the megakernel for its XLA path
(rayzen_tpu/integrator.py:365-384) and its Renderer chunks the scene
(renderer.py:65-80); the port has neither yet (bigscene.py and the portable
path, ROADMAP queue 1) and runs the whole-tree K1 there, which the H100
holds in device memory at any size the pack reaches.

Configuration knobs of the JAX package that this port does not implement
(``kernels`` other than "auto", ``walk_pop`` > 1, ``sample_fuse`` > 1,
tracers other than "bvh") raise NotImplementedError. The packet-only knobs
``packet_tile``, ``dense_leaves`` and ``dual_pop`` shape how a 4096-ray
packet walks the tree; a per-thread walk has no such choice, so they are
accepted and ignored, as are ``compact_rays`` and ``bounce_rebin``, which
the JAX megakernel path ignores too.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import RenderConfig
from .ops import camera_rays, megakernel
from .packing import SceneArrays, world_geometry


def check_config(cfg: RenderConfig, tracer: str = "bvh") -> None:
    """Raise NotImplementedError for a knob the port does not implement."""
    unsupported = {
        "tracer": tracer != "bvh",
        "kernels": cfg.kernels != "auto",
        "walk_pop": cfg.walk_pop > 1,
        "sample_fuse": cfg.sample_fuse > 1,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"rayzen_tpu_torch does not implement {', '.join(bad)} yet"
        )


def render_rays(
    arrays: SceneArrays,
    frag,  # (R, 2) gl_FragCoord-style pixel coordinates (unused: uv carries them)
    uv,  # (R, 2) in [0, 1]
    camera_params: dict,
    cfg: RenderConfig,
    max_bounces: Optional[int] = None,
    tracer: str = "bvh",
    rng_key: int = 0,
    active=None,  # (R,) bool
    with_stats: bool = False,
):
    """Path-trace a wave of pixels on the device of ``arrays`` (tensors, see
    SceneArrays.to); returns (R, 3) clamped colour, and the traced-ray count
    (0-d int64) when ``with_stats``."""
    check_config(cfg, tracer)
    max_bounces = max_bounces or cfg.max_bounces
    ws = world_geometry(arrays)
    act = (
        torch.ones((uv.shape[0],), dtype=torch.bool, device=uv.device)
        if active is None else active.to(torch.bool)
    )
    split = (
        0 < cfg.split_bounce < max_bounces
        and cfg.rng == "reference" and not ws.tiered
        and not cfg.wide_nodes
    )
    if split:
        # the continuation state is per (ray, sample): one split per sample
        total = torch.zeros((uv.shape[0], 3), dtype=torch.float32,
                            device=uv.device)
        rays = torch.zeros((), dtype=torch.int64, device=uv.device)
        for s in range(cfg.spp):
            c, r = megakernel.sample_wave_split(
                ws, cfg, uv, act, camera_params, s, rng_key, max_bounces)
            total, rays = total + c, rays + r
    else:  # all spp accumulate inside K1 (one launch per frame)
        total, rays = megakernel.sample_wave(
            ws, cfg, uv, act, camera_params, 0, rng_key, max_bounces,
            n_samples=cfg.spp,
        )
    color = torch.clamp(total / float(cfg.spp), 0.0, 1.0)  # glsl:772-773
    if with_stats:
        return color, rays
    return color


def render_radiance_with_stats(
    arrays: SceneArrays,
    camera_params: dict,
    cfg: RenderConfig,
    max_bounces: Optional[int] = None,
    tracer: str = "bvh",
    rng_key=0,
):
    """Full frame (H, W, 3) float32 in [0, 1], bottom-up rows (GL), and the
    traced-ray count (0-d int64), in scanline order (ops/camera_rays.py)."""
    frag, uv = camera_rays.pixel_grid(
        cfg.width, cfg.height, arrays.transforms.device
    )
    color, rays = render_rays(
        arrays, frag, uv, camera_params, cfg, max_bounces, tracer, rng_key,
        with_stats=True,
    )
    return color.reshape(cfg.height, cfg.width, 3), rays


def render_radiance(
    arrays: SceneArrays,
    camera_params: dict,
    cfg: RenderConfig,
    max_bounces: Optional[int] = None,
    tracer: str = "bvh",
    rng_key=0,
):
    """Like render_radiance_with_stats, without the ray count."""
    return render_radiance_with_stats(
        arrays, camera_params, cfg, max_bounces, tracer, rng_key
    )[0]
