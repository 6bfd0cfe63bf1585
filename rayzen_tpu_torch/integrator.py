"""Path-tracing entry points: the full-sample kernel (K1), the split-bounce
wavefront (K4) and the per-wave path.

Port of rayzen_tpu/integrator.py. ``select_kernels`` (:47-89) picks the
path from ``cfg.kernels`` and ``tracer``:
- "auto" and "pallas": the megakernel path (render_rays :346-431). One
  refit per frame (packing.world_geometry), then one K1 launch that sums
  all ``cfg.spp`` samples per pixel, then the /spp clip (glsl:772-773).
- "pallas-ml", "pallas-bvh2", "pallas-nomega", "xla" and ``tracer="brute"``:
  the per-wave path (:433-491). Per sample, the sampler's jitter and
  ``generate_rays``, then ``trace_wave``: bounce 0 with direct lighting,
  then bounces 1..max_bounces-1 while any ray lives, each bounce one
  closest-hit walk over the whole wave and, on bounce 0, one shadow walk
  per light. The walks: K7 closest and shadow (the miss-link kernels) for
  "pallas-ml"; K2/K3 for "pallas-bvh2"; K6 for the primary hit and K2/K3
  for the rest for "pallas-nomega"; the portable torch walks
  (ops/traverse.py) for "xla"; the brute-force oracles for "brute". On
  CUDA tensors the "pallas-*" walks launch their kernels; the glue between
  them is torch.

Split bounce: under JAX's own condition (:400-404), ``0 < split_bounce <
max_bounces``, the reference (sin-hash) RNG, a single-tree scene and no
wide nodes, the megakernel path loops the samples on the host, one
megakernel.sample_wave_split per sample (phase 1, a compaction, one or,
with ``split_every``, several continuation launches). Other configs with
``split_bounce`` run the fused K1, as in JAX. ``octant_bounce_walks`` runs
the bounce walks of K1 and of the continuation as K9 (8 octant-masked
sub-walks), over any view.

Walk knobs of K1, selected as in JAX (megakernel.py:503-525):
``wide_nodes`` runs K1's wide instantiation (the K5 walks), ignored with an
info log on a tiered scene; ``frustum_primary`` runs the primary closest hit
of each sample as K6 on a single-tree scene without wide nodes and without
sample fusion, in K1 and in the split path's phase 1. ``sample_fuse`` fixes
the order in which K1 sums the samples (megakernel.sample_fuse).

Ray counts are int64 throughout (the JAX package keeps them in int32, which
overflows past 2^31 rays per call). The reference sampler keys progressive
frames as JAX does: sample ``samp`` of frame ``rng_key`` is sample
``samp + rng_key * spp``, in float32.

Large scenes: ``cfg.tiered`` ("auto", "on", "off") is a pack-time choice
(packing.pack_scene_host). When the pack built the treelet view, K1 runs
its tiered instantiation with the K8 walks, as the JAX megakernel does.
With "off" past ``SINGLE_TREE_VMEM_BUDGET``, JAX's "auto" leaves the
megakernel for its XLA path (:365-384), because its tables would not fit
a TPU core's VMEM; the H100 has no such limit and its whole-tree K1 is
faster than the per-wave path, so the port keeps K1 there (ROADMAP queue 3).

The packet-only knobs ``packet_tile``, ``dense_leaves``, ``dual_pop`` and
``walk_pop`` shape how a 4096-ray packet walks the tree; a per-thread walk
has no such choice, so they are accepted and ignored. ``compact_rays`` and
``bounce_rebin`` reorder the per-wave path's bounce rays before a kernel
walk, as in JAX; the megakernel path ignores them, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from . import material as mat_mod
from .config import RenderConfig
from .ops import camera_rays, megakernel, walk
from .ops.intersect import dot3, normalize
from .ops.rng import HashSampler, ReferenceSampler
from .ops.shade import (
    direct_lighting, fresnel_schlick, hemisphere_direction, reflect,
    refract_dir, sky_color,
)
from .ops.traverse import (
    brute_force_world, hit_shading_data, shadow_brute, traverse_world,
)
from .packing import SceneArrays, WorldArrays, world_geometry

KERNELS = ("auto", "pallas", "pallas-ml", "pallas-bvh2", "pallas-nomega", "xla")
TRACERS = ("bvh", "brute")


def check_config(cfg: RenderConfig, tracer: str = "bvh") -> None:
    """Raise NotImplementedError for a ``kernels`` or ``tracer`` value the
    port does not know."""
    bad = []
    if tracer not in TRACERS:
        bad.append(f"tracer={tracer!r}")
    if cfg.kernels not in KERNELS:
        bad.append(f"kernels={cfg.kernels!r}")
    if bad:
        raise NotImplementedError(
            f"rayzen_tpu_torch does not implement {', '.join(bad)}")


def select_kernels(cfg: RenderConfig, tracer: str = "bvh"):
    """(closest_hit, shadow, closest_hit_primary, use_mega): the per-wave
    walks (None: the portable torch walks) or, with use_mega, K1."""
    check_config(cfg, tracer)
    if tracer == "brute":
        return brute_force_world, shadow_brute, None, False
    # the live-ray walks take a whole frame's wave in K1's warp tiles, and
    # the frustum walk its packets as those tiles
    frame = dict(width=cfg.width, height=cfg.height)
    if cfg.kernels == "pallas-ml":  # the miss-link kernels (K7)
        return (functools.partial(walk.closest_hit_misslink, **frame),
                functools.partial(walk.shadow_walk_misslink, **frame), None,
                False)
    bvh2 = (functools.partial(walk.closest_hit_bvh2, **frame),
            functools.partial(walk.shadow_walk_bvh2, **frame))
    if cfg.kernels == "pallas-bvh2":  # K2 / K3
        return (*bvh2, None, False)
    if cfg.kernels == "pallas-nomega":  # the frustum walk for the primary hit
        return (*bvh2, functools.partial(walk.closest_hit_frustum, **frame),
                False)
    if cfg.kernels == "xla":
        return None, None, None, False
    return None, None, None, True  # "auto", "pallas": K1


def _make_sampler(cfg: RenderConfig, frag, uv, width: int, height: int,
                  key: int):
    if cfg.rng == "reference":
        return ReferenceSampler(uv, frag)
    pixel_id = frag[:, 1].long() * (width * 2) + frag[:, 0].long()
    sampler = HashSampler(pixel_id, key=key)
    # HashSampler jitters a full pixel for AA; convert to uv units here
    inv_res = torch.tensor([1.0 / width, 1.0 / height], dtype=torch.float32,
                           device=uv.device)
    base_jitter = sampler.camera_jitter
    sampler.camera_jitter = lambda: base_jitter() * inv_res
    return sampler


def _scatter(direction, normal, material, cur_ior, rand_val, hemi_u, hemi_v):
    """Material-dependent scatter (glsl:722-756): deterministic dielectric
    refraction with a TIR fallback, stochastic reflect-vs-diffuse for opaque
    surfaces. Returns (new_dir, throughput factor (R, 3), new_ior)."""
    albedo = material[:, mat_mod.ALBEDO]
    reflectivity = material[:, mat_mod.REFLECTIVITY]
    transparency = material[:, mat_mod.TRANSPARENCY]
    mat_ior = material[:, mat_mod.IOR]
    is_trans = transparency > 0.0

    entering = dot3(-direction, normal) > 0.0
    n_out = torch.where(entering[:, None], normal, -normal)
    next_ior = torch.where(entering, mat_ior, 1.0)
    eta = cur_ior / next_ior
    cosi = torch.clamp(dot3(-direction, n_out), 0.0, 1.0)
    q = (cur_ior - next_ior) / (cur_ior + next_ior)
    f0 = q * q
    fresnel = fresnel_schlick(cosi, f0)
    refr, refr_ok = refract_dir(direction, n_out, eta)

    tir_case = is_trans & ~refr_ok
    refract_case = is_trans & refr_ok
    mirror_case = ~is_trans & (rand_val < reflectivity)

    refl_about_out = reflect(direction, n_out)  # TIR (glsl:736)
    refl_about_n = reflect(direction, normal)  # opaque mirror (glsl:751)
    diff_dir = hemisphere_direction(normal, hemi_u, hemi_v)

    def pick(tir, refr_, mirror, diffuse):
        return torch.where(
            tir_case[:, None], tir,
            torch.where(refract_case[:, None], refr_,
                        torch.where(mirror_case[:, None], mirror, diffuse)))

    new_dir = pick(refl_about_out, refr, refl_about_n, diff_dir)
    tint = (1.0 - transparency)[:, None] + albedo * transparency[:, None]
    transmit_w = torch.clamp(
        tint * (transparency * (1.0 - fresnel))[:, None], 0.0, 1.0)
    ones = torch.ones_like(albedo)
    factor = pick(ones * 0.98, transmit_w, ones * 0.95, albedo * 0.4)
    new_ior = torch.where(refract_case, next_ior, cur_ior)
    return new_dir, factor, new_ior


def _reorder_hit(h: walk.Hit, idx) -> walk.Hit:
    return walk.Hit(**{f.name: getattr(h, f.name)[idx]
                       for f in dataclasses.fields(h)})


def _compacted_trace(trace, ws, origin, direction, alive):
    """Stream-compact the live rays to the front (prefix sums, no sort),
    walk, scatter back (integrator.trace_wave's compacted_trace)."""
    a = alive.long()
    pos_alive = torch.cumsum(a, 0) - a
    pos_dead = a.sum() + torch.cumsum(1 - a, 0) - (1 - a)
    pos = torch.where(alive, pos_alive, pos_dead)
    order = torch.empty_like(pos)
    order[pos] = torch.arange(pos.numel(), device=pos.device)
    h = trace(ws, origin[order], direction[order], alive[order])
    return _reorder_hit(h, pos)


def _rebinned_trace(trace, ws, origin, direction, alive):
    """Sort the wave by direction octant, then by origin cell on an 8^3
    grid over the live rays' bounds, dead rays last, before the walk
    (integrator.trace_wave's rebinned_trace)."""
    lo = torch.where(alive[:, None], origin, 1e30).amin(dim=0)
    hi = torch.where(alive[:, None], origin, -1e30).amax(dim=0)
    span = torch.clamp_min(hi - lo, 1e-6)
    cell = torch.clamp((origin - lo) / span * 8.0, 0.0, 7.0).int()
    octant = ((direction[:, 0] > 0).int() + 2 * (direction[:, 1] > 0).int()
              + 4 * (direction[:, 2] > 0).int())
    key = octant * 512 + (cell[:, 0] * 8 + cell[:, 1]) * 8 + cell[:, 2]
    key = torch.where(alive, key, 1 << 30)  # dead to the back
    order = torch.argsort(key, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    h = trace(ws, origin[order], direction[order], alive[order])
    return _reorder_hit(h, inv)


def trace_wave(ws: WorldArrays, origin, direction, cam_position,
               cfg: RenderConfig, sampler, samp, max_bounces: int,
               trace_fn=None, shadow_fn=None, trace_primary_fn=None,
               active=None):
    """Trace one sample's wave to completion (integrator.trace_wave
    :165-343). Returns (radiance (R, 3), rays () int64): every closest-hit
    query of a live ray (primary and bounces) and every shadow ray cast.
    Bounce 0 alone does direct lighting (glsl:716); bounces 1.. run while
    any ray is alive."""
    trace = trace_fn or traverse_world
    trace_primary = trace_primary_fn or trace
    if shadow_fn is None and trace is brute_force_world:
        shadow_fn = shadow_brute
    dev = direction.device
    cam = camera_rays.camera_tensor(cam_position, dev)
    color = torch.zeros_like(direction)
    throughput = torch.ones_like(direction)
    alive = (torch.ones(direction.shape[0], dtype=torch.bool, device=dev)
             if active is None else active.to(torch.bool))
    cur_ior = torch.ones_like(direction[:, 0])  # medium tracking (glsl:674)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    walked = trace_fn is not None and trace is not brute_force_world
    compact = cfg.compact_rays and walked
    rebin = cfg.bounce_rebin and walked

    bounce = 0
    while bounce < max_bounces and (bounce == 0 or bool(alive.any())):
        rays = rays + alive.sum(dtype=torch.int64)
        if bounce == 0:
            hit = trace_primary(ws, origin, direction, alive)  # coherent wave
        elif rebin:
            hit = _rebinned_trace(trace, ws, origin, direction, alive)
        elif compact:
            hit = _compacted_trace(trace, ws, origin, direction, alive)
        else:
            hit = trace(ws, origin, direction, alive)
        missed = alive & ~hit.found
        color = color + torch.where(
            missed[:, None], throughput * sky_color(direction, cfg), 0.0)
        alive = alive & hit.found
        normal, material, _ = hit_shading_data(ws, hit)

        if bounce == 0:  # direct lighting on bounce 0 only (glsl:716)
            view_dir = normalize(cam - hit.point, eps=1e-20)
            direct, shadow_rays = direct_lighting(
                ws, hit.point, normal, material, view_dir, alive, cfg,
                shadow_fn=shadow_fn)
            color = color + torch.where(alive[:, None], throughput * direct, 0.0)
            rays = rays + shadow_rays

        rand_val, hemi_u, hemi_v = sampler.bounce_draws(samp, bounce)
        new_dir, factor, cur_ior = _scatter(
            direction, normal, material, cur_ior, rand_val, hemi_u, hemi_v)
        throughput = throughput * factor
        # self-intersection offset along the geometric normal, signed by the
        # new direction (glsl:758-761)
        push = torch.where(dot3(new_dir, normal) > 0.0, 1.0, -1.0)
        origin = hit.point + normal * (push * 0.003)[:, None]
        direction = new_dir
        # Russian roulette (glsl:764-769), reusing rand_val
        if bounce > cfg.rr_start_bounce:
            p = throughput.amax(dim=-1)
            alive = alive & ~(rand_val > p)
            throughput = throughput / torch.clamp_min(p, 1e-12)[:, None]
        bounce += 1
    return color, rays


def _sample_index(cfg: RenderConfig, samp: int, rng_key):
    """The sampler's sample index: for the sin-hash flow the float32
    progressive key samp + rng_key * spp (a pure function of pixel and
    index, so frame k continues at sample k * spp), else the integer."""
    if cfg.rng != "reference":
        return samp
    return float(np.float32(samp) + np.float32(rng_key) * np.float32(cfg.spp))


def render_rays(
    arrays: SceneArrays,
    frag,  # (R, 2) gl_FragCoord-style pixel coordinates
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
    (0-d int64) when ``with_stats``. Every draw is keyed by the pixel (its
    uv or frag), not by its slot in the wave, so any wave of a frame's
    pixels renders them as the whole frame does (parallel.py's tiles)."""
    check_config(cfg, tracer)
    ws = world_geometry(arrays)  # one refit per frame, shared by all waves
    return render_world_rays(ws, frag, uv, camera_params, cfg, max_bounces,
                             tracer, rng_key, active, with_stats)


def render_world_rays(ws: WorldArrays, frag, uv, camera_params: dict,
                      cfg: RenderConfig, max_bounces: Optional[int] = None,
                      tracer: str = "bvh", rng_key: int = 0, active=None,
                      with_stats: bool = False):
    """render_rays over a world already refitted (``ws``)."""
    max_bounces = max_bounces or cfg.max_bounces
    trace_fn, shadow_fn, trace_primary_fn, use_mega = select_kernels(cfg, tracer)
    if use_mega:
        total, rays = _render_mega(ws, uv, camera_params, cfg, max_bounces,
                                   rng_key, active)
    else:
        total, rays = trace_samples(ws, frag, uv, camera_params, cfg,
                                    max_bounces, rng_key, active, trace_fn,
                                    shadow_fn, trace_primary_fn)
    color = torch.clamp(total / float(cfg.spp), 0.0, 1.0)  # glsl:772-773
    if with_stats:
        return color, rays
    return color


def trace_samples(ws: WorldArrays, frag, uv, camera_params: dict,
                  cfg: RenderConfig, max_bounces: int, rng_key, active=None,
                  trace_fn=None, shadow_fn=None, trace_primary_fn=None):
    """The per-wave path's sample loop (integrator.py:433-491): per sample,
    the sampler's jitter, ``generate_rays`` and ``trace_wave`` on the given
    walks (None: the portable ones). Returns (colour sum over samples
    (R, 3), rays () int64)."""
    sampler = _make_sampler(cfg, frag, uv, cfg.width, cfg.height, rng_key)
    total = torch.zeros((uv.shape[0], 3), dtype=torch.float32, device=uv.device)
    rays = torch.zeros((), dtype=torch.int64, device=uv.device)
    for s in range(cfg.spp):
        samp = _sample_index(cfg, s, rng_key)
        sampler.start_sample(samp)
        origin, direction = camera_rays.generate_rays(
            uv, sampler.camera_jitter(), camera_params["inv_proj"],
            camera_params["inv_view"], camera_params["position"])
        radiance, r = trace_wave(
            ws, origin, direction, camera_params["position"], cfg, sampler,
            samp, max_bounces, trace_fn=trace_fn, shadow_fn=shadow_fn,
            trace_primary_fn=trace_primary_fn, active=active)
        total, rays = total + radiance, rays + r
    return total, rays


def _render_mega(ws: WorldArrays, uv, camera_params: dict, cfg: RenderConfig,
                 max_bounces: int, rng_key, active):
    """The megakernel path: (colour sum over samples (R, 3), rays ())."""
    act = (
        torch.ones((uv.shape[0],), dtype=torch.bool, device=uv.device)
        if active is None else active.to(torch.bool)
    )
    split = (
        0 < cfg.split_bounce < max_bounces
        and cfg.rng == "reference" and not ws.tiered
        and not cfg.wide_nodes
    )
    if not split:  # all spp accumulate inside K1 (one launch per frame)
        return megakernel.sample_wave(
            ws, cfg, uv, act, camera_params, 0, rng_key, max_bounces,
            n_samples=cfg.spp)
    # the continuation state is per (ray, sample): one split per sample
    total = torch.zeros((uv.shape[0], 3), dtype=torch.float32, device=uv.device)
    rays = torch.zeros((), dtype=torch.int64, device=uv.device)
    for s in range(cfg.spp):
        c, r = megakernel.sample_wave_split(
            ws, cfg, uv, act, camera_params, s, rng_key, max_bounces)
        total, rays = total + c, rays + r
    return total, rays


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
