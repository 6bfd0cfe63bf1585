"""Smoke run of rayzen_tpu_torch on one NVIDIA GPU: build the CUDA kernels,
hold each against its plain PyTorch version, pass the golden-image gates,
then drive the main path (a 1920x1080, 64 spp, 5-bounce frame of the demo
scene), the large-scene path (a 1920x1080, 4 spp, 5-bounce frame of the
503k-triangle field of scripts/bench_large.py, walked through the treelet
view by the tiered K1), the split-bounce wavefront (K4) and the
octant-masked bounce walks (K9) on the demo frame, the wide-node walks (K5,
wide_nodes) and the warp-packet frustum walk (K6, frustum_primary), and the per-wave path
(the portable torch walks and the staged kernels= variants, with the
miss-link walks K7 for "pallas-ml" and the live-ray K2/K3 for
"pallas-bvh2"), the frame loop, deforming meshes on an LBVH built on the
card, frames tiled over a device list and the native BLAS builder, and time
them; then the last host and scene functions (the BLAS and scene walks, the
BVH and PPM files, ref_rand, build_scene_tlas).

Run from the root of a checkout:
    python3 chip_smoke.py [--out-dir DIR]
It needs a CUDA device and nvcc (the kernels are built from csrc/ at first
use); it exits non-zero, printing no result, without them. The last line is
{"ok": true, "device": {...}}; the line before it lists the kernels with
their launch counts from the main-path runs, their measured times and
bounds (bound_ms: the larger of the bytes the call must move over 3.35 TB/s
and its walks' fp32 operations over 67 TFLOP/s, the walk work counted by
the plain walks on the same inputs; library_ms null: no PyTorch call
computes a BVH walk).
With --out-dir, the compiler's full register report and torch.profiler
traces of one main-path and one field-path dispatch are written there.
A timing against an earlier tree's kernels goes through
scripts/k1_schedule.py --tree.

Phases (each prints its own lines and stops the run when it fails):
  1 device        card name and power limit
  2 build         nvcc build of csrc/ with its wall time
  3 walks         K2/K3 vs plain on the demo scene's 256x192 primary rays and
                  shadow rays toward both lights
  4 sample        K1 vs plain at 256x192, spp 1, 5 bounces, both RNG flows
  5 gates         bench.py's golden gates at 256x192 and 800x600 on K1
  6 main path     1080p/64 spp frame: warm-up + timed dispatches
  7 kernels       K1 (64 spp, both RNG flows), K2 and K3 vs plain at the main
                  path's 1080p shapes with the bars of phases 3/4 (the plain
                  K1 renders every 8th column of the frame in the configured
                  reference flow and every 16th in the threefry flow,
                  K1_PLAIN_STRIDE; K1's bound is estimated from the subset's
                  walk work times the pixel ratio), their times, the
                  regenerating K1's compiled budget (registers, spills,
                  resident warps per SM) and its walk-loop lane utilisation
                  (the counting K1), and where one dispatch's time goes
                  (torch.profiler)
  8 launches      K1 launched in the main-path run (K2/K3 run there as device
                  functions of K1); each kernel launched in phase 7
  9 field         the 520-Suzanne field (bench_large.py), packed with the
                  defaults: it must come out tiered (treelet view)
 10 K8            K8 (one node loop over both levels) closest/shadow vs
                  plain (bit for bit) at the field's 1080p primary rays and
                  shadow rays, and vs K2/K3 on the whole tree; its budget
                  and walk-loop lane utilisation (the counting K8)
 11 tiered K1     the tiered K1 vs plain at 1 spp, 320x180 in the configured
                  flow and 160x90 in the other;
                  vs the whole-tree K1 at 1920x1080, 4 spp (bit for bit),
                  with its time, budget and walk-loop lane utilisation
 12 field path    the field's 1080p/4 spp frame (render_radiance_with_stats,
                  tiered K1): timed dispatches, launch counts, the refit and
                  one profiled dispatch, then in turns with the whole-tree K1
                  on the same scene (tiered="off")
 13 split         K4 (phase 1 + compaction + continuation) vs its plain
                  version at 256x192, spp 1, split_bounce 2, in the rank,
                  octant and octcell modes and with split_every; the
                  continuation alone vs plain at 256x192 (split_bounce 1
                  and 2), with its budget
 14 split path    the 1080p/64 spp frame with split_bounce=2,
                  split_rebin="octant": vs K1's frame, launch counts (64
                  phase-1 and 64 continuation launches), timed dispatches in
                  turns with K1, one profiled dispatch (the torch gathers
                  and scans summed); phase 1, compaction and continuation
                  alone at 1080p vs plain (split_bounce 2 and 1), the
                  compaction and continuation run under CUDA's sync debug
                  mode (no count comes back to the host); phase 1 and the
                  continuation timed alone (medians of 6) with their lane
                  utilisation and budgets; split_bounce=3 and split_every
                  at 4 spp vs K1
 15 K9            the 1080p/64 spp frame with octant_bounce_walks: vs K1's
                  frame, launch counts, timed in turns with K1; K9 vs plain at
                  256x192 (both RNG flows) and 1080p/1 spp; K9's phase 1 and
                  continuation (split + octant walks) alone vs plain at 256x192
                  and 1080p (timed as in 14), and
                  its tiered instantiation (field 160x90) vs
                  plain; the K9 forms' budget and the walk-loop lane
                  utilisation of K9 (1080p/64 spp) and the tiered K9 (field
                  1080p/4 spp); then the split path
                  and the field path with octant walks at 1080p/4 spp, each
                  driven with its own launch counts, vs K1 / the tiered K1
 16 K5            wide_nodes: K5 closest/shadow vs plain and vs K2/K3 at the
                  demo's 1080p primary and light rays; the wide K1 vs plain
                  at 256x192 (both RNG flows) and 1080p/1 spp; the wide
                  and wide + octant K1's budget and lane utilisation at
                  1080p/64 spp; the golden gates with wide_nodes; the 1080p/64 spp wide frame vs K1's
                  frame, its launch counts, timed in turns with K1; the wide
                  + octant K1 once; the wide K1 on the field (tiered="off")
                  at 1080p/4 spp vs the whole-tree K1, in turns
 17 K6            frustum_primary: the same set for K6 (the standalone walk
                  on the 1080p waves in K1's warp tiles, bit for bit its
                  plain version, with its budget and lane utilisation) and
                  the frustum K1, plus the frustum phase 1 and frustum +
                  octant phase 1
                  (split_bounce 2) vs plain at 256x192 and 1080p (timed as
                  in 14), and the frustum + octant K1 once
 18 per-wave      K7 closest/shadow vs plain at 256x192 (bit for bit) and
                  the incoherent rays, vs plain at the
                  1080p primary and point-light rays, vs K2/K3 at the 1080p
                  primary, shadow and incoherent rays (other triangles
                  counted), timed in turns with them; the
                  7 K7 waves of one 1080p pallas-ml sample (5 closest, 2
                  shadow, recorded at the wrappers): the kernel and the plain
                  version bit for bit, the kernel timed alone (medians of
                  6), its lane utilisation, each wave's bound; the same for
                  the 7 K2/K3 waves of one 1080p pallas-bvh2 sample; K1
                  with sample_fuse=2 vs plain (256x192, 4 spp); the golden
                  gates for kernels="xla" and "pallas-ml"; "pallas-ml",
                  "pallas-bvh2", "pallas-nomega" and "xla" vs K1's frame at
                  256x192; the 1080p/64 spp frame with kernels="pallas-ml"
                  (3 dispatches in all: the warm-up; one timed, with launch
                  counts, K7 only, vs K1's frame; one with K7's own time
                  summed from CUDA events around each of its launches; and
                  one profiled 4-spp dispatch); "pallas-bvh2"
                  and "pallas-nomega" at 1080p/4 spp and "xla" at 1080p/1
                  spp once each, timed, with launch counts
 19 frame loop    the Renderer on the demo: cold start (an empty port cache)
                  and warm start (its hit), StartupTimer's steps; the 30
                  commands of scripts/interactive_1080p.py through
                  InteractiveSession at 1920x1080, 1 spp, fps and light
                  overlays, synchronously (every frame bit for bit
                  render_radiance_with_stats + composite_core of its camera,
                  toggles and FPS value, rays equal; ms per command), with
                  pipeline=3 (ms/frame), and 24 render_frame_async under
                  CUDA's sync debug mode "error" with one resolve (ms/frame,
                  no synchronising call); progressive 800x600, 64 spp x 16
                  frames (the accumulator vs the running mean of the same
                  frames, max abs <= 1e-6); preview frames at 1080p on K7
                  (320x180 vs the plain preview, max abs <= 1e-6); the field
                  chunked (tiered="off", 3 chunks) at 320x180, 1 spp vs the
                  single-tree K1 (golden bars, rays within 0.1%) and timed
                  at 1080p/1 spp; launches per frame of each path
 20 last modules  deforming meshes: scripts/deform_demo.py's scene (a 48x48
                  wave grid and two Suzannes, 6,544 triangles, its displace in
                  torch) at 1920x1080, spp 2, 4 bounces: the LBVH on the card
                  vs the plain CPU build (bit for bit, also on a 256x256
                  grid), K1 vs its plain version at 256x192, K2/K3 on the
                  deform tables vs brute force at the 1080p primary rays, 8
                  animated frames under CUDA's sync debug mode "error" (1 K1
                  launch each), LBVH build and frame times at both sizes,
                  the tables and K1 alone, one LBVH build and one frame
                  under torch.profiler (device operations, busy share);
                  tiled frames: make_mesh(), the 1080p/64 spp frame over 1, 3
                  and 7 tiles on cuda:0 bit for bit the single-device frame
                  (rays equal), the dispatch timed in turns with it,
                  Renderer.multi_chip; the native builder: the C++ BLAS vs
                  the numpy builder (monkey, the 131k grid) with build times,
                  the demo's cold start with and without it in turns
 21 last functions
                  on the demo scene: traverse_scene vs brute_force_scene and
                  vs K2 on 4,096 random rays (same triangle, t within 1e-6
                  relative), traverse_blas over a monkey's BLAS vs the float64
                  brute_force_closest_hit, save_bvh / load_bvh and write_ppm /
                  read_ppm round trips, ref_rand on the card bit for bit its
                  CPU result, build_scene_tlas from the card's arrays equal
                  to the CPU pack's
Before the card's name and the kernels line, one JSON line gives each
phase's wall seconds ("phase_seconds") and the total.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_R05_RAYS = 351_031_968  # BENCH_r05: rays per 1080p/64 spp dispatch (f32-summed)

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor
# FLOP/s; the bound of a call is the larger of its bytes and its operations
# over these.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
# fp32 operations per walk step, read from csrc/common.cuh: a node visit is
# two slab tests (per box 6 subtracts, 6 multiplies, 10 min/max, the final
# max and compare: 24) plus each box's pruning compare: 50; a triangle test
# is moller_trumbore (9 + 5 for h and a, 2 for |a| >= eps, 2 for the
# guarded reciprocal, 3 + 6 for s and u, 9 + 6 + 6 for q, v and t, 6 for the
# five bounds tests): 54. Shading is left out: the bound stays a lower one.
OPS_PER_NODE = 50
OPS_PER_TRI = 54
# A wide node visit (K5, walk.cuh wide_node): 8 slab tests and their 8
# pruning compares, 8 x (24 + 1) = 200 (the push sort, which runs only when
# two or more children are pushed, is left out). A frustum node visit (K6,
# frustum.cuh), counted once per packet: two interval box tests, each 3 axes
# x (4 subtracts, two interval products of 4 multiplies and 6 min/max, 4
# min/max for the axis and the running entry/exit) + 3 for the final tests
# = 87, so 174 (the frustum set-up and the t_max reductions are left out).
OPS_PER_NODE8 = 200
OPS_PER_PACKET_NODE = 174
# A miss-link node visit (K7, walk.cuh walk_closest_misslink): one slab test
# and its pruning compare, 25.
OPS_PER_ML_NODE = 25
# Phase 7 holds the 1080p/64 spp K1 frame to the plain version on every
# n-th column, n by RNG flow (the configured reference flow on more
# pixels: its subset's walk work also estimates K1's bound).
K1_PLAIN_STRIDE = {"reference": 8, "threefry": 16}


class PhaseFailed(Exception):
    pass


START = time.perf_counter()
PHASE_END = {}  # phase number -> seconds since the start at its last line


def say(msg: str) -> None:
    """A phase line ("[N ...] ..."), stamped with the seconds since the
    script started."""
    now = time.perf_counter() - START
    head = msg[1:].split(" ", 1)[0]
    if msg.startswith("[") and head.isdigit():
        PHASE_END[int(head)] = now
    print(f"{msg} [{now:.0f} s]", flush=True)


def phase_seconds() -> dict:
    """Each phase's wall seconds: from the previous phase's last line to
    its own last line (phase 1 from the start)."""
    out, prev = {}, 0.0
    for n in sorted(PHASE_END):
        out[str(n)] = round(PHASE_END[n] - prev, 1)
        prev = PHASE_END[n]
    return out


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def build_field_scene(width: int, height: int, n_instances: int = 520):
    """The Suzanne field of scripts/bench_large.py:68-102 (field branch; 968
    triangles per instance, 503,360 in all at 520), in the port's scene
    model."""
    import math

    import numpy as np
    from rayzen_tpu_torch.camera import Camera
    from rayzen_tpu_torch.demo import ASSET_DIR
    from rayzen_tpu_torch.light import Light
    from rayzen_tpu_torch.material import Material
    from rayzen_tpu_torch.mesh import Mesh
    from rayzen_tpu_torch.scene import GameObject, Scene
    from rayzen_tpu_torch.transforms import rotation, translation

    monkey = Mesh.load_from_obj(os.path.join(ASSET_DIR, "monkey.obj"), 0)
    side = int(math.ceil(math.sqrt(n_instances)))
    objs = []
    for i in range(n_instances):
        gx, gz = i % side, i // side
        objs.append(
            GameObject(
                mesh=monkey,
                transform=translation(
                    (2.2 * (gx - side / 2), 0.0, -2.2 * gz)
                ) @ rotation(math.radians((i * 37.0) % 360.0), (0.0, 1.0, 0.0)),
                material_override=i % 3,
            )
        )
    return Scene(
        camera=Camera(
            position=np.array([0.0, 6.0, 8.0], np.float32),
            target=np.array([0.0, -0.45, -0.89], np.float32),
            aspect_ratio=width / height,
        ),
        materials=[
            Material(albedo=(0.8, 0.2, 0.2), metallic=0.1, roughness=0.4),
            Material(albedo=(0.2, 0.8, 0.3), metallic=0.9, roughness=0.25),
            Material(albedo=(0.9, 0.9, 0.9), metallic=1.0, roughness=0.05,
                     reflectivity=1.0),
        ],
        lights=[
            Light(position_or_direction=(5.0, 10.0, 5.0, 1.0),
                  color=(1.0, 1.0, 1.0), power=300.0),
            Light(position_or_direction=(0.8, 1.4, 0.3, 0.0),
                  color=(1.0, 1.0, 1.0), power=2.0),
        ],
        game_objects=objs,
    )


def cuda_ms(fn, reps: int, torch):
    """Per-call device time of fn() in ms (CUDA events), after one warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn, torch):
    """(fn(), its device time in ms) for one call, timed with CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def counted(fn, torch, walk):
    """(fn(work), its device time in ms, the counts of the walk.Work that fn
    passes to its plain walks)."""
    work = walk.Work()
    out, ms = timed(lambda: fn(work), torch)
    return out, ms, work.counts()


def bound(work, nbytes):
    """(bound_ms, bound_by): the least time for a call that moves ``nbytes``
    and whose walks do ``work`` (walk.Work's node visits and triangle
    tests), at the published H100 peaks."""
    ops = (OPS_PER_NODE * work["nodes"] + OPS_PER_NODE8 * work["nodes8"]
           + OPS_PER_PACKET_NODE * work["packet_nodes"]
           + OPS_PER_ML_NODE * work["ml_nodes"] + OPS_PER_TRI * work["tris"])
    t_ops, t_bytes = ops / FP32_OPS_S, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*xs):
    """Bytes of tensors, or of (rays, bytes per ray) pairs."""
    return sum(x[0] * x[1] if isinstance(x, tuple) else x.numel() * x.element_size()
               for x in xs)


def profile_dispatch(fn, torch, trace_path):
    """Wall time, summed device kernel time and the kernels (ms, name,
    count), largest first, of one call of fn() under torch.profiler (trace
    written to trace_path, if given). The "aten::" rows carry their kernels'
    device time as well, so only the kernel rows are summed."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if trace_path:
        prof.export_chrome_trace(trace_path)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and not e.key.startswith("aten::"):
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows), rows


# scripts/interactive_1080p.py's command mix (moves, looks, BVH toggles, a
# click pick) and its device-rate moves
INTERACTIVE_COMMANDS = [
    "w", "w", "w 0.3", "look 40 0", "d", "d 0.3", "look 60 -10",
    "a", "s 0.4", "look -80 5", "w", "w", "b",
    "look 30 0", "w 0.2", "n",
    "click 960 540", "look -30 10", "b",
    "w", "a 0.3", "look 20 -5", "w", "w 0.25", "look -15 0", "s",
    "d", "look 10 5", "w", "w",
]
DEVRATE_MOVES = ["w 0.05", "look 5 0", "d 0.05", "look -5 0"]
# phase 19's frame sizes: the interactive session and the timed preview,
# progressive, the preview check, the chunked check and the timed chunked
# frame; and the field's chunk budget (503,360 triangles -> 3 chunks)
FRAME_LOOP_SIZES = dict(interactive=(1920, 1080), progressive=(800, 600),
                        preview_check=(320, 180), chunked=(320, 180),
                        chunked_timed=(1920, 1080))
FIELD_CHUNK_TRIS = 200_000


def frame_loop_phase(torch, np, dev, fscene, whole_field, out_dir):
    """Phase 19: the frame loop (renderer.Renderer) and the interactive
    session on the card. Start-up (cold: an empty port cache, the kernels
    already built; warm: the cache hit), the interactive 1080p session of
    scripts/interactive_1080p.py (sync, every frame held bit for bit to
    render_radiance_with_stats + composite_core with its camera, flags and
    FPS value, rays equal; pipelined; the device-rate pass under CUDA's
    sync debug mode "error"), progressive accumulation to 1,024 spp
    (scripts/progressive_1024.py) against the running mean of the same
    frames, preview frames on K7 (held to the plain preview at 320x180) and
    the chunked field (tiered="off", >= 3 chunks) against the single-tree
    K1. Returns the numbers and launch counts per frame."""
    import io
    import shutil
    import tempfile

    from rayzen_tpu_torch import bigscene, cache, ext, packing
    from rayzen_tpu_torch import preview as preview_mod
    from rayzen_tpu_torch.config import RenderConfig
    from rayzen_tpu_torch.demo import build_demo_scene
    from rayzen_tpu_torch.image_io import ssim
    from rayzen_tpu_torch.integrator import render_radiance_with_stats
    from rayzen_tpu_torch.interactive import InteractiveSession
    from rayzen_tpu_torch.ops.traverse import traverse_world
    from rayzen_tpu_torch.overlay import build_overlay_inputs, camera_view_proj, composite_core
    from rayzen_tpu_torch.packing import pack_scene
    from rayzen_tpu_torch.renderer import Renderer

    def launched():
        return {k: v for k, v in ext.LAUNCHES.items() if v}

    def median(xs):
        return statistics.median(xs)

    out = {}
    cache_dir = tempfile.mkdtemp(prefix="rayzen_frame_loop_")
    try:
        # -- start-up: cold (empty port cache, the kernels built) and warm --
        iw, ih = FRAME_LOOP_SIZES["interactive"]
        icfg = RenderConfig(width=iw, height=ih, spp=1, max_bounces=5,
                            show_fps_overlay=True, debug_show_lights=True,
                            cache_dir=cache_dir)
        starts = {}
        for name in ("cold", "warm"):
            packing._blas_cache.clear()
            scene = build_demo_scene(iw, ih)
            hit = os.path.exists(cache.scene_cache_path(scene, icfg))
            require(hit == (name == "warm"), f"{name} start: cache file present {hit}")
            t0 = time.perf_counter()
            r = Renderer(scene, icfg, async_compile=False, device=dev)
            t1 = time.perf_counter()
            r.warmup(2)
            t2 = time.perf_counter()
            require(r.path_tracer_ready and not r.path_tracer_failed,
                    f"{name} start: the path tracer is not ready")
            starts[name] = dict(
                steps_ms=dict(r.startup_steps), renderer_ms=(t1 - t0) * 1e3,
                warmup_2_ms=(t2 - t1) * 1e3, total_ms=(t2 - t0) * 1e3)
        out["startup"] = starts
        say(f"[19 frame loop] start-up, demo {iw}x{ih} (kernels built in phase 2): "
            + "; ".join(f"{n}: renderer {v['renderer_ms']:.1f} ms ("
                        + ", ".join(f"{k} {ms:.1f} ms" for k, ms in v["steps_ms"].items())
                        + f"), warmup(2) {v['warmup_2_ms']:.1f} ms"
                        for n, v in starts.items()))

        # -- the interactive 1080p session, synchronous, every frame held --
        sess = InteractiveSession(r, out_path=None, status=io.StringIO())
        records, rays_seen = [], {}
        real_render_frame, real_readback = r.render_frame, r._readback

        def readback(img, rays):
            o, n = real_readback(img, rays)
            rays_seen["n"] = n
            return o, n

        def render_frame(mode="auto"):
            snap = dict(cam=r._camera_params(), cfg=r.cfg, arrays=r.arrays,
                        fps=r.profiler.fps_ema or 0.0, index=r.frame_index)
            frame = real_render_frame(mode)
            records.append(dict(snap, frame=frame, rays=rays_seen["n"]))
            return frame

        r._readback, r.render_frame = readback, render_frame
        ext.reset_launches()
        t0 = time.perf_counter()
        sess.run(iter([]))  # the first frame, before any command
        first_ms = (time.perf_counter() - t0) * 1e3
        cmd_ms = []
        for cmd in INTERACTIVE_COMMANDS:
            t0 = time.perf_counter()
            sess.handle(cmd)
            cmd_ms.append((time.perf_counter() - t0) * 1e3)
        sync_launches = launched()
        del r._readback, r.render_frame  # back to the class's methods
        require(len(records) == 1 + len(INTERACTIVE_COMMANDS), "a command rendered no frame")
        require(sync_launches == {"sample_wave": len(records)},
                f"sync session launches {sync_launches}")
        picks = [ln for ln in sess.status.getvalue().splitlines()
                 if ln.startswith("pick:")]
        require(len(picks) == 1, "the click ran no pick")
        for i, rec in enumerate(records):
            cfg = rec["cfg"]
            first = rec["index"] == 0 and not cfg.accumulate
            img, rays = render_radiance_with_stats(
                rec["arrays"], rec["cam"], cfg, max_bounces=1 if first else None)
            if cfg.debug_show_bvh or cfg.debug_show_lights or cfg.show_fps_overlay:
                (tc, tcol, tm, ut), (bc, bcol, bm, ub) = build_overlay_inputs(
                    rec["arrays"], cfg)
                img = composite_core(
                    img, tc, tcol, tm, bc, bcol, bm, camera_view_proj(rec["cam"]),
                    rec["arrays"].lights, rec["fps"], use_t=ut, use_b=ub,
                    show_lights=cfg.debug_show_lights,
                    show_fps=cfg.show_fps_overlay, width=cfg.width,
                    height=cfg.height)
            require(np.array_equal(img.cpu().numpy(), rec["frame"]),
                    f"session frame {i} differs from render + composite")
            require(int(rays) == rec["rays"], f"session frame {i}: rays "
                    f"{rec['rays']} vs {int(rays)}")
        out["interactive"] = dict(
            first_frame_ms=first_ms, ms_per_command=cmd_ms,
            median_ms_per_command=median(cmd_ms), mean_ms_per_command=float(np.mean(cmd_ms)),
            k1_launches_per_frame=sync_launches.get("sample_wave", 0) / len(records))
        say(f"[19 frame loop] interactive {iw}x{ih}, 1 spp, 5 bounces, fps + light "
            f"overlays, sync: {len(records)} frames bit for bit render + composite, "
            f"rays equal; first frame {first_ms:.1f} ms, per command median "
            f"{median(cmd_ms):.2f} ms, mean {np.mean(cmd_ms):.2f} ms, max "
            f"{max(cmd_ms):.2f} ms; K1 launches per frame "
            f"{out['interactive']['k1_launches_per_frame']:.2f}; {picks[0]}")
        say("[19 frame loop] ms per command: " + ", ".join(
            f"{c!r} {ms:.1f}" for c, ms in zip(INTERACTIVE_COMMANDS, cmd_ms)))

        # -- pipelined (3 frames in flight) --
        hist0 = len(r.profiler.history)
        t0 = time.perf_counter()
        n_pipe = sess.run(iter(INTERACTIVE_COMMANDS), pipeline=3)
        pipe_ms = (time.perf_counter() - t0) / n_pipe * 1e3
        pipe_lat = [h["total"] for h in r.profiler.history[hist0:]]
        out["pipelined"] = dict(frames=n_pipe, ms_per_frame=pipe_ms,
                                median_latency_ms=median(pipe_lat))
        say(f"[19 frame loop] pipelined (pipeline=3): {n_pipe} frames, "
            f"{pipe_ms:.2f} ms/frame, dispatch-to-resolve median {median(pipe_lat):.2f} ms")

        # -- device rate: 24 dispatches, one resolve, no synchronising call --
        torch.cuda.synchronize()
        ext.reset_launches()
        pfs = []
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(24):
                sess._apply(DEVRATE_MOVES[i % len(DEVRATE_MOVES)])
                pfs.append(r.render_frame_async())
        except RuntimeError as e:
            raise PhaseFailed(f"render_frame_async made a synchronising call: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        pfs[-1].resolve()
        dev_ms = (time.perf_counter() - t0) / 24 * 1e3
        dev_launches = launched()
        require(dev_launches == {"sample_wave": 24}, f"device-rate launches {dev_launches}")
        out["device_rate"] = dict(frames=24, ms_per_frame=dev_ms)
        say(f"[19 frame loop] device rate: 24 render_frame_async under sync debug "
            f"mode 'error' (no synchronising call), one resolve: {dev_ms:.2f} ms/frame; "
            f"launches {dev_launches}")

        # -- progressive: 800x600, 64 spp a frame, 16 frames = 1,024 spp --
        pw, ph = FRAME_LOOP_SIZES["progressive"]
        pcfg = RenderConfig(width=pw, height=ph, spp=64, max_bounces=5,
                            accumulate=True, cache_dir=cache_dir)
        pr = Renderer(build_demo_scene(pw, ph), pcfg, async_compile=False,
                      device=dev)
        ext.reset_launches()
        prog_ms = []
        for _ in range(16):
            t0 = time.perf_counter()
            acc = pr.render_frame(mode="pt")
            prog_ms.append((time.perf_counter() - t0) * 1e3)
        prog_launches = launched()
        require(prog_launches == {"sample_wave": 16}, f"progressive launches {prog_launches}")
        pcam = pr._camera_params()
        mean = None
        for k in range(16):
            f = render_radiance_with_stats(pr.arrays, pcam, pcfg, rng_key=k)[0].double()
            mean = f if mean is None else mean + (f - mean) / (k + 1)
        prog_err = (torch.from_numpy(acc).to(dev).double() - mean).abs().max().item()
        require(prog_err <= 1e-6, f"progressive accumulator vs running mean {prog_err:.3e}")
        out["progressive"] = dict(frames=16, spp=1024, ms_per_frame=prog_ms,
                                  median_ms_per_frame=median(prog_ms),
                                  max_abs_vs_running_mean=prog_err)
        say(f"[19 frame loop] progressive {pw}x{ph}, 64 spp x 16 frames = 1024 spp: "
            f"median {median(prog_ms):.2f} ms/frame (first {prog_ms[0]:.2f}); "
            f"accumulator vs the running mean of the rng_key=k frames max abs "
            f"{prog_err:.3e}")

        # -- preview: 1080p on K7, held to the plain preview at 320x180 --
        ext.reset_launches()
        r.render_frame(mode="preview")
        prev_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            r.render_frame(mode="preview")
            prev_ms.append((time.perf_counter() - t0) * 1e3)
        prev_launches = launched()
        require(prev_launches == {"closest_hit_misslink": 6},
                f"preview launches {prev_launches}")
        sw, sh = FRAME_LOOP_SIZES["preview_check"]
        scfg = icfg.replace(width=sw, height=sh)
        sscene = build_demo_scene(sw, sh)
        sarrays = pack_scene(sscene, scfg, dev)
        scam = sscene.camera.device_params()
        kimg = preview_mod.render_preview(sarrays, scam, scfg)
        real_hit = preview_mod.primary_hit
        preview_mod.primary_hit = lambda ws, o, d, a, c: traverse_world(ws, o, d, a)
        try:
            pimg = preview_mod.render_preview(sarrays, scam, scfg)
        finally:
            preview_mod.primary_hit = real_hit
        prev_err = (kimg - pimg).abs().max().item()
        require(prev_err <= 1e-6, f"K7 preview vs plain max abs {prev_err:.3e}")
        out["preview"] = dict(ms_per_frame=prev_ms, median_ms_per_frame=median(prev_ms),
                              k7_launches_per_frame=6 / 6, max_abs_vs_plain_320x180=prev_err)
        say(f"[19 frame loop] preview {iw}x{ih} on K7: median {median(prev_ms):.2f} ms "
            f"per frame (render_frame, readback included); {sw}x{sh} vs the plain "
            f"preview (traverse_world) max abs {prev_err:.3e}")

        # -- chunked: the field, tiered="off", >= 3 chunks --
        cw, ch = FRAME_LOOP_SIZES["chunked"]
        ccfg = RenderConfig(width=cw, height=ch, spp=1, max_bounces=5, tiered="off",
                            chunk_tris=FIELD_CHUNK_TRIS, cache_dir=cache_dir)
        cr = Renderer(fscene, ccfg, async_compile=False, use_cache=False,
                      device=dev)
        n_chunks = len(cr.arrays_list or ())
        require(n_chunks >= 3, f"the field cut into {n_chunks} chunks")
        fcam = fscene.camera.device_params()
        cr.render_frame(mode="pt")  # frame 0: the first-frame budget
        ext.reset_launches()
        cframe = cr.render_frame(mode="pt")
        chunk_launches = launched()
        cimg, crays = bigscene.render_radiance_chunked(cr.arrays_list, fcam, ccfg,
                                                       with_stats=True)
        require(np.array_equal(cimg.cpu().numpy(), cframe),
                "the Renderer's chunked frame differs from render_radiance_chunked")
        simg, srays = render_radiance_with_stats(whole_field, fcam, ccfg)
        cn, sn = cimg.cpu().numpy(), simg.cpu().numpy()
        c_ssim, c_mean = ssim(cn, sn), float(np.abs(cn - sn).mean())
        c_rays = abs(int(crays) - int(srays)) / int(srays)
        require(c_ssim >= 0.995 and c_mean < 2e-3 and c_rays <= 1e-3,
                f"chunked vs single-tree K1: SSIM {c_ssim:.4f}, mean abs {c_mean:.3e}, "
                f"rays {int(crays)} vs {int(srays)}")
        require(set(chunk_launches) == {"closest_hit_bvh2", "shadow_walk_bvh2"},
                f"chunked launches {chunk_launches}")
        tw, th = FRAME_LOOP_SIZES["chunked_timed"]
        c1080 = ccfg.replace(width=tw, height=th)
        bigscene.render_radiance_chunked(cr.arrays_list, fcam, c1080, with_stats=True)
        chunk_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, r1080 = bigscene.render_radiance_chunked(cr.arrays_list, fcam, c1080,
                                                        with_stats=True)
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
        out["chunked"] = dict(chunks=n_chunks, launches_per_frame=chunk_launches,
                              ssim=c_ssim, mean_abs=c_mean, rays=int(crays),
                              single_tree_rays=int(srays), ms_1080p_1spp=chunk_ms,
                              median_ms_1080p_1spp=median(chunk_ms))
        say(f"[19 frame loop] chunked field (tiered='off', {n_chunks} chunks of <= "
            f"{FIELD_CHUNK_TRIS} triangles), {cw}x{ch} 1 spp: vs the single-tree K1 SSIM "
            f"{c_ssim:.6f}, mean abs {c_mean:.3e}, rays {int(crays)} vs {int(srays)}; "
            f"launches per frame {chunk_launches}; {tw}x{th} 1 spp median "
            f"{median(chunk_ms):.1f} ms per frame ({int(r1080)} rays)")
        if out_dir:
            with open(os.path.join(out_dir, "frame_loop.json"), "w") as f:
                json.dump(out, f, indent=1)
        return out
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


# the deforming scene of scripts/deform_demo.py: a g x g water grid over
# [-3, 3]^2 and two Suzannes at 0.6 scale (6,544 triangles at g = 48)
DEFORM_GRID = 48
DEFORM_BIG_GRID = 256  # 131,072 grid triangles + the two Suzannes
DEFORM_SIZE = (1920, 1080)  # the demo's config (spp 2, 4 bounces) at 1080p
DEFORM_CHECK_SIZE = (256, 192)  # K1 vs its plain version
DEFORM_FRAMES = 8  # animated frames under the sync debug mode "error"
MULTI_CHIP_SIZE = (1920, 1080)  # Renderer.multi_chip's frame (1 spp)


def deform_geometry(np, g: int):
    """scripts/deform_demo.py base_geometry at grid size ``g``: (T, 3, 3)
    float32 triangles (the grid in the demo's loop order, then the two
    Suzannes) and their (T,) int32 materials."""
    from rayzen_tpu_torch.demo import ASSET_DIR
    from rayzen_tpu_torch.mesh import Mesh

    xs = np.linspace(-3.0, 3.0, g + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    p = np.stack([gx, np.zeros_like(gx), gz], -1)
    a, b, c, d = p[:-1, :-1], p[1:, :-1], p[1:, 1:], p[:-1, 1:]
    grid = np.stack([np.stack([a, b, c], 2), np.stack([a, c, d], 2)], 2).reshape(-1, 3, 3)
    parts, mats = [grid], [np.zeros(len(grid), np.int32)]
    monkey = Mesh.load_from_obj(os.path.join(ASSET_DIR, "monkey.obj"), 0)
    for k, x in enumerate((-1.2, 1.2)):
        parts.append(monkey.vertices * 0.6 + np.asarray([x, 0.8, 0.0], np.float32))
        mats.append(np.full(monkey.num_triangles, 1 + k, np.int32))
    return np.concatenate(parts).astype(np.float32), np.concatenate(mats)


def displace(torch, verts, t: float):
    """scripts/deform_demo.py displace in torch: a travelling wave on every
    vertex below y = 0.5 and a bob above (the Suzannes ride the swell)."""
    import math

    x, y, z = verts.unbind(-1)
    wave = 0.25 * torch.sin(1.7 * x + 2.3 * t) * torch.cos(1.3 * z + 1.1 * t)
    y = torch.where(y < 0.5, y + wave, y + 0.3 * math.sin(2.3 * t))
    return torch.stack([x, y, z], -1)


def deform_sharded_native_phase(torch, np, dev, mcfg, marrays, mcam, main_ms,
                                k1_ms, out_dir):
    """Phase 20: the last modules. Deform: the demo of
    scripts/deform_demo.py at 1080p (the LBVH on the card vs the plain CPU
    build, K1 vs its plain version at 256x192, K2/K3 on the deform tables vs
    brute force at the 1080p primary rays, 8 animated frames under the sync
    debug mode "error", build and frame times at the demo's size and on a
    256 x 256 grid, the tables and K1 alone, one build and one frame under
    torch.profiler). Sharded: make_mesh, the main path's frame tiled over
    cuda:0 (1, 3 and 7 tiles) vs the single-device frame, the dispatch
    timed in turns with it, Renderer.multi_chip. Native: the C++ BLAS vs
    the numpy builder on the monkey and the 131k grid, with build times,
    and the demo Renderer's cold start with and without it, in turns.
    Returns the numbers and launch counts."""
    import shutil
    import tempfile

    from rayzen_tpu_torch import ext, packing
    from rayzen_tpu_torch.accel import builder, native
    from rayzen_tpu_torch.accel.lbvh import lbvh_for_triangles
    from rayzen_tpu_torch.camera import Camera
    from rayzen_tpu_torch.config import RenderConfig
    from rayzen_tpu_torch.deform import render_deforming, world_from_deforming
    from rayzen_tpu_torch.demo import ASSET_DIR, build_demo_scene
    from rayzen_tpu_torch.image_io import ssim
    from rayzen_tpu_torch.integrator import render_radiance_with_stats
    from rayzen_tpu_torch.light import Light, pack_lights
    from rayzen_tpu_torch.material import Material, pack_materials
    from rayzen_tpu_torch.mesh import Mesh
    from rayzen_tpu_torch.ops import megakernel, traverse, walk
    from rayzen_tpu_torch.ops.camera_rays import pixel_grid
    from rayzen_tpu_torch.parallel import make_mesh, render_radiance_sharded
    from rayzen_tpu_torch.renderer import Renderer

    def launched():
        return {k: v for k, v in ext.LAUNCHES.items() if v}

    out = {}
    # -- deform: the demo's scene, camera and config --
    verts0, tri_mat = deform_geometry(np, DEFORM_GRID)
    materials = torch.from_numpy(pack_materials([
        Material(albedo=(0.2, 0.45, 0.7), metallic=0.05, roughness=0.15,
                 reflectivity=0.6),
        Material(albedo=(0.85, 0.5, 0.2), metallic=0.2, roughness=0.5),
        Material(albedo=(0.9, 0.9, 0.95), metallic=1.0, roughness=0.1,
                 reflectivity=1.0)])).to(dev)
    lights = torch.from_numpy(pack_lights([
        Light.point((4.0, 6.0, 4.0), power=220.0),
        Light.directional((0.5, 1.2, 0.3), power=1.5)])).to(dev)
    W, H = DEFORM_SIZE

    def camera(w, h):
        return Camera(position=np.array([0.0, 2.6, 5.0], np.float32),
                      target=np.array([0.0, -0.4, -0.9], np.float32),
                      aspect_ratio=w / h).device_params()

    dcfg = RenderConfig(width=W, height=H, spp=2, max_bounces=4)
    base = torch.from_numpy(verts0).to(dev)
    mat_d = torch.from_numpy(tri_mat).to(dev)
    require(base.shape[0] == 6544, f"deform demo: {base.shape[0]} triangles")

    # the LBVH on the card vs the plain CPU build, bit for bit
    v_demo = displace(torch, base, 0.35)
    big0, big_mat = deform_geometry(np, DEFORM_BIG_GRID)
    v_big = displace(torch, torch.from_numpy(big0).to(dev), 0.35)
    lbvh = {}
    for name, v in (("demo", v_demo), ("grid256", v_big)):
        t0 = time.perf_counter()
        cpu = lbvh_for_triangles(v.cpu())
        cpu_s = time.perf_counter() - t0
        gpu = lbvh_for_triangles(v)
        same = all(torch.equal(cpu[k], gpu[k].cpu()) for k in cpu)
        build_ms = cuda_ms(lambda: lbvh_for_triangles(v), 5, torch)
        lbvh[name] = dict(triangles=int(v.shape[0]), depth=int(gpu["max_depth"]),
                          bitwise_cpu=same, build_ms=build_ms, cpu_build_s=cpu_s)
        say(f"[20 deform] LBVH {name}, {v.shape[0]} triangles: card == plain CPU "
            f"build bit for bit {same}; depth {lbvh[name]['depth']}; build "
            f"{build_ms:.3f} ms on the card (CPU {cpu_s:.2f} s)")
        require(same, f"the LBVH on the card differs from the CPU build ({name})")
    # one demo build under the profiler: its device operations and busy time
    lwall, lbusy, lrows = profile_dispatch(lambda: lbvh_for_triangles(v_demo),
                                           torch, None)
    lops = sum(r[2] for r in lrows)
    lbvh["demo"].update(profiled_wall_ms=lwall, profiled_busy_ms=lbusy,
                        device_ops=lops)
    say(f"[20 deform] one LBVH build of the demo under torch.profiler: wall "
        f"{lwall:.2f} ms, device busy {lbusy:.3f} ms ({100 * lbusy / lwall:.1f}%), "
        f"{lops} device operations; the unprofiled build's "
        f"{lbvh['demo']['build_ms']:.3f} ms is {lbvh['demo']['build_ms'] / lops * 1e3:.1f}"
        f" us an operation")
    out["lbvh"] = lbvh

    # K1 vs its plain version at 256x192 (the same tables on the card)
    cw, ch = DEFORM_CHECK_SIZE
    ccfg = dcfg.replace(width=cw, height=ch)
    ccam = camera(cw, ch)
    kimg, krays = render_deforming(v_demo, mat_d, materials, lights, ccam, ccfg,
                                   with_stats=True)
    ws = world_from_deforming(v_demo, mat_d, materials, lights)
    _, cuv = pixel_grid(cw, ch, dev)
    cact = torch.ones(cuv.shape[0], dtype=torch.bool, device=dev)
    psum, prays = megakernel.sample_wave_reference(
        ws, ccfg.replace(sample_fuse=1), cuv, cact, ccam, 0, 0, 4, n_samples=2)
    pimg = torch.clamp(psum / 2.0, 0.0, 1.0).reshape(ch, cw, 3)
    bitwise = bool(torch.equal(kimg, pimg))
    c_ssim = ssim(kimg.cpu().numpy(), pimg.cpu().numpy())
    c_mean = (kimg - pimg).abs().mean().item()
    c_max = (kimg - pimg).abs().max().item()
    held = "bit for bit" if bitwise else "SSIM, mean abs and max abs bars"
    say(f"[20 deform] K1 vs plain K1, {cw}x{ch}, spp 2, 4 bounces: bit for bit "
        f"{bitwise}; SSIM {c_ssim:.6f}, mean abs {c_mean:.3e}, max abs "
        f"{c_max:.3e}; rays {int(krays)} vs {int(prays)} ({held} held)")
    require(bitwise or (c_ssim >= 0.995 and c_mean < 2e-3 and c_max <= 1e-5),
            "deform K1 vs plain (SSIM >= 0.995, mean abs < 2e-3, max abs <= 1e-5)")
    require(abs(int(krays) - int(prays)) <= 0.001 * int(prays), "deform K1 rays")
    out["k1_vs_plain"] = dict(bitwise=bitwise, ssim=c_ssim, mean_abs=c_mean,
                              max_abs=c_max, held=held, rays=int(krays), plain_rays=int(prays))

    # K2/K3 on the deform tables vs brute force at the 1080p primary rays
    dcam = camera(W, H)
    ws = world_from_deforming(v_demo, mat_d, materials, lights)
    _, muv = pixel_grid(W, H, dev)
    z = torch.zeros_like(muv[:, 0])
    ray = megakernel._raygen_tiles(muv[:, 0], muv[:, 1], z, z,
                                   megakernel._pack_camera(dcam, dev))
    o, d = torch.stack(ray[:3], 1), torch.stack(ray[3:], 1)
    act = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    ext.reset_launches()
    hit = walk.closest_hit_bvh2(ws, o, d, act, width=W, height=H)
    point = lights[0, :3]
    lv = point - hit.point
    dist = torch.clamp_min(lv.norm(dim=1), 0.001)
    ld = lv / dist[:, None]
    so = hit.point + ld * 0.001
    vis, _ = walk.shadow_walk_bvh2(ws, so, ld, dist, hit.found, width=W, height=H)
    check_launches = launched()
    step = 4096
    bt, btri, bvis = [], [], []
    transp = ws.materials[ws.tri_mat.long(), 6][None]
    for s in range(0, o.shape[0], step):
        t, _ = traverse._against_all(ws, o[s:s + step], d[s:s + step])
        k = t.argmin(dim=1)
        bt.append(t.gather(1, k[:, None])[:, 0])
        btri.append(k)
        t2, h2 = traverse._against_all(ws, so[s:s + step], ld[s:s + step])
        blocking = h2 & (t2 >= 1e-3) & (t2 < dist[s:s + step, None])
        bvis.append(torch.where(blocking, torch.where(transp > 0, transp, 0.0),
                                1.0).prod(dim=1))
    bt, btri, bvis = torch.cat(bt), torch.cat(btri), torch.cat(bvis)
    bfound = bt < traverse.T_FAR
    btri = torch.where(bfound, btri, -1)
    bvis = torch.where(hit.found, bvis, 1.0)
    same_found = (bfound == hit.found).float().mean().item()
    same_tri = (btri == hit.tri.long()).float().mean().item()
    both = bfound & hit.found & (btri == hit.tri.long())
    t_rel = ((hit.t - bt).abs() / bt.abs()).masked_fill(~both, 0).max().item()
    vis_same = (vis == bvis).float().mean().item()
    say(f"[20 deform] K2 vs brute force, {W}x{H} primary rays on the deform tables: "
        f"same hit/miss {same_found * 100:.4f}%, same triangle {same_tri * 100:.4f}%, "
        f"t max rel err {t_rel:.3e} ({int(hit.found.sum())} hits); K3 toward the "
        f"point light: same visibility {vis_same * 100:.4f}%; launches {check_launches}")
    require(same_found >= 0.9999 and same_tri >= 0.9999 and t_rel <= 1e-5,
            "K2 on the deform tables vs brute force")
    require(vis_same >= 0.9999, "K3 on the deform tables vs brute force")
    out["k2k3_vs_brute"] = dict(same_found=same_found, same_tri=same_tri,
                                t_max_rel_err=t_rel, k3_same_vis=vis_same,
                                launches=check_launches)

    # a deforming frame's two parts alone (CUDA events, 5 calls each): the
    # tables (LBVH included) as render_deforming builds them for K1, and K1
    # on them with render_deforming's arguments
    def tables():
        return world_from_deforming(v_demo, mat_d, materials, lights,
                                    with_records=False)

    ws_k1 = tables()
    tables_ms = cuda_ms(tables, 5, torch)
    k1_deform_ms = cuda_ms(lambda: megakernel.sample_wave(
        ws_k1, dcfg.replace(sample_fuse=1), muv, act, dcam, 0, 0, 4, n_samples=2),
        5, torch)
    say(f"[20 deform] alone at {W}x{H}: the tables (LBVH included) {tables_ms:.3f} ms, "
        f"K1 (spp 2, 4 bounces) {k1_deform_ms:.3f} ms")
    out["alone"] = dict(tables_ms=tables_ms, k1_ms=k1_deform_ms)

    # 8 animated 1080p frames under the sync debug mode "error"
    def frames(base_, mat_, n, cfg_):
        render_deforming(displace(torch, base_, 0.0), mat_, materials, lights,
                         dcam, cfg_)  # warm
        torch.cuda.synchronize()
        ext.reset_launches()
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        imgs = []
        torch.cuda.set_sync_debug_mode("error")
        try:
            evs[0].record()
            for i in range(n):
                imgs.append(render_deforming(displace(torch, base_, i * 0.35), mat_,
                                             materials, lights, dcam, cfg_,
                                             with_stats=True))
                evs[i + 1].record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(n)]
        return imgs, ms, launched()

    imgs, frame_ms, flaunch = frames(base, mat_d, DEFORM_FRAMES, dcfg)
    finite = all(bool(torch.isfinite(im).all()) for im, _ in imgs)
    moved = all(not torch.equal(imgs[i][0], imgs[i + 1][0]) for i in range(len(imgs) - 1))
    rays = [int(r) for _, r in imgs]
    med = statistics.median(frame_ms)
    say(f"[20 deform] {DEFORM_FRAMES} animated frames {W}x{H}, spp 2, 4 bounces, "
        f"{base.shape[0]} triangles, under sync debug mode 'error' (no synchronising "
        f"call): median {med:.2f} ms a frame (the LBVH alone "
        f"{lbvh['demo']['build_ms']:.3f} ms), {rays[0] / med / 1e3:.1f} Mrays/s; "
        f"launches {flaunch}; finite "
        f"{finite}, every frame differs from the last {moved}")
    require(finite and moved, "deform frames")
    require(flaunch == {"sample_wave": DEFORM_FRAMES}, f"deform launches {flaunch}")
    bimgs, big_ms, blaunch = frames(torch.from_numpy(big0).to(dev),
                                    torch.from_numpy(big_mat).to(dev), 3, dcfg)
    require(all(bool(torch.isfinite(im).all()) for im, _ in bimgs), "256 grid frames")
    say(f"[20 deform] {DEFORM_BIG_GRID}x{DEFORM_BIG_GRID} grid ({big0.shape[0]} "
        f"triangles, depth "
        f"{lbvh['grid256']['depth']}): median {statistics.median(big_ms):.2f} ms a "
        f"{W}x{H} frame (the LBVH alone {lbvh['grid256']['build_ms']:.3f} ms); launches "
        f"{blaunch}")
    fwall, fbusy, frows = profile_dispatch(lambda: render_deforming(
        displace(torch, base, 0.7), mat_d, materials, lights, dcam, dcfg), torch, None)
    fops = sum(r[2] for r in frows)
    say(f"[20 deform] one demo frame under torch.profiler: wall {fwall:.2f} ms, device "
        f"busy {fbusy:.3f} ms ({100 * fbusy / fwall:.1f}%), {fops} device operations")
    out["frame_profiled"] = dict(wall_ms=fwall, busy_ms=fbusy, device_ops=fops)
    out["frames"] = dict(demo_ms=frame_ms, demo_median_ms=med, rays=rays,
                         launches=flaunch, grid256_ms=big_ms,
                         grid256_median_ms=statistics.median(big_ms),
                         k1_launches_per_frame=flaunch["sample_wave"] / DEFORM_FRAMES)

    # -- sharded: the main path's frame tiled over cuda:0 --
    mesh = make_mesh()
    require(mesh == [dev] * torch.cuda.device_count(), f"make_mesh() gave {mesh}")
    ref, ref_rays = render_radiance_with_stats(marrays, mcam, mcfg)
    sharded = {}
    for name, tiles in (("1 tile (make_mesh)", mesh[:1]), ("3 tiles", [dev] * 3),
                        ("7 tiles (padded)", [dev] * 7)):
        ext.reset_launches()
        img, rays = render_radiance_sharded(marrays, mcam, mcfg, tiles, with_stats=True)
        got = launched()
        same = bool(torch.equal(img, ref)) and int(rays) == int(ref_rays)
        sharded[name] = dict(tiles=len(tiles), bitwise=same, launches=got)
        require(same, f"sharded frame ({name}) differs from the single-device frame")
        require(got == {"sample_wave": len(tiles)}, f"sharded launches {got}")
    turns = {"single": [], "1 tile": [], "3 tiles": []}
    for _ in range(3):
        for name, tiles in (("single", None), ("1 tile", mesh[:1]), ("3 tiles", [dev] * 3)):
            fn = ((lambda: render_radiance_with_stats(marrays, mcam, mcfg)) if tiles is None
                  else (lambda t=tiles: render_radiance_sharded(marrays, mcam, mcfg, t)))
            turns[name].append(timed(fn, torch)[1])
    tmed = {k: statistics.median(v) for k, v in turns.items()}
    say(f"[20 sharded] {mcfg.width}x{mcfg.height}/{mcfg.spp} spp demo: tiled == single "
        f"bit for bit, rays equal "
        f"({', '.join(f'{k}: launches {v['launches']}' for k, v in sharded.items())}); "
        f"dispatch medians in turns: single {tmed['single']:.2f} ms, 1 tile "
        f"{tmed['1 tile']:.2f} ms, 3 tiles {tmed['3 tiles']:.2f} ms (phase 6 "
        f"{main_ms:.2f} ms, phase 7's K1 alone {k1_ms:.2f} ms)")
    cache_dir = tempfile.mkdtemp(prefix="rayzen_sharded_")
    try:
        rw, rh = MULTI_CHIP_SIZE
        rcfg = RenderConfig(width=rw, height=rh, spp=1, max_bounces=5,
                            cache_dir=cache_dir)
        single_r = Renderer(build_demo_scene(rw, rh), rcfg, async_compile=False,
                            use_cache=False, device=dev)
        multi_r = Renderer.multi_chip(build_demo_scene(rw, rh), rcfg,
                                      async_compile=False, use_cache=False)
        mf, sf = multi_r.render_frame(), single_r.render_frame()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    same_r = bool(np.array_equal(mf, sf))
    say(f"[20 sharded] Renderer.multi_chip over {multi_r.mesh}: {rw}x{rh} frame equals "
        f"the single-device Renderer's {same_r}")
    require(same_r and np.isfinite(mf).all(), "Renderer.multi_chip frame")
    out["sharded"] = dict(checks=sharded, turns_ms=turns, median_ms=tmed,
                          main_path_median_ms=main_ms, k1_alone_ms=k1_ms,
                          multi_chip_renderer_equal=same_r)

    # -- native: the C++ BLAS builder vs the numpy builder --
    require(native.available(), "the native runtime did not build")
    leaf = RenderConfig().leaf_size
    monkey = Mesh.load_from_obj(os.path.join(ASSET_DIR, "monkey.obj"))
    nat = {}
    grid131 = v_big[:DEFORM_BIG_GRID ** 2 * 2].cpu().numpy()  # the displaced grid
    for name, verts in (("monkey", monkey.vertices),
                        (f"{DEFORM_BIG_GRID}x{DEFORM_BIG_GRID} grid", grid131)):
        t0 = time.perf_counter()
        nb = native.build_blas(verts, leaf, "sah")
        t1 = time.perf_counter()
        pb = builder.build_blas(verts, leaf, "sah")
        t2 = time.perf_counter()
        same = all(np.array_equal(getattr(nb, f.name), getattr(pb, f.name))
                   for f in dataclasses.fields(builder.BLAS))
        nat[name] = dict(triangles=int(len(verts)), identical=same,
                         native_ms=(t1 - t0) * 1e3, numpy_ms=(t2 - t1) * 1e3)
        say(f"[20 native] BLAS of the {name} ({len(verts)} triangles, leaf {leaf}, "
            f"SAH): native == numpy {same}; native {(t1 - t0) * 1e3:.1f} ms, numpy "
            f"{(t2 - t1) * 1e3:.1f} ms (host clock)")
        require(same, f"native BLAS differs from numpy ({name})")
    out["native"] = nat

    # the demo Renderer's cold start (an empty cache) with the native builder
    # and without it (the state RAYZEN_NATIVE=0 leaves), in turns
    def cold_start(use_native):
        packing._blas_cache.clear()
        scene = build_demo_scene(*MULTI_CHIP_SIZE)
        cdir = tempfile.mkdtemp(prefix="rayzen_cold_")
        saved = native._lib, native._tried
        if not use_native:
            native._lib, native._tried = None, True
        try:
            t0 = time.perf_counter()
            r = Renderer(scene, RenderConfig(width=MULTI_CHIP_SIZE[0],
                                             height=MULTI_CHIP_SIZE[1], spp=1,
                                             max_bounces=5, cache_dir=cdir),
                         async_compile=False, device=dev)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            native._lib, native._tried = saved
            shutil.rmtree(cdir, ignore_errors=True)
        return ms, r.startup_steps["Scene pack / BVH build"]

    cold = {True: [], False: []}
    for use_native in (True, False, False, True, True, False):
        cold[use_native].append(cold_start(use_native))
    cmed = {k: (statistics.median(m for m, _ in v), statistics.median(p for _, p in v))
            for k, v in cold.items()}
    say(f"[20 native] demo {MULTI_CHIP_SIZE[0]}x{MULTI_CHIP_SIZE[1]} cold start "
        f"(empty cache), 3 each in turns, medians (host clock): native "
        f"{cmed[True][0]:.1f} ms (pack {cmed[True][1]:.1f}), numpy {cmed[False][0]:.1f}"
        f" ms (pack {cmed[False][1]:.1f})")
    out["cold_start"] = dict(native_ms=[m for m, _ in cold[True]],
                             numpy_ms=[m for m, _ in cold[False]],
                             native_pack_ms=[p for _, p in cold[True]],
                             numpy_pack_ms=[p for _, p in cold[False]])
    if out_dir:
        with open(os.path.join(out_dir, "phase20.json"), "w") as f:
            json.dump(out, f, indent=1)
    return out


def last_functions_phase(torch, np, dev):
    """Phase 21: the port's last host and scene functions on the card, on
    the demo scene at small shapes. traverse_scene against
    brute_force_scene and against K2 (walk.closest_hit_bvh2) on 4,096
    random rays: the same triangle on every ray (or an exact-t tie), t
    within 1e-6 relative; traverse_blas over the monkey's BLAS in object
    space against the float64 brute_force_closest_hit: the same hit or
    miss on every ray, t within 1e-4 relative; a save_bvh / load_bvh and a
    write_ppm / read_ppm round trip with equal arrays; ref_rand on the card
    bit for bit its CPU result; build_scene_tlas from the card's arrays
    equal to the CPU pack's. Returns the numbers."""
    import tempfile

    from rayzen_tpu_torch import ext
    from rayzen_tpu_torch.accel import builder
    from rayzen_tpu_torch.config import RenderConfig
    from rayzen_tpu_torch.demo import build_demo_scene
    from rayzen_tpu_torch.image_io import read_ppm, to_uint8, write_ppm
    from rayzen_tpu_torch.integrator import render_radiance_with_stats
    from rayzen_tpu_torch.ops import traverse, walk
    from rayzen_tpu_torch.ops.rng import ref_rand
    from rayzen_tpu_torch.packing import (
        build_scene_tlas, pack_scene_host, world_geometry,
    )

    def rays(n, seed, spread):
        rs = np.random.RandomState(seed)
        o = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
        d = rs.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                torch.ones(n, dtype=torch.bool, device=dev))

    out = {}
    cfg = RenderConfig(width=256, height=192, spp=1, max_bounces=5)
    scene = build_demo_scene(256, 192)
    host = pack_scene_host(scene, cfg)
    arrays = host.to(dev)
    o, d, act = rays(4096, 31, 4.0)
    ext.reset_launches()
    walked = traverse.traverse_scene(arrays, o, d, act)
    brute = traverse.brute_force_scene(arrays, o, d, act)
    k2 = walk.closest_hit_bvh2(world_geometry(arrays), o, d, act)
    launches = {k: v for k, v in ext.LAUNCHES.items() if v}
    require(walked.t.device == brute.t.device == o.device,
            "21: traverse_scene or brute_force_scene left the rays' device")
    require(launches == {"closest_hit_bvh2": 1},
            f"21: the comparison launched other kernels: {launches}")
    n_hit = int(walked.found.sum())
    require(n_hit > 400, f"21: only {n_hit} of 4096 random rays hit the demo scene")
    for name, other in (("brute_force_scene", brute), ("K2", k2)):
        require(torch.equal(other.found, walked.found), f"21: {name} hits other rays")
        other_tri = (other.tri != walked.tri) & walked.found
        ties = other_tri & (other.t == walked.t)
        f = walked.found & ~other_tri
        rel = ((other.t - walked.t).abs() / walked.t.abs()).masked_fill(~f, 0).max().item()
        say(f"[21 last functions] traverse_scene vs {name}, 4096 random rays: "
            f"{n_hit} hits, another triangle on {int(other_tri.sum())} "
            f"({int(ties.sum())} exact-t ties), t max rel err {rel:.3e}")
        require(torch.equal(other_tri, ties), f"21: {name} finds another triangle")
        require(rel <= 1e-6, f"21: {name} t rtol > 1e-6")
        out[f"traverse_scene_vs_{name}"] = dict(hits=n_hit, ties=int(ties.sum()),
                                                t_max_rel_err=rel)

    # traverse_blas over the monkey's BLAS, object-space rays
    meta = max(arrays.instance_meta, key=lambda m: m.num_triangles)  # a monkey
    lo, hi = meta.tri_offset, meta.tri_offset + meta.num_triangles
    v0 = host.tri_v0[lo:hi].astype(np.float32)
    soup = np.stack([v0, v0 + host.tri_e1[lo:hi], v0 + host.tri_e2[lo:hi]], axis=1)
    bo, bd, bact = rays(4096, 32, 1.5)
    t, tri = traverse.traverse_blas(arrays, bo, bd, bact, meta.node_offset,
                                    meta.tri_offset, leaf_size=cfg.leaf_size)
    t, tri = t.cpu().numpy(), tri.cpu().numpy()
    bo, bd = bo.cpu().numpy(), bd.cpu().numpy()
    ref = [builder.brute_force_closest_hit(bo[i], bd[i], soup) for i in range(4096)]
    ref_tri = np.asarray([r[0] for r in ref])
    ref_t = np.asarray([r[1] for r in ref])
    hit = ref_tri >= 0
    same_hit = bool(((tri >= 0) == hit).all())
    t_rel = float((np.abs(t[hit] - ref_t[hit]) / ref_t[hit]).max()) if hit.any() else 0.0
    other = int((tri[hit] - lo != ref_tri[hit]).sum())
    say(f"[21 last functions] traverse_blas, monkey BLAS ({meta.num_triangles} "
        f"triangles), 4096 object-space rays vs brute_force_closest_hit (float64): "
        f"{int(hit.sum())} hits, same hit/miss {same_hit}, another triangle on "
        f"{other}, t max rel err {t_rel:.3e}")
    require(hit.sum() > 400, "21: too few rays hit the monkey")
    require(same_hit and t_rel <= 1e-4, "21: traverse_blas vs brute_force_closest_hit")
    out["traverse_blas_vs_brute"] = dict(hits=int(hit.sum()), other_triangle=other,
                                         t_max_rel_err=t_rel)

    with tempfile.TemporaryDirectory(prefix="rayzen_last_") as tmp:
        bvh = builder.build_blas(soup, cfg.leaf_size)
        builder.save_bvh(os.path.join(tmp, "monkey"), bvh)
        back = builder.load_bvh(os.path.join(tmp, "monkey.npz"))
        same_bvh = all(np.array_equal(getattr(bvh, f.name), getattr(back, f.name))
                       and getattr(bvh, f.name).dtype == getattr(back, f.name).dtype
                       for f in dataclasses.fields(builder.BLAS))
        img, _ = render_radiance_with_stats(arrays, scene.camera.device_params(), cfg)
        img = img.cpu().numpy()
        write_ppm(os.path.join(tmp, "frame.ppm"), img)
        frame = read_ppm(os.path.join(tmp, "frame.ppm"))
        same_ppm = bool(np.array_equal(frame, to_uint8(img)[::-1]))
    say(f"[21 last functions] save_bvh / load_bvh round trip equal {same_bvh}; "
        f"write_ppm / read_ppm round trip of the 256x192 frame equal {same_ppm}")
    require(same_bvh and same_ppm, "21: a disk round trip")

    uv = np.random.RandomState(33).uniform(0, 3000, (1 << 20, 2)).astype(np.float32)
    on_card = ref_rand(torch.from_numpy(uv).to(dev))
    cpu = ref_rand(torch.from_numpy(uv))
    same_rand = bool(torch.equal(on_card.cpu().view(torch.int32), cpu.view(torch.int32)))
    tlas, tlas_cpu = build_scene_tlas(arrays), build_scene_tlas(host.to("cpu"))
    same_tlas = all(np.array_equal(getattr(tlas, f.name), getattr(tlas_cpu, f.name))
                    for f in dataclasses.fields(builder.BLAS))
    say(f"[21 last functions] ref_rand on {on_card.numel()} draws: card == CPU bit "
        f"for bit {same_rand}; build_scene_tlas from the card's arrays == the CPU "
        f"pack's {same_tlas} ({tlas.num_nodes} nodes)")
    require(same_rand, "21: ref_rand on the card is not its CPU result")
    require(same_tlas, "21: build_scene_tlas differs between the card and the CPU")
    out.update(disk_round_trips=same_bvh and same_ppm, ref_rand_bitwise=same_rand,
               tlas_equal=same_tlas)
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import rayzen_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: rayzen_tpu_torch not found next to this script ({e})",
              file=sys.stderr)
        return 2
    from rayzen_tpu_torch import ext
    from rayzen_tpu_torch.config import RenderConfig
    from rayzen_tpu_torch.demo import build_demo_scene
    from rayzen_tpu_torch.image_io import ssim
    from rayzen_tpu_torch.integrator import render_radiance_with_stats
    from rayzen_tpu_torch.ops import megakernel, walk
    from rayzen_tpu_torch.ops.camera_rays import pixel_grid
    from rayzen_tpu_torch.packing import (
        SINGLE_TREE_VMEM_BUDGET, pack_scene, pack_scene_host,
        single_tree_table_bytes, world_geometry,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = None
    if "--out-dir" in sys.argv[1:]:
        out_dir = sys.argv[sys.argv.index("--out-dir") + 1]
        os.makedirs(out_dir, exist_ok=True)

    # ---- 1 device ----
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    say(f"[1 device] {kind} | torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)

    # ---- 2 build ----
    t0 = time.perf_counter()
    ext.build(force=True)
    ext.lib()
    build_s = time.perf_counter() - t0
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke_build.log"), "w") as f:
            f.write(ext.build_log)
    ptxas = ext.ptxas_summary(ext.build_log)
    say(f"[2 build] nvcc sm_90a build {build_s:.1f} s (one nvcc per source, in "
        "parallel); ptxas: " + " | ".join(
            f"{k} {v.get('regs')} regs, {v.get('stack')} B stack, "
            f"{v.get('spill')} B spill" for k, v in sorted(ptxas.items())))

    # the compiled label of each K1 form: the regenerating regen_kernel over
    # the whole tree, the tiered view and the wide tables; the K9 and K6
    # forms on the lockstep sample_kernel with warp tiles; K4's phase 1: its
    # plain form regen_phase1_kernel, its K9 and K6 forms the K1 forms'
    # instantiations
    form_label = {
        "bvh2": "regen_kernel<Bvh2Walk>", "tiered": "regen_kernel<TieredWalk>",
        "wide": "regen_kernel<Bvh8Walk>",
        "octant": "sample_kernel<Bvh2Walk,octant>",
        "tiered_octant": "sample_kernel<TieredWalk,octant>",
        "wide_octant": "sample_kernel<Bvh8Walk,octant>",
        "frustum": "sample_kernel<Bvh2Walk,frustum>",
        "frustum_octant": "sample_kernel<Bvh2Walk,octant,frustum>"}
    # and of each form's counting instantiation (walk_lane_counts)
    count_label = {f: lab[:-1] + ",count>" for f, lab in form_label.items()}
    lockstep = {k for k in ptxas if k.startswith("sample_kernel")}
    say(f"[2 build] K1 forms: {form_label}; lockstep: {sorted(lockstep)}")
    require(set(form_label.values()) | set(count_label.values()) <= set(ptxas),
            "a K1 form or its counting form was not compiled")
    require(lockstep == {f for f in (*form_label.values(), *count_label.values())
                         if f.startswith("sample")},
            "the lockstep sample_kernel has other instantiations than the K9 and "
            "K6 forms (and their counting forms), which K4's phase 1 shares")
    require({"regen_phase1_kernel<Bvh2Walk>", "regen_phase1_kernel<Bvh2Walk,count>"}
            <= set(ptxas), "K4's plain phase 1 (regenerating) was not compiled")
    # the standalone walks: one live-ray template over the walk (K7 and K2/K3
    # with their counting forms; K8 and K5's harness launchers)
    live_labels = {f"live_walk_kernel<{m},{w}{c}>" for m in ("closest", "shadow")
                   for w in ("MisslinkWalk", "Bvh2Walk", "TieredWalk")
                   for c in ("", ",count")}
    live_labels |= {f"live_walk_kernel<{m},Bvh8Walk>" for m in ("closest", "shadow")}
    # K6's packet walk over the same map, and its counting form
    live_labels |= {f"frustum_walk_kernel<{m}{c}>" for m in ("closest", "shadow")
                    for c in ("", ",count")}
    require(live_labels <= set(ptxas),
            "a standalone walk (K2/K3, K5, K6, K7, K8) or its counting form was "
            "not compiled")
    # ext.ptxas_summary labels the kernels of this tree's templates; any
    # other kernel (a standalone walk outside the two templates) keeps its
    # mangled name
    stray = sorted(k for k in ptxas if k.startswith("_Z"))
    require(not stray, f"kernels outside this tree's templates were compiled: {stray}")
    # K4's continuation: the plain and K9 forms, each with its counting form
    cont_label = {"continuation": "continuation_kernel<Bvh2Walk>",
                  "continuation_octant": "continuation_kernel<Bvh2Walk,octant>"}
    require(set(cont_label.values()) | {v[:-1] + ",count>" for v in cont_label.values()}
            <= set(ptxas), "a continuation form or its counting form was not compiled")

    @contextlib.contextmanager
    def using(lib_):
        """Run the wrappers' launches through another build's library."""
        saved = ext.lib()
        ext._lib = lib_
        try:
            yield
        finally:
            ext._lib = saved

    def budget_line(forms):
        """The compiled budget of K1 forms, with ptxas's spills; their block
        must be the one the plain version's warp map assumes (tile_pixels,
        the K6 forms' packets)."""
        got = {f: megakernel.sample_budget(f) for f in forms}
        require(all(b["threads"] == megakernel.K1_THREADS for b in got.values()),
                f"a K1 form's block is not megakernel.K1_THREADS: {got}")
        return got, "; ".join(
            f"{f} {b['threads']} threads, {b['regs']} registers (ptxas spills "
            f"{ptxas.get(form_label[f], {}).get('spill')} B), {b['local_bytes']} B "
            f"local, {b['warps_per_sm']} resident warps per SM" for f, b in got.items())

    def lane_utilisation(tag, what, ws_, cfg_, uv_, act_, cam_, spp):
        """The walk-loop lane utilisation of the K1 form sample_wave runs for
        cfg_ (its counting instantiation, a diagnostic off the main path),
        which must render the form's frame bit for bit."""
        lc_, lr_, a_, sl_ = megakernel.walk_lane_counts(ws_, cfg_, uv_, act_, cam_,
                                                        0, 0, 5, spp)
        kc_, kr_ = megakernel.sample_wave(ws_, cfg_, uv_, act_, cam_, 0, 0, 5, spp)
        same_ = bool(torch.equal(lc_, kc_)) and int(lr_) == int(kr_)
        say(f"[{tag}] {what} walk-loop lane utilisation: {a_ / sl_:.4f} ({a_} "
            f"active lane-steps of {sl_}); the counting form's frame equals the "
            f"form's {same_}")
        require(same_, f"{tag}: the counting {what} rendered another frame")
        return a_ / sl_

    def scene_setup(w, h, spp=1, **kw):
        cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=5, **kw)
        scene = build_demo_scene(w, h)
        arrays = pack_scene(scene, cfg, dev)
        return cfg, scene, arrays, scene.camera.device_params()

    def primary_rays(w, h, cam_params):
        _, uv = pixel_grid(w, h, dev)
        cam = megakernel._pack_camera(cam_params, dev)
        z = torch.zeros_like(uv[:, 0])
        ox, oy, oz, dx, dy, dz = megakernel._raygen_tiles(uv[:, 0], uv[:, 1], z, z, cam)
        return torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1)

    def shadow_rays(ws, hit):
        """Rays from the hit points toward each light (megakernel lighting)."""
        out = []
        p = hit.point
        for li in range(ws.lights.shape[0]):
            g = ws.lights[li]
            if float(g[3]) == 1.0:
                lv = g[:3] - p
                dist = torch.clamp_min(lv.norm(dim=1), 0.001)
                ld, md = lv / dist[:, None], dist
            else:
                ld = (g[:3] / g[:3].norm()).expand_as(p).contiguous()
                md = torch.full_like(p[:, 0], 1e30)
            out.append((p + ld * 0.001, ld, md, hit.found))
        return out

    def hits_agree(kt, ktri, pt, ptri):
        """(share of rays with the same triangle, max relative and max abs t
        error over the rays that hit the same triangle)."""
        same = (ktri == ptri).float().mean().item()
        f = (ktri >= 0) & (ktri == ptri)
        rel = ((kt - pt).abs() / pt.abs()).masked_fill(~f, 0).max().item()
        return same, rel, (kt - pt).abs().masked_fill(~f, 0).max().item()

    # ---- 3 walks: K2/K3 vs plain ----
    cfg, scene, arrays, camp = scene_setup(256, 192)
    ws = world_geometry(arrays)
    o, d = primary_rays(256, 192, camp)
    act = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    kh = walk.closest_hit_bvh2(ws, o, d, act)
    pt, ptri, _pc, _pm = walk.closest_walk_reference(ws, o, d, act)
    same, t_err, k2_err = hits_agree(kh.t, kh.tri, pt, ptri)
    say(f"[3 walks] K2 vs plain, 256x192 primary: same tri {same * 100:.4f}%, "
        f"t max rel err {t_err:.3e}, hits {int(kh.found.sum())}")
    require(same >= 0.9999, "K2 tri agreement < 99.99%")
    require(t_err <= 1e-5, "K2 t rtol > 1e-5")
    k3_err = 0.0
    for i, (so, sd, md, sa) in enumerate(shadow_rays(ws, kh)):
        kv, kr = walk.shadow_walk_bvh2(ws, so, sd, md, sa)
        pv = walk.shadow_walk_reference(ws, so, sd, md, sa)
        err = (kv - pv).abs().max().item()
        k3_err = max(k3_err, err)
        say(f"[3 walks] K3 vs plain, light {i}: vis max abs err {err:.3e}, "
            f"{int(kr)} rays, {int((kv < 1).sum())} shadowed")
        require(err <= 1e-5, "K3 vis atol > 1e-5")

    def k1_compare(tag, rng, k, p, w, h, n_samples, what="K1"):
        """Hold K1's (color sum, rays) to the plain version's on the per-pixel
        mean over samples, clipped as the frame is; returns the max abs error."""
        (kc, kr), (pc, pr) = k, p
        ki = torch.clamp(kc / n_samples, 0, 1).reshape(h, w, 3)
        pi = torch.clamp(pc / n_samples, 0, 1).reshape(h, w, 3)
        diff = (ki - pi).abs()
        mean, mx = diff.mean().item(), diff.max().item()
        frac = (diff.amax(-1) > 1e-3).float().mean().item()
        s = ssim(ki.cpu().numpy(), pi.cpu().numpy())
        say(f"[{tag}] {what} vs plain, {w}x{h}, {n_samples} spp, {rng}: mean abs {mean:.3e}, "
            f"max abs {mx:.3e}, pixels > 1e-3 {frac * 100:.3f}%, SSIM {s:.6f}, "
            f"rays {int(kr)} vs {int(pr)}")
        if rng == "threefry":
            require(mean < 1e-5 and frac <= 0.001, f"K1 threefry bars ({w}x{h})")
            require(int(kr) == int(pr), f"K1 threefry ray count ({w}x{h})")
        else:
            require(s >= 0.995 and mean < 2e-3, f"K1 reference bars ({w}x{h})")
            require(abs(int(kr) - int(pr)) <= 0.001 * int(pr),
                    f"K1 reference rays ({w}x{h})")
        return mx

    # ---- 4 sample: K1 vs plain at 256x192 ----
    _, uv = pixel_grid(256, 192, dev)
    k1_err = 0.0
    for rng in ("threefry", "reference"):
        c4 = cfg.replace(rng=rng)
        k = megakernel.sample_wave(ws, c4, uv, act, camp, 0, 0, 5, 1)
        p = megakernel.sample_wave_reference(ws, c4, uv, act, camp, 0, 0, 5, 1)
        k1_err = max(k1_err, k1_compare("4 sample", rng, k, p, 256, 192, 1))

    # ---- 5 gates: bench.py's golden gates on the kernel path ----
    for w, h, name in ((256, 192, "demo_256x192.npz"),
                       (800, 600, "demo_reference_800x600.npz")):
        gcfg, gscene, garrays, gcam = scene_setup(w, h)
        img, _ = render_radiance_with_stats(garrays, gcam, gcfg)
        img = img.cpu().numpy()
        golden = np.load(os.path.join(HERE, "tests", "golden", name))["image"]
        golden = golden.astype(np.float32)
        s, mabs = ssim(img, golden), float(np.abs(img - golden).mean())
        say(f"[5 gates] {w}x{h} vs {name}: SSIM {s:.4f}, mean abs {mabs:.3e}")
        require(s >= 0.995 and mabs < 2e-3, f"golden gate {w}x{h}")

    # ---- 6 main path: 1080p, 64 spp, 5 bounces ----
    mcfg, mscene, marrays, mcam = scene_setup(1920, 1080, spp=64)
    img, rays = render_radiance_with_stats(marrays, mcam, mcfg)  # warm-up
    torch.cuda.synchronize()
    ext.reset_launches()
    times, ray_counts = [], []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        img, rays = render_radiance_with_stats(marrays, mcam, mcfg)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        ray_counts.append(int(rays))
    launches = dict(ext.LAUNCHES)

    require(img.shape == (1080, 1920, 3), "frame shape")
    require(bool(torch.isfinite(img).all()), "frame has non-finite values")
    require(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, "frame range")
    require(len(set(ray_counts)) == 1, "ray count differs between dispatches")
    rays_pd = ray_counts[0]
    dev_rays = abs(rays_pd - BENCH_R05_RAYS) / BENCH_R05_RAYS
    med, best = statistics.median(times), min(times)
    say(f"[6 main path] 1920x1080 spp 64, 5 bounces on {kind} ({smi}): "
        f"median {med:.2f} ms, best {best:.2f} ms per dispatch over {len(times)}; "
        f"{rays_pd} rays per dispatch (int64); {rays_pd / med / 1e3:.1f} Mrays/s "
        f"median, {rays_pd / best / 1e3:.1f} best; vs BENCH_r05 count "
        f"{dev_rays * 100:.3f}% off")
    say(f"[6 main path] dispatch ms: {', '.join(f'{t:.2f}' for t in times)}")
    require(dev_rays <= 0.005, "rays per dispatch not within 0.5% of BENCH_r05")

    # ---- 7 kernels vs plain at the main path's 1080p shapes ----
    # Launches from here on compare kernels with their plain versions; they
    # are not counted as the main path's.
    ext.reset_launches()
    R = 1920 * 1080
    mws = world_geometry(marrays)
    mo, md_ = primary_rays(1920, 1080, mcam)
    mact = torch.ones(mo.shape[0], dtype=torch.bool, device=dev)
    mhit = walk.closest_hit_bvh2(mws, mo, md_, mact)
    (pt, ptri, _pc, _pm), p2_ms, k2_work = counted(
        lambda w: walk.closest_walk_reference(mws, mo, md_, mact, work=w), torch, walk)
    same, t_rel, t_abs = hits_agree(mhit.t, mhit.tri, pt, ptri)
    k2_err = max(k2_err, t_abs)
    k2_ms = cuda_ms(lambda: walk.closest_walk(mws, mo, md_, mact), 10, torch)
    say(f"[7 kernels] K2 vs plain, 1080p primary: same tri {same * 100:.4f}%, "
        f"t max rel err {t_rel:.3e}, hits {int(mhit.found.sum())}; "
        f"{k2_ms:.3f} ms vs plain {p2_ms:.2f} ms")
    require(same >= 0.9999, "K2 tri agreement < 99.99% at 1080p")
    require(t_rel <= 1e-5, "K2 t rtol > 1e-5 at 1080p")
    for i, (so, sd, sm, sa) in enumerate(shadow_rays(mws, mhit)):
        kv, kr = walk.shadow_walk_bvh2(mws, so, sd, sm, sa)
        pv, pms, work = counted(
            lambda w: walk.shadow_walk_reference(mws, so, sd, sm, sa, work=w), torch,
            walk)
        kms = cuda_ms(lambda: walk.shadow_walk_bvh2(mws, so, sd, sm, sa), 10, torch)
        err = (kv - pv).abs().max().item()
        k3_err = max(k3_err, err)
        if i == 0:  # the point light: the one whose rays end at max_dist
            k3_ms, p3_ms, k3_work = kms, pms, work
        say(f"[7 kernels] K3 vs plain, 1080p light {i}: vis max abs err {err:.3e}, "
            f"{int(kr)} rays, {int((kv < 1).sum())} shadowed; {kms:.3f} ms vs plain "
            f"{pms:.2f} ms")
        require(err <= 1e-5, "K3 vis atol > 1e-5 at 1080p")
    _, muv = pixel_grid(1920, 1080, dev)
    # K1 renders the whole 1080p frame in both flows. The plain version
    # renders a strided subset of its pixels in each flow (every
    # K1_PLAIN_STRIDE[rng]-th column: a pixel's draws are keyed by the pixel,
    # so its plain result does not depend on the other pixels), held against
    # the kernel's pixels there with the same bars. The bound's work is
    # estimated from the configured flow's subset: its plain walks' work
    # times the pixel ratio.
    for rng in ("threefry", "reference"):
        c7 = mcfg.replace(rng=rng)
        kc, kr, _ = megakernel._launch_sample(
            mws, megakernel._consts(c7, 0, 0, 5, 64), muv, mact, mcam, 5,
            phase1=False)
        st = K1_PLAIN_STRIDE[rng]
        p, pms, work = counted(lambda w: megakernel.sample_wave_reference(
            mws, c7, muv[::st], mact[::st], mcam, 0, 0, 5, 64, work=w), torch, walk)
        k = (kc[::st], kr[::st].sum(dtype=torch.int64))
        k1_err = max(k1_err, k1_compare("7 kernels", rng, k, p, 1920 // st, 1080, 64))
        if rng == mcfg.rng:
            p1_ms, p1_pixels, k1_frame = pms, muv[::st].shape[0], kc
            k1_work = {key: v if key == "ml_chain" else v * R // p1_pixels
                       for key, v in work.items()}
    k1_ms = cuda_ms(lambda: megakernel.sample_wave(
        mws, mcfg, muv, mact, mcam, 0, 0, 5, 64), 3, torch)
    refit_ms = cuda_ms(lambda: world_geometry(marrays), 10, torch)
    say(f"[7 kernels] 1080p on {kind} ({smi}): K1 64 spp {k1_ms:.2f} ms (the "
        f"frame) vs plain {p1_ms:.2f} ms ({p1_pixels} pixels, every "
        f"{K1_PLAIN_STRIDE[mcfg.rng]}th column, {mcfg.rng} flow); refit "
        f"{refit_ms:.3f} ms")
    # the regenerating K1's compiled budget and its walk loop's lane
    # utilisation (the counting instantiation, a diagnostic off the main
    # path) on the same 1080p/64 spp frame
    budget, line = budget_line(("bvh2", "tiered", "wide"))
    say("[7 kernels] regenerating K1 budget: " + line)
    lc, lr, l_act, l_slots = megakernel.walk_lane_counts(mws, mcfg, muv, mact, mcam,
                                                         0, 0, 5, 64)
    lanes_demo = l_act / l_slots
    say(f"[7 kernels] K1 walk-loop lane utilisation, 1080p/64 spp: {lanes_demo:.4f} "
        f"({l_act} active lane-steps of {l_slots}); the counting K1's frame equals "
        f"K1's {bool(torch.equal(lc, k1_frame))}, rays {int(lr)}")
    require(torch.equal(lc, k1_frame), "the counting K1 rendered another frame")
    standalone = dict(ext.LAUNCHES)
    wall, busy, top = profile_dispatch(
        lambda: render_radiance_with_stats(marrays, mcam, mcfg), torch,
        out_dir and os.path.join(out_dir, "main_path_trace.json"))
    say(f"[7 kernels] one 1080p/64 spp dispatch under torch.profiler: wall "
        f"{wall:.2f} ms, device busy {busy:.2f} ms ({busy / wall * 100:.1f}%); top: "
        + "; ".join(f"{name[:40]} x{n} {ms:.3f} ms" for ms, name, n in top[:5]))

    # ---- 8 launches ----
    # On the main path K2/K3 run as device functions inside K1, so only K1 is
    # launched there; their own kernels are launched by phases 3 and 7.
    say(f"[8 launches] main-path run: {launches}; phase 7 (kernel vs plain): "
        f"{standalone}")
    require(launches["sample_wave"] >= 1, "K1 was not launched on the main path")
    require(all(standalone[k] >= 1 for k in
                ("sample_wave", "closest_hit_bvh2", "shadow_walk_bvh2")),
            "a kernel was never launched in phase 7")

    # ---- 9 field: the large-scene path's scene, packed with the defaults ----
    fcfg = RenderConfig(width=1920, height=1080, spp=4, max_bounces=5)
    fscene = build_field_scene(1920, 1080)
    fcam = fscene.camera.device_params()
    t0 = time.perf_counter()
    fhost = pack_scene_host(fscene, fcfg)
    pack_s = time.perf_counter() - t0
    farrays = fhost.to(dev)
    fws = world_geometry(farrays)
    n_inner, n_leaf = fhost.bvh2_child_node.shape[0], fhost.bvh2_leaf_node.shape[0]
    mb = 2.0 ** 20
    tree_mb = single_tree_table_bytes(n_inner, n_leaf, fcfg.leaf_size) / mb
    tre_mb = (fws.tre_inner.numel() + fws.tre_leaf.numel()) * 4 / mb
    say(f"[9 field] {fscene.num_triangles} world triangles, {n_inner} inner rows, "
        f"{n_leaf} leaf rows, tree depth {fhost.tree_depth}; single-tree tables "
        f"{tree_mb:.2f} MB vs budget {SINGLE_TREE_VMEM_BUDGET / mb:.2f} MB "
        f"(MB = 2^20 bytes); host pack {pack_s:.2f} s; tiered {fws.tiered}: "
        f"{fws.tre_inner.shape[0]} treelets x {fws.tre_inner.shape[1]} rows, top "
        f"{fws.top_table.shape[0]} rows, top depth {fws.top_depth}, deepest treelet "
        f"{fws.treelet_depth}, treelet tables {tre_mb:.2f} MB; K8's one stack "
        f"needs {walk.tiered_stack_need(fws.top_depth, fws.treelet_depth)} of "
        f"{2 * walk.STACK_DEPTH} entries")
    require(fws.tiered, "the field did not pack tiered (no treelet view)")

    # ---- 10 K8 vs plain and vs K2/K3 on the whole tree, 1080p field rays ----
    ext.reset_launches()
    fo, fd = primary_rays(1920, 1080, fcam)
    fact = torch.ones(fo.shape[0], dtype=torch.bool, device=dev)
    k8_out = walk.closest_walk_tiered(fws, fo, fd, fact)
    fhit = walk.decode_hit(fws, fo, fd, *k8_out)
    p8_out, p8_ms, k8_work = counted(
        lambda w: walk.tiered_closest_walk_reference(fws, fo, fd, fact, work=w),
        torch, walk)
    pt, ptri = p8_out[0], p8_out[1]
    same, t_rel, k8_err = hits_agree(fhit.t, fhit.tri, pt, ptri)
    k8_exact = all(bool(torch.equal(a, b)) for a, b in zip(k8_out, p8_out))
    k8_ms = cuda_ms(lambda: walk.closest_walk_tiered(fws, fo, fd, fact), 10, torch)
    whit = walk.closest_hit_bvh2(fws, fo, fd, fact)
    same2, t_rel2, _ = hits_agree(fhit.t, fhit.tri, whit.t, whit.tri)
    k2f_ms = cuda_ms(lambda: walk.closest_walk(fws, fo, fd, fact), 10, torch)
    say(f"[10 K8] closest vs plain, field 1080p primary: same tri {same * 100:.4f}%, "
        f"t max rel err {t_rel:.3e}, bit for bit (t, tri, cross, menc) {k8_exact}, "
        f"hits {int(fhit.found.sum())}; {k8_ms:.3f} ms vs plain {p8_ms:.2f} ms")
    say(f"[10 K8] closest vs K2 on the whole tree: same tri {same2 * 100:.4f}%, "
        f"t max rel err {t_rel2:.3e}; K2 {k2f_ms:.3f} ms")
    require(same >= 0.9999, "K8 tri agreement with plain < 99.99%")
    require(t_rel <= 1e-5, "K8 t rtol > 1e-5")
    require(k8_exact, "K8 closest differs from its plain version")
    require(same2 >= 0.9999, "K8 tri agreement with K2 < 99.99%")
    # the counting K8 (a diagnostic off the main path): the same results,
    # and the share of a warp's lanes that take each step of the node loop
    c8_out, l8_act, l8_slots = walk.live_lane_counts(fws, fo, fd, fact, kind="tiered")
    require(all(bool(torch.equal(a, b)) for a, b in zip(c8_out, k8_out)),
            "the counting K8 found other hits")
    k8_lanes = l8_act / l8_slots
    k8_budget = {f: walk.live_budget(f) for f in ("closest_tiered", "shadow_tiered")}
    say(f"[10 K8] closest walk-loop lane utilisation {k8_lanes:.4f} ({l8_act} of "
        f"{l8_slots}); budget {k8_budget} (ptxas: "
        + "; ".join(f"{m} {ptxas.get(f'live_walk_kernel<{m},TieredWalk>')}"
                    for m in ("closest", "shadow")) + ")")
    require(all(b["threads"] == 128 and b["regs"] <= 64 and b["warps_per_sm"] >= 32
                for b in k8_budget.values()), "K8's budget")
    k8s_err = 0.0
    for i, (so, sd, sm, sa) in enumerate(shadow_rays(fws, fhit)):
        kv, kr = walk.shadow_walk_tiered(fws, so, sd, sm, sa)
        pv, pms, work = counted(
            lambda w: walk.tiered_shadow_walk_reference(fws, so, sd, sm, sa, work=w),
            torch, walk)
        kms = cuda_ms(lambda: walk.shadow_walk_tiered(fws, so, sd, sm, sa), 10, torch)
        wv, _ = walk.shadow_walk_bvh2(fws, so, sd, sm, sa)
        k3f_ms = cuda_ms(lambda: walk.shadow_walk_bvh2(fws, so, sd, sm, sa), 10, torch)
        err, err3 = (kv - pv).abs().max().item(), (kv - wv).abs().max().item()
        k8s_err = max(k8s_err, err)
        if i == 0:  # the point light
            k8s_ms, p8s_ms, k8s_work = kms, pms, work
            cv, a_, sl_ = walk.live_lane_counts(fws, so, sd, sa, kind="tiered",
                                                max_dist=sm)
            require(bool(torch.equal(cv, kv)), "the counting K8 shadow walk differs")
            k8s_lanes = a_ / sl_
            say(f"[10 K8] shadow walk-loop lane utilisation, light 0: "
                f"{k8s_lanes:.4f} ({a_} of {sl_})")
        say(f"[10 K8] shadow vs plain, field 1080p light {i}: vis max abs err "
            f"{err:.3e} (vs K3 on the whole tree {err3:.3e}), {int(kr)} rays, "
            f"{int((kv < 1).sum())} shadowed; {kms:.3f} ms vs plain {pms:.2f} ms, "
            f"K3 {k3f_ms:.3f} ms")
        require(err <= 1e-5, "K8 shadow vis atol > 1e-5")
        require(bool(torch.equal(kv, pv)), "K8 shadow vis differs from its plain version")
        require(err3 <= 1e-5, "K8 shadow vis differs from K3 on the whole tree")
    k8_standalone = dict(ext.LAUNCHES)
    require(k8_standalone["closest_hit_tiered"] >= 1
            and k8_standalone["shadow_walk_tiered"] >= 1, "K8 was never launched")

    # ---- 11 tiered K1 vs plain (1 spp: 320x180 in the configured flow,
    # 160x90 in the other) and vs the whole-tree K1 ----
    def field_grid(w, h):
        _, uv_ = pixel_grid(w, h, dev)
        return uv_, torch.ones(uv_.shape[0], dtype=torch.bool, device=dev)

    k1t_err = 0.0
    for rng in ("threefry", "reference"):
        gw, gh = (320, 180) if rng == fcfg.rng else (160, 90)
        guv, gact = field_grid(gw, gh)
        gcfg = fcfg.replace(width=gw, height=gh, spp=1, rng=rng)
        k = megakernel.sample_wave(fws, gcfg, guv, gact, fcam, 0, 0, 5, 1)
        p, pms, work = counted(lambda w: megakernel.sample_wave_reference(
            fws, gcfg, guv, gact, fcam, 0, 0, 5, 1, work=w), torch, walk)
        k1t_err = max(k1t_err, k1_compare("11 tiered K1", rng, k, p, gw, gh, 1))
        if rng == fcfg.rng:
            p1t_ms, k1t_work, p1t_rays = pms, work, int(p[1])
            k1t_ms = cuda_ms(lambda: megakernel.sample_wave(
                fws, gcfg, guv, gact, fcam, 0, 0, 5, 1), 5, torch)
    _, fuv = pixel_grid(1920, 1080, dev)
    whole = dataclasses.replace(fws, tiered=False)  # same tables, K2/K3 walks
    (tcol, trays), (wcol, wrays) = (
        megakernel.sample_wave(v, fcfg, fuv, fact, fcam, 0, 0, 5, 4) for v in (fws, whole))
    ti = torch.clamp(tcol / 4, 0, 1).reshape(1080, 1920, 3)
    wi = torch.clamp(wcol / 4, 0, 1).reshape(1080, 1920, 3)
    diff = (ti - wi).abs()
    s_tw = ssim(ti.cpu().numpy(), wi.cpu().numpy())
    say(f"[11 tiered K1] vs whole-tree K1, field 1920x1080, 4 spp, 5 bounces: "
        f"SSIM {s_tw:.6f}, mean abs {diff.mean().item():.3e}, max abs "
        f"{diff.max().item():.3e}, rays {int(trays)} vs {int(wrays)}")
    require(s_tw >= 0.995 and diff.mean().item() < 2e-3, "tiered vs whole-tree K1 image")
    require(abs(int(trays) - int(wrays)) <= 0.001 * int(wrays),
            "tiered vs whole-tree K1 rays")
    # the walks find the same hits and visibilities through either view, so
    # the frames are equal bit for bit
    require(bool(torch.equal(tcol, wcol)) and int(trays) == int(wrays),
            "the tiered K1's frame is not the whole-tree K1's bit for bit")
    k1t_1080_ms = cuda_ms(lambda: megakernel.sample_wave(
        fws, fcfg, fuv, fact, fcam, 0, 0, 5, 4), 3, torch)
    k1w_1080_ms = cuda_ms(lambda: megakernel.sample_wave(
        whole, fcfg, fuv, fact, fcam, 0, 0, 5, 4), 3, torch)
    say(f"[11 tiered K1] field 1080p/4 spp K1 alone on {kind} ({smi}): tiered "
        f"{k1t_1080_ms:.2f} ms, whole tree {k1w_1080_ms:.2f} ms; 320x180/1 spp: "
        f"tiered {k1t_ms:.3f} ms vs plain {p1t_ms:.2f} ms")
    lc, lr, l_act, l_slots = megakernel.walk_lane_counts(fws, fcfg, fuv, fact, fcam,
                                                         0, 0, 5, 4)
    lanes_field = l_act / l_slots
    say(f"[11 tiered K1] walk-loop lane utilisation, field 1080p/4 spp: "
        f"{lanes_field:.4f} ({l_act} active lane-steps of {l_slots}); the counting "
        f"K1's frame equals the tiered K1's {bool(torch.equal(lc, tcol))}, rays "
        f"{int(lr)} vs {int(trays)}")
    require(torch.equal(lc, tcol) and int(lr) == int(trays),
            "the counting tiered K1 rendered another frame")
    say(f"[11 tiered K1] budget {budget['tiered']} (ptxas regen_kernel<TieredWalk>: "
        f"{ptxas.get('regen_kernel<TieredWalk>')})")

    # ---- 12 field path: render_radiance_with_stats on the tiered K1 ----
    img, rays = render_radiance_with_stats(farrays, fcam, fcfg)  # warm-up
    torch.cuda.synchronize()
    ext.reset_launches()
    ftimes, fray_counts = [], []
    for _ in range(6):
        (img, rays), ms = timed(
            lambda: render_radiance_with_stats(farrays, fcam, fcfg), torch)
        ftimes.append(ms)
        fray_counts.append(int(rays))
    flaunches = dict(ext.LAUNCHES)
    fimg = img
    require(img.shape == (1080, 1920, 3), "field frame shape")
    require(bool(torch.isfinite(img).all()), "field frame has non-finite values")
    require(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, "field frame range")
    require(len(set(fray_counts)) == 1, "field ray count differs between dispatches")
    frays = fray_counts[0]
    fmed, fbest = statistics.median(ftimes), min(ftimes)
    say(f"[12 field path] 1920x1080 spp 4, 5 bounces, 503k-triangle field on {kind} "
        f"({smi}): median {fmed:.2f} ms, best {fbest:.2f} ms per dispatch over "
        f"{len(ftimes)}; {frays} rays per dispatch (int64); "
        f"{frays / fmed / 1e3:.1f} Mrays/s median, {frays / fbest / 1e3:.1f} best")
    say(f"[12 field path] dispatch ms: {', '.join(f'{t:.2f}' for t in ftimes)}; "
        f"launches {flaunches}")
    require(flaunches["sample_wave_tiered"] >= 1,
            "the tiered K1 was not launched on the field path")
    require(flaunches["sample_wave"] == 0, "the field path ran the whole-tree K1")
    frefit_ms = cuda_ms(lambda: world_geometry(farrays), 10, torch)
    wall, busy, top = profile_dispatch(
        lambda: render_radiance_with_stats(farrays, fcam, fcfg), torch,
        out_dir and os.path.join(out_dir, "field_path_trace.json"))
    say(f"[12 field path] refit {frefit_ms:.3f} ms; one dispatch under "
        f"torch.profiler: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({busy / wall * 100:.1f}%); top: "
        + "; ".join(f"{name[:40]} x{n} {ms:.3f} ms" for ms, name, n in top[:5]))
    # the whole-tree K1 on the same scene (tiered="off"), in turns with the
    # tiered path: the evidence for the tiered="auto" rule on this card
    wcfg = fcfg.replace(tiered="off")
    warrays = pack_scene(fscene, wcfg, dev)
    require(not world_geometry(warrays).tiered, "tiered='off' packed a treelet view")
    render_radiance_with_stats(warrays, fcam, wcfg)  # warm-up
    runs = {"tiered": (farrays, fcfg), "whole": (warrays, wcfg)}
    ab, ab_rays = {"tiered": [], "whole": []}, {"tiered": set(), "whole": set()}
    for order in (("tiered", "whole"), ("whole", "tiered")) * 3:
        for name in order:
            (_, r), ms = timed(lambda: render_radiance_with_stats(
                runs[name][0], fcam, runs[name][1]), torch)
            ab[name].append(ms)
            ab_rays[name].add(int(r))
    say("[12 field path] in turns: " + "; ".join(
        f"{name} median {statistics.median(ts):.2f} ms ({', '.join(f'{t:.2f}' for t in ts)}), "
        f"rays {sorted(ab_rays[name])}" for name, ts in ab.items()))
    field_turns = {k: statistics.median(v) for k, v in ab.items()}
    say(f"[12 field path] the tiered view {'beats' if field_turns['tiered'] < field_turns['whole'] else 'loses to'} "
        f"the whole tree (tiered='off') on this card: "
        f"{field_turns['tiered'] / field_turns['whole']:.3f}x")

    def split_kernels(ws, cfg, uv, act, cam, tag):
        """K4's phase 1, the compaction and the continuation of one sample,
        each alone, against the plain versions on the same inputs: errors,
        times and the plain walks' work. The compaction and the continuation
        run once as the split runs them, under CUDA's sync debug mode: the
        permutation and the live count stay on the device, so no call of
        theirs may wait for it."""
        n, sb = uv.shape[0], cfg.split_bounce
        c1, r1, st = megakernel.sample_wave_phase1(ws, cfg, uv, act, cam, 0, 0, 5)
        (pc1, pr1, pst), p_ph1, w_ph1 = counted(
            lambda w: megakernel.sample_wave_phase1_reference(
                ws, cfg, uv, act, cam, 0, 0, 5, work=w), torch, walk)
        k_ph1 = cuda_ms(lambda: megakernel.sample_wave_phase1(
            ws, cfg, uv, act, cam, 0, 0, 5), 5, torch)

        def compact():
            return megakernel._compaction_permutation(
                st[10] > 0.5, st[3], st[4], st[5], cfg.split_rebin,
                origins=(st[0], st[1], st[2]))

        def cont(fn, col_, rays_, work=None):
            kw = {} if work is None else dict(work=work)
            fn(ws, cfg, st, order, live, col_, rays_, 0, 0, 5, sb, 5, False, **kw)
            return col_, rays_

        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _dest, order, live = compact()
                c2, r2 = cont(megakernel.continuation, c1.clone(), r1.clone())
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # (the mode's own notice, that it is a prototype that may miss some
        # synchronising calls, is not one)
        n_sync = sum("called a synchronizing" in str(w_.message) for w_ in syncs)
        comp_ms = cuda_ms(compact, 5, torch)
        (pc2, pr2), p_cont, w_cont = counted(
            lambda w: cont(megakernel.continuation_reference, c1.clone(), r1.clone(),
                           w), torch, walk)
        scratch = (c1.clone(), r1.clone())  # the timed calls add into these
        k_cont = cuda_ms(lambda: cont(megakernel.continuation, *scratch), 5, torch)
        # one sample's raw colour exceeds 1 where the lights are strong, so
        # each element is held relative to max(1, |plain|), and the largest
        # error to 4 ulps of the largest |plain|: ulps, at any magnitude
        e1, e2 = (c1 - pc1).abs().max().item(), (c2 - pc2).abs().max().item()
        r1_, r2_ = (((k - p).abs() / p.abs().clamp_min(1.0)).max().item()
                    for k, p in ((c1, pc1), (c2, pc2)))
        m1, m2 = pc1.abs().max().item(), pc2.abs().max().item()
        u1, u2 = (float(np.spacing(np.float32(m))) for m in (m1, m2))
        st_err = (st - pst).abs().max().item()
        n_live = int(live)
        say(f"[{tag}] phase 1 alone, {n} rays, split_bounce {sb}, octant walks "
            f"{cfg.octant_bounce_walks}: vs plain max abs {e1:.3e} ({e1 / u1:.1f} ulps "
            f"of max |plain| {m1:.4g}; relative to max(1, |plain|) {r1_:.3e}), rays "
            f"{int(r1)} vs {int(pr1)}, state rows max abs {st_err:.3e}; "
            f"{k_ph1:.3f} ms vs plain {p_ph1:.2f} ms; {n_live} live rays after it "
            f"({n_live / n * 100:.2f}%); compaction ({cfg.split_rebin}) {comp_ms:.3f} ms")
        say(f"[{tag}] continuation alone (phase 1's colour and rays added in): vs "
            f"plain max abs {e2:.3e} ({e2 / u2:.1f} ulps of max |plain| {m2:.4g}; "
            f"relative {r2_:.3e}), bit for bit {bool(torch.equal(c2, pc2))}, rays "
            f"{int(r2)} vs {int(pr2)}; {k_cont:.3f} ms vs plain {p_cont:.2f} ms; "
            f"synchronising calls in the compaction and continuation: {n_sync}")
        require(r1_ <= 1e-6 and e1 <= 4 * u1 and int(r1) == int(pr1),
                f"phase 1 vs plain ({tag})")
        require(st_err == 0.0, f"phase 1 state rows differ from plain ({tag})")
        require(r2_ <= 1e-6 and e2 <= 4 * u2 and int(r2) == int(pr2),
                f"continuation vs plain ({tag})")
        require(n_live == int((st[10] > 0.5).sum()), f"the live count ({tag})")
        require(n_sync == 0, f"the compaction or continuation synchronised ({tag})")
        return dict(ph1=(k_ph1, p_ph1, w_ph1, e1), cont=(k_cont, p_cont, w_cont, e2),
                    comp_ms=comp_ms, live=n_live, order=order, live_t=live, ph1_out=(
                        c1, r1, st))

    def frame_diff(a, b):
        d = (a - b).abs()
        return d.max().item(), d.mean().item()

    def median_ms(fn, reps=5):
        """The median of 6 per-call times (CUDA events, ``reps`` calls each)."""
        got = [cuda_ms(fn, reps, torch) for _ in range(6)]
        return statistics.median(got), got

    def phase1_1080p(tag, cfg_):
        """K4's phase 1 (the form cfg_ selects) at the demo's 1080p, one
        sample: its time alone (median of 6) and its walk-loop lane
        utilisation (the counting form, which must write the same colour and
        rays)."""
        args = (mws, cfg_, muv, mact, mcam, 0, 0, 5)
        out = megakernel.sample_wave_phase1(*args)
        ms, got = median_ms(lambda: megakernel.sample_wave_phase1(*args))
        lc, lr, a_, sl_ = megakernel.walk_lane_counts(*args, phase1=True)
        require(bool(torch.equal(lc, out[0])) and int(lr) == int(out[1]),
                f"{tag}: the counting phase 1 wrote another colour")
        form = dict(split_bounce=cfg_.split_bounce, octant=cfg_.octant_bounce_walks,
                    frustum=cfg_.frustum_primary)
        say(f"[{tag}] phase 1 at 1080p {form} alone on {kind} ({smi}): {ms:.4f} ms "
            f"({' '.join(f'{t:.4f}' for t in got)}); walk-loop lane utilisation "
            f"{a_ / sl_:.4f}")
        return dict(ms=ms, lanes=a_ / sl_)

    def cont_1080p(tag, cfg_, k4_):
        """K4's continuation (the form cfg_ selects) at the demo's 1080p on
        split_kernels' phase-1 rows: its time alone (median of 6), its
        walk-loop lane utilisation (the counting form, which must add the
        same colour and rays) and its compiled budget."""
        c1, r1, st = k4_["ph1_out"]
        order, live = k4_["order"], k4_["live_t"]
        sb = cfg_.split_bounce
        scratch = (c1.clone(), r1.clone())
        ms, got = median_ms(lambda: megakernel.continuation(
            mws, cfg_, st, order, live, *scratch, 0, 0, 5, sb, 5, False))
        kc, kr = c1.clone(), r1.clone()
        megakernel.continuation(mws, cfg_, st, order, live, kc, kr, 0, 0, 5, sb, 5,
                                False)
        cc, cr = c1.clone(), r1.clone()
        a_, sl_ = megakernel.continuation_lane_counts(
            mws, cfg_, st, order, live, cc, cr, 0, 0, 5, sb, 5, False)
        require(bool(torch.equal(cc, kc)) and int(cr) == int(kr),
                f"{tag}: the counting continuation added another colour")
        form = "continuation" + ("_octant" if cfg_.octant_bounce_walks else "")
        budget_ = megakernel.sample_budget(form)
        label = cont_label[form]
        say(f"[{tag}] {form} at 1080p (split_bounce {sb}, {k4_['live']} live rays) "
            f"alone on {kind} ({smi}): {ms:.4f} ms ({' '.join(f'{t:.4f}' for t in got)})"
            f"; walk-loop lane utilisation {a_ / sl_:.4f} ({a_} of {sl_}); budget "
            f"{budget_} (ptxas {label}: {ptxas.get(label)})")
        require(budget_["threads"] == 128 and budget_["regs"] <= 64
                and budget_["warps_per_sm"] == 32, f"{tag}: {form}'s budget")
        return dict(ms=ms, lanes=a_ / sl_, budget=budget_)

    # ---- 13 split: K4 (phase 1 + compaction + continuation) vs plain ----
    ext.reset_launches()
    scfg, _sscene, sarrays, scam = scene_setup(256, 192)
    sws = world_geometry(sarrays)
    _, suv = pixel_grid(256, 192, dev)
    sact = torch.ones(suv.shape[0], dtype=torch.bool, device=dev)
    sk1 = megakernel.sample_wave(sws, scfg, suv, sact, scam, 0, 0, 5, 1)
    k4_err = 0.0
    for knobs in (dict(split_rebin="rank"), dict(split_rebin="octant"),
                  dict(split_rebin="octcell"),
                  dict(split_rebin="octant", split_every=True)):
        c13 = scfg.replace(split_bounce=2, **knobs)
        kc, kr = megakernel.sample_wave_split(sws, c13, suv, sact, scam, 0, 0, 5)
        pc, pr = megakernel.sample_wave_split_reference(sws, c13, suv, sact, scam,
                                                        0, 0, 5)
        err, ferr = (kc - pc).abs().max().item(), (kc - sk1[0]).abs().max().item()
        k4_err = max(k4_err, err)
        say(f"[13 split] 256x192, 1 spp, split_bounce 2, {knobs}: vs plain max abs "
            f"{err:.3e}, rays {int(kr)} vs {int(pr)}; vs K1 max abs {ferr:.3e}, rays "
            f"{int(sk1[1])}")
        require(err <= 1e-6 and int(kr) == int(pr), f"split vs plain ({knobs})")
    split_standalone = dict(ext.LAUNCHES)
    require(split_standalone["sample_wave_phase1"] == 4
            and split_standalone["continuation"] == 6,
            "phase 13 launched phase 1 / the continuation a wrong number of times")
    # the continuation alone at 256x192, after phase 1 at bounce 1 and 2
    for sb in (1, 2):
        split_kernels(sws, scfg.replace(split_bounce=sb, split_rebin="octant"), suv,
                      sact, scam, "13 split")

    # ---- 14 split path: the 1080p/64 spp frame through K4 ----
    xcfg = mcfg.replace(split_bounce=2, split_rebin="octant")
    kimg, krays = render_radiance_with_stats(marrays, mcam, mcfg)
    render_radiance_with_stats(marrays, mcam, xcfg)  # warm-up
    torch.cuda.synchronize()
    ext.reset_launches()
    (ximg, xrays), x_ms = timed(
        lambda: render_radiance_with_stats(marrays, mcam, xcfg), torch)
    xlaunches = dict(ext.LAUNCHES)
    xmax, xmean = frame_diff(ximg, kimg)
    say(f"[14 split path] 1920x1080 spp 64, split_bounce 2, octant rebin: vs K1's frame "
        f"max abs {xmax:.3e}, mean abs {xmean:.3e}, rays {int(xrays)} vs K1 "
        f"{int(krays)}; launches {xlaunches}")
    require(ximg.shape == (1080, 1920, 3) and bool(torch.isfinite(ximg).all()),
            "split frame shape or values")
    require(xmax <= 1e-5 and xmean <= 1e-6, "split frame vs K1")
    require(int(xrays) == int(krays), "split rays vs K1")
    require(xlaunches["sample_wave_phase1"] == 64 and xlaunches["continuation"] == 64
            and xlaunches["sample_wave"] == 0, "split main-path launches")
    runs = {"split": xcfg, "K1": mcfg}
    ab = {k: [] for k in runs}
    ab_rays = {k: set() for k in runs}
    for order in (("split", "K1"), ("K1", "split")) * 3:
        for name in order:
            (_, r), ms = timed(lambda: render_radiance_with_stats(
                marrays, mcam, runs[name]), torch)
            ab[name].append(ms)
            ab_rays[name].add(int(r))
    say(f"[14 split path] in turns on {kind} ({smi}): " + "; ".join(
        f"{name} median {statistics.median(ts):.2f} ms, best {min(ts):.2f} ms, "
        f"{int(xrays) / statistics.median(ts) / 1e3:.1f} Mrays/s median "
        f"({', '.join(f'{t:.2f}' for t in ts)}), rays {sorted(ab_rays[name])}"
        for name, ts in ab.items()))
    require(ab_rays["split"] == ab_rays["K1"] == {int(krays)}, "rays in turns")
    wall, busy, top = profile_dispatch(
        lambda: render_radiance_with_stats(marrays, mcam, xcfg), torch,
        out_dir and os.path.join(out_dir, "split_path_trace.json"))
    # the torch glue around the kernels: gathers and scatters (indexing
    # kernels; not arange's elementwise_kernel_with_index) and the
    # compaction's scans
    glue = {g: [(ms, n) for ms, name, n in top if any(k in name.lower() for k in keys)]
            for g, keys in (("gathers", ("index_elementwise", "gather")),
                            ("scans", ("scan", "cumsum")))}
    x_profile = dict(wall_ms=wall, device_busy_ms=busy, **{
        f"{g}_ms": sum(ms for ms, _n in v) for g, v in glue.items()}, **{
        f"{g}_launches": sum(n for _ms, n in v) for g, v in glue.items()},
        kernels={name[:60]: (ms, n) for ms, name, n in top[:12]})
    say(f"[14 split path] one dispatch under torch.profiler: wall {wall:.2f} ms, "
        f"device busy {busy:.2f} ms ({busy / wall * 100:.1f}%); torch gathers "
        f"{x_profile['gathers_ms']:.3f} ms in {x_profile['gathers_launches']} launches, "
        f"scans {x_profile['scans_ms']:.3f} ms in {x_profile['scans_launches']}; top: "
        + "; ".join(f"{name[:40]} x{n} {ms:.3f} ms" for ms, name, n in top))
    ext.reset_launches()
    k4 = split_kernels(mws, xcfg, muv, mact, mcam, "14 split path")
    k4p = phase1_1080p("14 split path", xcfg)
    k4c = cont_1080p("14 split path", xcfg, k4)
    # split_bounce 1: ~1.07M live rays, more than the persistent grid's lanes
    x1 = xcfg.replace(split_bounce=1)
    k4b1 = split_kernels(mws, x1, muv, mact, mcam, "14 split path")
    k4b1c = cont_1080p("14 split path", x1, k4b1)
    ph1_budget = megakernel.sample_budget("phase1")
    say(f"[14 split path] phase 1's budget: {ph1_budget}")
    require(ph1_budget["threads"] == megakernel.K1_THREADS,
            "phase 1's block is not megakernel.K1_THREADS")
    c4 = mcfg.replace(spp=4)
    k1_4, k1_4rays = render_radiance_with_stats(marrays, mcam, c4)
    for knobs in (dict(split_bounce=3),
                  dict(split_bounce=2, split_rebin="octant", split_every=True)):
        a, ar_ = render_radiance_with_stats(marrays, mcam, c4.replace(**knobs))
        amax, amean = frame_diff(a, k1_4)
        say(f"[14 split path] 1080p/4 spp {knobs} vs K1: max abs {amax:.3e}, mean abs "
            f"{amean:.3e}, rays {int(ar_)} vs {int(k1_4rays)}")
        require(amax <= 1e-5 and amean <= 1e-6 and int(ar_) == int(k1_4rays),
                f"split {knobs} vs K1 at 4 spp")
    k4_err = max(k4_err, k4["ph1"][3], k4["cont"][3], xmax)

    # ---- 15 K9: octant-masked bounce walks ----
    ocfg = mcfg.replace(octant_bounce_walks=True)
    render_radiance_with_stats(marrays, mcam, ocfg)  # warm-up
    torch.cuda.synchronize()
    ext.reset_launches()
    (oimg, orays), _ = timed(
        lambda: render_radiance_with_stats(marrays, mcam, ocfg), torch)
    olaunches = dict(ext.LAUNCHES)
    omax, omean = frame_diff(oimg, kimg)
    say(f"[15 K9] 1920x1080 spp 64, octant bounce walks: vs K1's frame max abs "
        f"{omax:.3e}, mean abs {omean:.3e}, rays {int(orays)} vs {int(krays)}; "
        f"launches {olaunches}")
    require(omax <= 1e-6 and int(orays) == int(krays), "K9 frame vs K1")
    require(bool(torch.equal(oimg, kimg)), "K9 frame not K1's bit for bit")
    require(olaunches["sample_wave_octant"] >= 1 and olaunches["sample_wave"] == 0,
            "K9 was not launched on its main path")
    runs = {"K9": ocfg, "K1": mcfg}
    ab = {k: [] for k in runs}
    for order in (("K9", "K1"), ("K1", "K9")) * 3:
        for name in order:
            _, ms = timed(lambda: render_radiance_with_stats(
                marrays, mcam, runs[name]), torch)
            ab[name].append(ms)
    k9_turns = {k: statistics.median(v) for k, v in ab.items()}
    say(f"[15 K9] in turns on {kind} ({smi}): " + "; ".join(
        f"{name} median {statistics.median(ts):.2f} ms, best {min(ts):.2f} ms, "
        f"{int(orays) / statistics.median(ts) / 1e3:.1f} Mrays/s median "
        f"({', '.join(f'{t:.2f}' for t in ts)})" for name, ts in ab.items()))
    ext.reset_launches()
    k9_err = 0.0
    for rng in ("threefry", "reference"):
        c15 = scfg.replace(rng=rng, octant_bounce_walks=True)
        k = megakernel.sample_wave(sws, c15, suv, sact, scam, 0, 0, 5, 1)
        p = megakernel.sample_wave_reference(sws, c15, suv, sact, scam, 0, 0, 5, 1)
        k9_err = max(k9_err, k1_compare("15 K9", rng, k, p, 256, 192, 1, "K9"))
    o1 = mcfg.replace(octant_bounce_walks=True)
    k = megakernel.sample_wave(mws, o1, muv, mact, mcam, 0, 0, 5, 1)
    p, p9_ms, k9_work = counted(lambda w: megakernel.sample_wave_reference(
        mws, o1, muv, mact, mcam, 0, 0, 5, 1, work=w), torch, walk)
    k9_err = max(k9_err, k1_compare("15 K9", o1.rng, k, p, 1920, 1080, 1, "K9"))
    k9_ms = cuda_ms(lambda: megakernel.sample_wave(
        mws, o1, muv, mact, mcam, 0, 0, 5, 1), 5, torch)
    k1_1spp_ms = cuda_ms(lambda: megakernel.sample_wave(
        mws, mcfg, muv, mact, mcam, 0, 0, 5, 1), 5, torch)
    say(f"[15 K9] 1080p/1 spp alone: K9 {k9_ms:.3f} ms vs plain {p9_ms:.2f} ms, K1 "
        f"{k1_1spp_ms:.3f} ms")
    # K9 alone at the dispatch's 1080p/64 spp and at the field's 1080p/4 spp
    # (tiered), and the K9 forms' compiled budget
    o64 = mcfg.replace(octant_bounce_walks=True)
    k9_64_ms = cuda_ms(lambda: megakernel.sample_wave(
        mws, o64, muv, mact, mcam, 0, 0, 5, 64), 3, torch)
    t9f = fcfg.replace(octant_bounce_walks=True)
    k9t_1080_ms = cuda_ms(lambda: megakernel.sample_wave(
        fws, t9f, fuv, fact, fcam, 0, 0, 5, 4), 3, torch)
    say(f"[15 K9] K9 alone on {kind} ({smi}): 1080p/64 spp {k9_64_ms:.2f} ms (K1 "
        f"{k1_ms:.2f} ms, phase 7); tiered, field 1080p/4 spp {k9t_1080_ms:.2f} ms "
        f"(the tiered K1 {k1t_1080_ms:.2f} ms, phase 11)")
    budget9, line = budget_line(("octant", "tiered_octant", "wide_octant"))
    say("[15 K9] K9 forms' budget: " + line)
    lanes9 = lane_utilisation("15 K9", "K9, demo 1080p/64 spp", mws, o64, muv, mact,
                              mcam, 64)
    lanes9t = lane_utilisation("15 K9", "tiered K9, field 1080p/4 spp", fws, t9f, fuv,
                               fact, fcam, 4)
    # K9's phase 1 and continuation alone: at 256x192 and at the split
    # path's 1080p shapes
    split_kernels(sws, scfg.replace(split_bounce=2, octant_bounce_walks=True),
                  suv, sact, scam, "15 K9")
    k9x = split_kernels(mws, xcfg.replace(octant_bounce_walks=True), muv, mact,
                        mcam, "15 K9")
    k9xp = phase1_1080p("15 K9", xcfg.replace(octant_bounce_walks=True))
    k9xc = cont_1080p("15 K9", xcfg.replace(octant_bounce_walks=True), k9x)
    # the tiered K9 at 160x90
    huv, hact = field_grid(160, 90)
    t9 = fcfg.replace(width=160, height=90, spp=1, octant_bounce_walks=True)
    k = megakernel.sample_wave(fws, t9, huv, hact, fcam, 0, 0, 5, 1)
    p, p9t_ms, k9t_work = counted(lambda w: megakernel.sample_wave_reference(
        fws, t9, huv, hact, fcam, 0, 0, 5, 1, work=w), torch, walk)
    k9t_err = k1_compare("15 K9", t9.rng, k, p, 160, 90, 1, "tiered K9")
    k9t_ms = cuda_ms(lambda: megakernel.sample_wave(
        fws, t9, huv, hact, fcam, 0, 0, 5, 1), 5, torch)
    k1t_160_ms = cuda_ms(lambda: megakernel.sample_wave(
        fws, t9.replace(octant_bounce_walks=False), huv, hact, fcam, 0, 0, 5, 1), 5,
        torch)
    say(f"[15 K9] tiered K9, field 160x90/1 spp: {k9t_ms:.3f} ms vs plain "
        f"{p9t_ms:.2f} ms; the tiered K1 {k1t_160_ms:.3f} ms")
    k9_standalone = dict(ext.LAUNCHES)
    require(all(k9_standalone[k] >= 1 for k in (
        "sample_wave_octant", "sample_wave_tiered_octant",
        "sample_wave_phase1_octant", "continuation_octant")),
        "a K9 instantiation was never launched in phase 15")
    # K9's two other paths, each driven through the entry point with the
    # counts at 0 just before: the split frame with octant walks (against
    # K1's 4-spp frame) and the field frame (against the tiered K1's)
    k9_paths = {}
    for tag, arrs, cam_, c9, (ref, ref_rays), expect in (
            ("split", marrays, mcam, c4.replace(split_bounce=2, split_rebin="octant",
                                                octant_bounce_walks=True),
             (k1_4, k1_4rays),
             {"sample_wave_phase1_octant": 4, "continuation_octant": 4}),
            ("field", farrays, fcam, fcfg.replace(octant_bounce_walks=True),
             (fimg, frays), {"sample_wave_tiered_octant": 1})):
        ext.reset_launches()
        im, r = render_radiance_with_stats(arrs, cam_, c9)
        k9_paths[tag] = got = dict(ext.LAUNCHES)
        dmax, dmean = frame_diff(im, ref)
        say(f"[15 K9] {tag} path, 1080p/4 spp with octant bounce walks: vs "
            f"{'K1' if tag == 'split' else 'the tiered K1'} max abs {dmax:.3e}, mean "
            f"abs {dmean:.3e}, rays {int(r)} vs {int(ref_rays)}; launches "
            f"{ {k: v for k, v in got.items() if v} }")
        require(dmax <= 1e-5 and dmean <= 1e-6 and int(r) == int(ref_rays),
                f"K9 {tag} frame")
        if tag == "field":  # the warp-tiled lockstep K9 form: the tiered K1's bits
            require(bool(torch.equal(im, ref)), "tiered K9 frame not the tiered K1's")
        require(all(got[k] == v for k, v in expect.items()), f"K9 {tag} path launches")

    def frame_gate(tag, what, a, ar_, b, br_):
        """Hold a frame to a reference frame with the golden bars (SSIM >=
        0.995, mean abs < 2e-3) and ray counts within 0.1% (k1_compare's bar:
        another walk order may resolve a box-rounding edge case on another
        triangle and send a path elsewhere); report the max abs and the
        pixels that differ."""
        d = (a - b).abs()
        s_ = ssim(a.cpu().numpy(), b.cpu().numpy())
        ndiff = int((d.amax(-1) > 0).sum())
        say(f"[{tag}] {what}: SSIM {s_:.6f}, mean abs {d.mean().item():.3e}, max abs "
            f"{d.max().item():.3e}, pixels that differ {ndiff} "
            f"({ndiff / d[..., 0].numel() * 100:.4f}%), rays {int(ar_)} vs {int(br_)}")
        require(s_ >= 0.995 and d.mean().item() < 2e-3, f"{tag}: {what}")
        require(abs(int(ar_) - int(br_)) <= 0.001 * int(br_), f"{tag}: {what} rays")
        return d.max().item()

    def in_turns(tag, runs, arrays_, cam_):
        """Dispatches of each config in turns (a, b, b, a, and so for more
        configs) x 3; the medians."""
        ab_ = {k: [] for k in runs}
        names = list(runs)
        render_radiance_with_stats(arrays_, cam_, runs[names[0]])  # warm-up
        for order in (tuple(names), tuple(reversed(names))) * 3:
            for name in order:
                (_, r), ms = timed(lambda: render_radiance_with_stats(
                    arrays_, cam_, runs[name]), torch)
                ab_[name].append(ms)
        say(f"[{tag}] in turns on {kind} ({smi}): " + "; ".join(
            f"{name} median {statistics.median(ts):.2f} ms, best {min(ts):.2f} ms "
            f"({', '.join(f'{t:.2f}' for t in ts)})" for name, ts in ab_.items()))
        return {k: statistics.median(v) for k, v in ab_.items()}

    def knob_phase(tag, knobs, kernel, closest, plain_closest, shadow,
                   plain_shadow, k1_name, forms, walk_kind=None):
        # k1_name: the launch count of the knob's K1 instantiation; forms:
        # the budget names of it and of its K9 form; walk_kind: the
        # standalone walk's kind for its counting form and budget
        # (walk.live_lane_counts, walk.LIVE_FORMS), where it has them, and
        # then it must equal its plain version bit for bit
        """Phases 16 (K5) and 17 (K6): the standalone walks against their
        plain versions and against K2/K3 at the demo's 1080p rays, the K1
        form and its K9 form against their plain versions, their budgets and
        walk-loop lane utilisation, the golden gates,
        the 1080p/64 spp frame and the field frame (tiered="off") against
        K1's, timed in turns. Returns the numbers of the kernel rows."""
        out = {}
        ext.reset_launches()
        # the closest walk at the 1080p primary rays
        k_out = closest(mws, mo, md_, mact)
        kt, ktri = k_out[0], k_out[1]
        p_out, p_ms, c_work = counted(
            lambda w: plain_closest(mws, mo, md_, mact, work=w), torch, walk)
        pt_, ptri_ = p_out[0], p_out[1]
        c_ms = cuda_ms(lambda: closest(mws, mo, md_, mact), 10, torch)
        same, t_rel, t_abs = hits_agree(kt, ktri, pt_, ptri_)
        exact = all(bool(torch.equal(a, b)) for a, b in zip(k_out, p_out))
        walk_stats = {}
        if walk_kind:
            require(exact, f"{kernel} closest differs from its plain version")
            c_o, a_, sl_ = walk.live_lane_counts(mws, mo, md_, mact, kind=walk_kind,
                                                 width=1920, height=1080)
            require(all(bool(torch.equal(a, b)) for a, b in zip(c_o, k_out)),
                    f"the counting {kernel} found other hits")
            walk_stats = dict(budget={m: walk.live_budget(f"{m}_{walk_kind}")
                                      for m in ("closest", "shadow")},
                              closest_lanes=a_ / sl_)
            say(f"[{tag}] {kernel} standalone budget {walk_stats['budget']} "
                f"(ptxas: " + "; ".join(
                    f"{m} {ptxas.get(f'{walk_kind}_walk_kernel<{m}>')}"
                    for m in ("closest", "shadow")) + f"); closest walk-loop lane "
                f"utilisation {a_ / sl_:.4f} ({a_} of {sl_})")
            require(all(b["threads"] == 128 and b["regs"] <= 64
                        and b["warps_per_sm"] >= 32
                        for b in walk_stats["budget"].values()), f"{kernel}'s budget")
        h2 = mhit.tri >= 0
        t_eq = bool(torch.equal(kt[h2], mhit.t[h2]))
        other = (ktri != mhit.tri) & h2
        ties = int((other & (kt == mhit.t)).sum())
        extra, lost = int(((ktri >= 0) & ~h2).sum()), int(((ktri < 0) & h2).sum())
        say(f"[{tag}] {kernel} closest vs plain, 1080p primary: same tri "
            f"{same * 100:.4f}%, t max rel err {t_rel:.3e}, bit-equal {exact}; "
            f"{c_ms:.3f} ms vs plain {p_ms:.2f} ms, K2 {k2_ms:.3f} ms")
        say(f"[{tag}] {kernel} closest vs K2: t bit-equal on all {int(h2.sum())} rays "
            f"K2 hits {t_eq}; other triangle on {int(other.sum())} rays ({ties} exact-t "
            f"ties); hits K2 lacks {extra}, K2 hits it lacks {lost}")
        require(same >= 0.9999 and t_rel <= 1e-5, f"{kernel} closest vs plain")
        require(t_eq and ties == int(other.sum()) and lost == 0,
                f"{kernel} closest vs K2: t not bit-equal, or a non-tie triangle")
        # incoherent rays, as a bounce's: from the primary hits in seeded
        # random directions, K2 and this walk in turns
        g = torch.Generator(device=dev).manual_seed(5)
        rd = torch.randn(mo.shape, generator=g, device=dev)
        rd = rd / rd.norm(dim=1, keepdim=True)
        ro = mhit.point + rd * 1e-3
        i2 = walk.closest_walk(mws, ro, rd, mhit.found)
        ik = closest(mws, ro, rd, mhit.found)
        ih = i2[1] >= 0
        i_ms = [cuda_ms(lambda: fn(mws, ro, rd, mhit.found), 10, torch)
                for fn in (walk.closest_walk, closest, closest, walk.closest_walk)]
        say(f"[{tag}] {kernel} closest on incoherent rays ({int(mhit.found.sum())} rays "
            f"from the primary hits, random directions): {kernel} "
            f"{(i_ms[1] + i_ms[2]) / 2:.3f} ms, K2 {(i_ms[0] + i_ms[3]) / 2:.3f} ms "
            f"(in turns: {', '.join(f'{t:.3f}' for t in i_ms)}); t bit-equal on the rays "
            f"K2 hits {bool(torch.equal(ik[0][ih], i2[0][ih]))}, other triangle on "
            f"{int(((ik[1] != i2[1]) & ih).sum())}")
        out["walk"] = walk_stats
        out["closest"] = dict(ms=c_ms, plain_ms=p_ms, work=c_work, err=t_abs,
                              ties=ties, extra=extra,
                              incoherent_ms=(i_ms[1] + i_ms[2]) / 2,
                              k2_incoherent_ms=(i_ms[0] + i_ms[3]) / 2)
        # the shadow walk at the rays toward each light
        s_err = 0.0
        for i, (so, sd, sm, sa) in enumerate(shadow_rays(mws, mhit)):
            kv, kr = shadow(mws, so, sd, sm, sa)
            pv, pms, work = counted(
                lambda w: plain_shadow(mws, so, sd, sm, sa, work=w), torch, walk)
            kms = cuda_ms(lambda: shadow(mws, so, sd, sm, sa), 10, torch)
            v3, _ = walk.shadow_walk_bvh2(mws, so, sd, sm, sa)
            lit = kv > 0.05
            # vs plain on every ray; vs K3 where vis ends above min_vis (a
            # K6 packet stops only when all its rays are at or below it)
            e_p = (kv - pv).abs().max().item()
            e_3 = (kv - v3).abs()[lit].max().item() if lit.any() else 0.0
            m_3 = bool(torch.equal(lit, v3 > 0.05))
            s_err = max(s_err, e_p)
            if walk_kind:
                require(bool(torch.equal(kv, pv)),
                        f"{kernel} shadow differs from its plain version (light {i})")
            if i == 0:  # the point light
                out["shadow"] = dict(ms=kms, plain_ms=pms, work=work)
                if walk_kind:
                    cv, a_, sl_ = walk.live_lane_counts(
                        mws, so, sd, sa, kind=walk_kind, max_dist=sm, width=1920,
                        height=1080)
                    require(bool(torch.equal(cv, kv)),
                            f"the counting {kernel} shadow walk differs")
                    walk_stats["shadow_lanes"] = a_ / sl_
                    say(f"[{tag}] {kernel} shadow walk-loop lane utilisation, light "
                        f"0: {a_ / sl_:.4f} ({a_} of {sl_})")
            say(f"[{tag}] {kernel} shadow, 1080p light {i}: vis max abs err vs plain "
                f"{e_p:.3e}; vis > 0.05 mask equal to K3's {m_3}, max abs err vs K3 "
                f"where > 0.05 {e_3:.3e}; {int(kr)} rays, {int(lit.sum())} lit; "
                f"{kms:.3f} ms vs plain {pms:.2f} ms, K3 {k3_ms:.3f} ms (light 0)")
            require(e_p <= 1e-6 and m_3 and e_3 <= 1e-6,
                    f"{kernel} shadow vs plain / K3 (light {i})")
        out["shadow"]["err"] = s_err
        # the K1 instantiation vs plain: 256x192 (both flows), 1080p/1 spp
        k1e = 0.0
        for rng in ("threefry", "reference"):
            c = cfg.replace(rng=rng, **knobs)
            k = megakernel.sample_wave(ws, c, uv, act, camp, 0, 0, 5, 1)
            p = megakernel.sample_wave_reference(ws, c, uv, act, camp, 0, 0, 5, 1)
            k1e = max(k1e, k1_compare(tag, rng, k, p, 256, 192, 1, k1_name))
        # the form and its K9 form at 1080p/1 spp (the K6 forms' plain
        # version walks its packets as the kernel's warps, so the two must
        # agree to float rounding), then each alone at the dispatch's 64 spp,
        # with its budget and lane utilisation
        k1e = {"": k1e, "_octant": 0.0}
        budget_, line = budget_line(forms)
        say(f"[{tag}] {k1_name} forms' budget: " + line)
        for sfx, c1, form in (
                ("", mcfg.replace(**knobs), forms[0]),
                ("_octant", mcfg.replace(octant_bounce_walks=True, **knobs), forms[1])):
            k = megakernel.sample_wave(mws, c1, muv, mact, mcam, 0, 0, 5, 1)
            p, p1_ms_, w1 = counted(lambda w: megakernel.sample_wave_reference(
                mws, c1, muv, mact, mcam, 0, 0, 5, 1, work=w), torch, walk)
            mx = k1_compare(tag, c1.rng, k, p, 1920, 1080, 1, k1_name + sfx)
            k1e[sfx] = max(k1e[sfx], mx)
            if knobs.get("frustum_primary"):
                require(mx <= 1e-6 and int(k[1]) == int(p[1]),
                        f"{tag}: {k1_name + sfx} vs plain at 1080p/1 spp")
            k1_ms_ = cuda_ms(lambda: megakernel.sample_wave(
                mws, c1, muv, mact, mcam, 0, 0, 5, 1), 5, torch)
            ms64 = cuda_ms(lambda: megakernel.sample_wave(
                mws, c1, muv, mact, mcam, 0, 0, 5, 64), 3, torch)
            say(f"[{tag}] 1080p/1 spp alone: {k1_name + sfx} {k1_ms_:.3f} ms vs plain "
                f"{p1_ms_:.2f} ms, K1 {k1_1spp_ms:.3f} ms; 1080p/64 spp alone "
                f"{ms64:.2f} ms (K1 {k1_ms:.2f} ms, phase 7)")
            lanes = lane_utilisation(tag, f"{k1_name + sfx}, demo 1080p/64 spp", mws,
                                     c1, muv, mact, mcam, 64)
            out["k1" + sfx] = dict(ms=k1_ms_, plain_ms=p1_ms_, work=w1, err=k1e[sfx],
                                   ms_64spp=ms64, lanes=lanes, budget=budget_.get(form))
        out["standalone"] = dict(ext.LAUNCHES)
        # the golden gates, for the form and its K9 form
        for w_, h_, name in ((256, 192, "demo_256x192.npz"),
                             (800, 600, "demo_reference_800x600.npz")):
            golden = np.load(os.path.join(HERE, "tests", "golden", name))["image"]
            golden = golden.astype(np.float32)
            for kn in (knobs, dict(octant_bounce_walks=True, **knobs)):
                gcfg_, _gs, garr, gcam_ = scene_setup(w_, h_, **kn)
                img_, _ = render_radiance_with_stats(garr, gcam_, gcfg_)
                img_ = img_.cpu().numpy()
                s_, mabs = ssim(img_, golden), float(np.abs(img_ - golden).mean())
                say(f"[{tag}] gate {w_}x{h_} vs {name} with {kn}: SSIM {s_:.4f}, "
                    f"mean abs {mabs:.3e}")
                require(s_ >= 0.995 and mabs < 2e-3, f"{tag} golden gate {w_}x{h_}")
        # the main path with the knob: one dispatch with its launch counts,
        # its frame against K1's, then timed in turns with K1
        kcfg = mcfg.replace(**knobs)
        render_radiance_with_stats(marrays, mcam, kcfg)  # warm-up
        torch.cuda.synchronize()
        ext.reset_launches()
        (img_, rays_), _ = timed(lambda: render_radiance_with_stats(
            marrays, mcam, kcfg), torch)
        out["launches"] = got = dict(ext.LAUNCHES)
        say(f"[{tag}] 1920x1080 spp 64 with {knobs}: launches "
            f"{ {k: v for k, v in got.items() if v} }")
        require(img_.shape == (1080, 1920, 3) and bool(torch.isfinite(img_).all()),
                f"{tag} frame shape or values")
        require(got[k1_name] == 1 and sum(got.values()) == 1,
                f"{tag} main-path launches")
        out["frame_err"] = frame_gate(tag, "1080p/64 spp frame vs K1's", img_, rays_,
                                      kimg, krays)
        # with octant bounce walks, once with its launch counts
        ocfg_ = kcfg.replace(octant_bounce_walks=True)
        ext.reset_launches()
        oi, orr = render_radiance_with_stats(marrays, mcam, ocfg_)
        got = {k: v for k, v in ext.LAUNCHES.items() if v}
        say(f"[{tag}] 1080p/64 spp with {knobs} and octant bounce walks: launches {got}")
        require(got == {k1_name + "_octant": 1}, f"{tag} octant launches")
        out["octant_launches"] = got.get(k1_name + "_octant", 0)
        frame_gate(tag, "1080p/64 spp octant frame vs K1's", oi, orr, kimg, krays)
        if not knobs.get("frustum_primary"):  # K9 takes its view's K1 walks
            require(bool(torch.equal(oi, img_)) and int(orr) == int(rays_),
                    f"{tag}: the K9 form's frame is not its K1 form's bit for bit")
        out["turns"] = in_turns(tag, {k1_name: kcfg, k1_name + "_octant": ocfg_,
                                      "K1": mcfg}, marrays, mcam)
        # the field, whole tree (tiered="off"), 1080p/4 spp
        fk = wcfg.replace(**knobs)
        ext.reset_launches()
        fi, fr_ = render_radiance_with_stats(warrays, fcam, fk)
        out["field_launches"] = got = {k: v for k, v in ext.LAUNCHES.items() if v}
        fwi, fwr = render_radiance_with_stats(warrays, fcam, wcfg)
        say(f"[{tag}] field 1080p/4 spp (tiered='off') with {knobs}: launches {got}")
        require(got == {k1_name: 1}, f"{tag} field launches")
        frame_gate(tag, "field frame vs the whole-tree K1's", fi, fr_, fwi, fwr)
        out["field_turns"] = in_turns(tag + " field", {k1_name: fk, "K1": wcfg},
                                      warrays, fcam)
        return out

    # ---- 16 K5: wide nodes ----
    k5 = knob_phase("16 K5", dict(wide_nodes=True), "K5", walk.closest_walk_bvh8,
                    walk.wide_closest_walk_reference, walk.shadow_walk_bvh8,
                    walk.wide_shadow_walk_reference, "sample_wave_wide",
                    ("wide", "wide_octant"))
    # ---- 17 K6: the frustum primary walk ----
    # (the standalone K6 on the 1080p waves in K1's warp tiles, its packets)
    frame = dict(width=1920, height=1080)
    k6 = knob_phase("17 K6", dict(frustum_primary=True), "K6",
                    functools.partial(walk.closest_walk_frustum, **frame),
                    functools.partial(walk.frustum_closest_walk_reference, **frame),
                    functools.partial(walk.shadow_walk_frustum, **frame),
                    functools.partial(walk.frustum_shadow_walk_reference, **frame),
                    "sample_wave_frustum", ("frustum", "frustum_octant"),
                    walk_kind="frustum")
    # the frustum phase 1 of the split path, vs plain at 256x192 and driven
    # once through the entry point at 1080p/4 spp against K1's frame
    ext.reset_launches()
    k6x = split_kernels(sws, scfg.replace(split_bounce=2, frustum_primary=True),
                        suv, sact, scam, "17 K6")
    k6x_1080 = {}
    for sfx, kn in (("", {}), ("_octant", dict(octant_bounce_walks=True))):
        c6 = xcfg.replace(frustum_primary=True, **kn)
        k6x_1080[sfx] = dict(split_kernels(mws, c6, muv, mact, mcam, "17 K6"),
                             alone=phase1_1080p("17 K6", c6))
    k6x_standalone = dict(ext.LAUNCHES)
    require(k6x_standalone["sample_wave_phase1_frustum"] >= 1
            and k6x_standalone["sample_wave_phase1_frustum_octant"] >= 1,
            "a frustum phase 1 was never launched")
    ext.reset_launches()
    xi, xr = render_radiance_with_stats(marrays, mcam, c4.replace(
        split_bounce=2, split_rebin="octant", frustum_primary=True))
    k6x_path = {k: v for k, v in ext.LAUNCHES.items() if v}
    say(f"[17 K6] split path, 1080p/4 spp with the frustum primary: launches {k6x_path}")
    require(k6x_path == {"sample_wave_phase1_frustum": 4, "continuation": 4},
            "frustum split path launches")
    frame_gate("17 K6", "split frame vs K1's (4 spp)", xi, xr, k1_4, k1_4rays)

    # ---- 18 the per-wave path: K7 and the staged kernels= variants ----
    # K7 vs plain at the demo's 256x192 primary rays and shadow rays
    ext.reset_launches()
    s7cfg, _s7, s7arrays, s7cam = scene_setup(256, 192)
    s7ws = world_geometry(s7arrays)
    s7o, s7d = primary_rays(256, 192, s7cam)
    s7act = torch.ones(s7o.shape[0], dtype=torch.bool, device=dev)
    _, s7uv = pixel_grid(256, 192, dev)
    k7 = walk.closest_walk_misslink(s7ws, s7o, s7d, s7act, 256, 192)
    p7 = walk.misslink_closest_walk_reference(s7ws, s7o, s7d, s7act)
    k7_exact = all(torch.equal(a, b) for a, b in zip(k7, p7))
    say(f"[18 K7] K7 closest vs plain, 256x192 primary: same tri "
        f"{bool(torch.equal(k7[1], p7[1]))}, t bit-equal {bool(torch.equal(k7[0], p7[0]))}, "
        f"all outputs bit-equal to plain {k7_exact}, hits {int((k7[1] >= 0).sum())}")
    require(k7_exact, "K7 closest vs plain (256x192)")
    s7hit = walk.decode_hit(s7ws, s7o, s7d, *k7)
    for i, (so, sd, sm, sa) in enumerate(shadow_rays(s7ws, s7hit)):
        kv, kr = walk.shadow_walk_misslink(s7ws, so, sd, sm, sa, width=256, height=192)
        pv = walk.misslink_shadow_walk_reference(s7ws, so, sd, sm, sa)
        same = bool(torch.equal(kv, pv))
        say(f"[18 K7] K7 shadow vs plain, 256x192 light {i}: vis exact {same}, "
            f"{int(kr)} rays, {int((kv < 1).sum())} shadowed")
        require(same, f"K7 shadow vs plain (256x192, light {i})")

    # K7 at the main path's 1080p primary, shadow and incoherent rays: vs
    # K2/K3, timed in turns with them; the plain walk counts K7's work
    def vs_k2(a, b):
        """(rays with another triangle, of which exact-t ties, t bit-equal
        where the triangle is the same)."""
        other = a[1] != b[1]
        same = ~other
        return (int(other.sum()), int((other & (a[0] == b[0])).sum()),
                bool(torch.equal(a[0][same], b[0][same])))

    # K7 on whole 1080p waves: the rays taken in warp tiles, as on its path
    def k7_closest(ws_, o_, d_, a_):
        return walk.closest_walk_misslink(ws_, o_, d_, a_, 1920, 1080)

    def k7_shadow(ws_, o_, d_, md__, a_):
        return walk.shadow_walk_misslink(ws_, o_, d_, md__, a_, width=1920, height=1080)

    k7c = k7_closest(mws, mo, md_, mact)
    (p7c, p7c_ms, k7_work) = counted(
        lambda w: walk.misslink_closest_walk_reference(mws, mo, md_, mact, work=w),
        torch, walk)
    require(torch.equal(k7c[1], p7c[1]) and torch.equal(k7c[0], p7c[0]),
            "K7 closest vs plain (1080p)")
    k2c = walk.closest_walk(mws, mo, md_, mact)
    n_other, n_ties, t_eq = vs_k2(k7c, k2c)
    t7 = [cuda_ms(lambda: fn(mws, mo, md_, mact), 10, torch)
          for fn in (walk.closest_walk, k7_closest, k7_closest, walk.closest_walk)]
    k7_ms, k2_turn_ms = (t7[1] + t7[2]) / 2, (t7[0] + t7[3]) / 2
    say(f"[18 K7] 1080p primary ({mo.shape[0]} rays) on {kind} ({smi}): K7 "
        f"{k7_ms:.3f} ms, K2 {k2_turn_ms:.3f} ms (in turns: "
        f"{', '.join(f'{t:.3f}' for t in t7)}); plain K7 {p7c_ms:.2f} ms; vs K2: "
        f"another triangle on {n_other} rays ({n_ties} exact-t ties), t bit-equal "
        f"where the triangle is the same {t_eq}; work {k7_work}")
    require(t_eq and n_other <= 1e-4 * mo.shape[0], "K7 vs K2 at 1080p primary")
    k7s_ms = p7s_ms = None
    for i, (so, sd, sm, sa) in enumerate(shadow_rays(mws, mhit)):
        kv, _ = k7_shadow(mws, so, sd, sm, sa)
        v3, _ = walk.shadow_walk_bvh2(mws, so, sd, sm, sa)
        ts = [cuda_ms(lambda: fn(mws, so, sd, sm, sa), 10, torch)
              for fn in (walk.shadow_walk_bvh2, k7_shadow, k7_shadow,
                         walk.shadow_walk_bvh2)]
        n_vis = int((kv != v3).sum())
        if i == 0:  # the point light: its plain walk counts the work
            pv, p7s_ms, k7s_work = counted(
                lambda w: walk.misslink_shadow_walk_reference(mws, so, sd, sm, sa,
                                                              work=w), torch, walk)
            require(torch.equal(kv, pv), "K7 shadow vs plain (1080p point light)")
            k7s_ms, k3_turn_ms = (ts[1] + ts[2]) / 2, (ts[0] + ts[3]) / 2
        say(f"[18 K7] 1080p light {i}: K7 shadow {(ts[1] + ts[2]) / 2:.3f} ms, K3 "
            f"{(ts[0] + ts[3]) / 2:.3f} ms (in turns: {', '.join(f'{t:.3f}' for t in ts)}); "
            f"vis differs from K3 on {n_vis} rays (max abs {(kv - v3).abs().max().item():.3e})")
        require(n_vis <= 1e-4 * so.shape[0], f"K7 shadow vs K3 (light {i})")
    g7 = torch.Generator(device=dev).manual_seed(7)
    rd = torch.randn(mo.shape, generator=g7, device=dev)
    rd = rd / rd.norm(dim=1, keepdim=True)
    ro = mhit.point + rd * 1e-3
    i7, i2 = (fn(mws, ro, rd, mhit.found) for fn in (k7_closest, walk.closest_walk))
    ip = walk.misslink_closest_walk_reference(mws, ro, rd, mhit.found)
    in_same = all(bool(torch.equal(a, b)) for a, b in zip(i7, ip))
    in_other, in_ties, in_teq = vs_k2(i7, i2)
    ti = [cuda_ms(lambda: fn(mws, ro, rd, mhit.found), 10, torch)
          for fn in (walk.closest_walk, k7_closest, k7_closest, walk.closest_walk)]
    k7_inc_ms, k2_inc_ms = (ti[1] + ti[2]) / 2, (ti[0] + ti[3]) / 2
    say(f"[18 K7] incoherent rays ({int(mhit.found.sum())} from the primary hits, "
        f"random directions): K7 {k7_inc_ms:.3f} ms, K2 {k2_inc_ms:.3f} ms (in turns: "
        f"{', '.join(f'{t:.3f}' for t in ti)}); bit for bit the plain version's "
        f"{in_same}; vs K2 another triangle on {in_other} rays "
        f"({in_ties} exact-t ties), t bit-equal where the same {in_teq}")
    require(in_same, "K7 vs plain on incoherent rays")
    require(in_teq and in_other <= 1e-4 * mo.shape[0], "K7 vs K2 on incoherent rays")
    k7_standalone = dict(ext.LAUNCHES)
    require(k7_standalone["closest_hit_misslink"] >= 1
            and k7_standalone["shadow_walk_misslink"] >= 1, "K7 was never launched")

    # K1 with sample fusion (sample_fuse=2) vs plain, 256x192, 4 spp
    fz = s7cfg.replace(rng="threefry", sample_fuse=2)
    k = megakernel.sample_wave(s7ws, fz, s7uv, s7act, s7cam, 0, 0, 5, 4)
    p = megakernel.sample_wave_reference(s7ws, fz, s7uv, s7act, s7cam, 0, 0, 5, 4)
    k1_compare("18 fuse", "threefry", k, p, 256, 192, 4, "K1 with sample_fuse=2")

    # the golden gates on the portable path and on the pallas-ml path, and
    # the staged variants against K1's frame at 256x192
    for w_, h_, name in ((256, 192, "demo_256x192.npz"),
                         (800, 600, "demo_reference_800x600.npz")):
        golden = np.load(os.path.join(HERE, "tests", "golden", name))["image"]
        golden = golden.astype(np.float32)
        gcfg_, _gs, garr, gcam_ = scene_setup(w_, h_)
        for kn in ("xla", "pallas-ml"):
            img_, _ = render_radiance_with_stats(garr, gcam_, gcfg_.replace(kernels=kn))
            img_ = img_.cpu().numpy()
            d_ = np.abs(img_ - golden)
            s_ = ssim(img_, golden)
            say(f"[18 gates] {w_}x{h_} kernels={kn} vs {name}: SSIM {s_:.6f}, mean abs "
                f"{d_.mean():.3e}, max abs {d_.max():.3e}, pixels > 1e-3 "
                f"{(d_.max(-1) > 1e-3).mean() * 100:.3f}%")
            require(s_ >= 0.995 and d_.mean() < 2e-3, f"{kn} golden gate {w_}x{h_}")
    gcfg_, _gs, garr, gcam_ = scene_setup(256, 192)
    ref256, ref256_rays = render_radiance_with_stats(garr, gcam_, gcfg_)  # K1
    for kn in ("pallas-ml", "pallas-bvh2", "pallas-nomega", "xla"):
        im_, r_ = render_radiance_with_stats(garr, gcam_, gcfg_.replace(kernels=kn))
        frame_gate("18 staged", f"256x192 kernels={kn} vs K1's frame", im_, r_,
                   ref256, ref256_rays)

    # the slice's path at full width: the demo at 1080p/64 spp through
    # render_radiance_with_stats with kernels="pallas-ml"
    # (three 64-spp dispatches in all, ~5.5 s each: the warm-up, one timed
    # dispatch, and the evented one below)
    mlcfg = mcfg.replace(kernels="pallas-ml")
    (_, warm_rays), warm_ms = timed(lambda: render_radiance_with_stats(
        marrays, mcam, mlcfg), torch)
    ext.reset_launches()
    (mlimg, r_), ml_ms = timed(lambda: render_radiance_with_stats(
        marrays, mcam, mlcfg), torch)
    ml_launches = dict(ext.LAUNCHES)
    ml_rays = {int(warm_rays), int(r_)}
    n_disp = 1
    got = {k: v for k, v in ml_launches.items() if v}
    ml_rays_pd = int(r_)
    say(f"[18 pallas-ml] 1920x1080 spp 64, 5 bounces, kernels='pallas-ml' on {kind} "
        f"({smi}): {ml_ms:.2f} ms per dispatch (one timed dispatch; the warm-up "
        f"{warm_ms:.2f} ms); {ml_rays_pd} rays per dispatch, "
        f"{ml_rays_pd / ml_ms / 1e3:.1f} Mrays/s; launches {got}")
    require(mlimg.shape == (1080, 1920, 3) and bool(torch.isfinite(mlimg).all()),
            "pallas-ml frame shape or values")
    require(len(ml_rays) == 1, "pallas-ml ray count differs between dispatches")
    n_lights = int(mws.lights.shape[0])
    require(set(got) == {"closest_hit_misslink", "shadow_walk_misslink"},
            "the pallas-ml path launched another kernel than K7")
    require(ml_launches["shadow_walk_misslink"] == n_disp * 64 * n_lights,
            "K7 shadow: not one launch per light per sample")
    require(64 * n_disp < ml_launches["closest_hit_misslink"] <= 5 * 64 * n_disp,
            "K7 closest: not one launch per live bounce wave per sample")
    frame_gate("18 pallas-ml", "1080p/64 spp frame vs K1's", mlimg, ml_rays_pd,
               kimg, krays)
    # K7's own time in a 64-spp dispatch: one more dispatch whose K7 entry
    # point calls each sit between two CUDA events on the launch stream.
    # The device may wait for the host there (this path is host-bound), and
    # then the host's time from the first event to the launch counts too.
    spans = []

    class K7Events:
        """ext.lib() with each K7 entry point call between two CUDA events."""

        def __init__(self, lib_):
            self._lib = lib_

        def __getattr__(self, name):
            fn = getattr(self._lib, name)
            if name not in ("rz_closest_misslink", "rz_shadow_misslink"):
                return fn

            def run(*args):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                err = fn(*args)
                ev[1].record()
                spans.append((name, ev))
                return err
            return run

    ext.reset_launches()
    with using(K7Events(ext.lib())):
        evimg, evrays = render_radiance_with_stats(marrays, mcam, mlcfg)
    torch.cuda.synchronize()
    ev_launches = {k: v for k, v in ext.LAUNCHES.items() if v}
    require(ev_launches == {k: v // n_disp for k, v in got.items()}
            and len(spans) == sum(ev_launches.values()),
            f"the evented pallas-ml dispatch's K7 launches: {ev_launches}")
    require(bool(torch.equal(evimg, mlimg)) and int(evrays) == ml_rays_pd,
            "the evented pallas-ml dispatch rendered another frame")
    # a sample's K7 launches: closest bounce 0, shadow lights 0..L-1, closest
    # bounces 1..4 (every bounce of this frame has live rays)
    classes = (["closest bounce 0"] + [f"shadow light {i}" for i in range(n_lights)]
               + [f"closest bounce {b}" for b in range(1, 5)])
    require(len(spans) == 64 * len(classes), "a sample's K7 launches are not "
            f"{len(classes)}: {len(spans)} in 64 samples")
    k7_dispatch = {c: 0.0 for c in classes}
    for i, (name, ev) in enumerate(spans):
        c = classes[i % len(classes)]
        require(name == ("rz_closest_misslink" if c.startswith("closest")
                         else "rz_shadow_misslink"), f"K7 launch {i} is not {c}")
        k7_dispatch[c] += ev[0].elapsed_time(ev[1])
    k7_dispatch_closest = sum(v for c, v in k7_dispatch.items() if c.startswith("closest"))
    k7_dispatch_shadow = sum(v for c, v in k7_dispatch.items() if c.startswith("shadow"))
    say(f"[18 pallas-ml] K7 in one 1080p/64 spp dispatch (CUDA events around each "
        f"of its {len(spans)} launches) on {kind} ({smi}): closest "
        f"{k7_dispatch_closest:.2f} ms in {ev_launches['closest_hit_misslink']} "
        f"launches, shadow {k7_dispatch_shadow:.2f} ms in "
        f"{ev_launches['shadow_walk_misslink']}; by wave class (64 launches each): "
        + ", ".join(f"{c} {v:.2f}" for c, v in k7_dispatch.items()))
    # the breakdown of a 4-spp dispatch: each sample runs the same walks and
    # glue, and a 64-spp trace holds ~290k kernels, too many to process here
    wall, busy, top = profile_dispatch(
        lambda: render_radiance_with_stats(marrays, mcam, mlcfg.replace(spp=4)),
        torch, out_dir and os.path.join(out_dir, "pallas_ml_trace.json"))
    k7_rows = [(ms, n) for ms, name, n in top if "live_walk_kernel" in name]
    k7_dev = sum(ms for ms, _n in k7_rows)
    ml_profile = dict(spp=4, wall_ms=wall, device_busy_ms=busy, k7_ms=k7_dev,
                      k7_launches=sum(n for _ms, n in k7_rows), glue_ms=busy - k7_dev,
                      glue_launches=sum(n for _ms, _name, n in top)
                      - sum(n for _ms, n in k7_rows))
    say(f"[18 pallas-ml] one 4-spp dispatch under torch.profiler: wall {wall:.2f} ms, "
        f"device busy {busy:.2f} ms ({busy / wall * 100:.1f}%), K7 "
        f"{k7_dev:.2f} ms in {ml_profile['k7_launches']} launches, torch glue "
        f"{busy - k7_dev:.2f} ms in {ml_profile['glue_launches']} launches; top: "
        + "; ".join(f"{name[:40]} x{n} {ms:.3f} ms" for ms, name, n in top[:8]))

    # The live-ray walks at the shapes their paths launch: the waves of one
    # sample of the 1080p dispatch (5 closest, one per bounce; 2 shadow, one
    # per light), recorded at the wrappers, each walked by the kernel and by
    # the plain version (bit for bit), the kernel timed alone (medians of 6)
    # with its walk-loop lane utilisation and bound: K7 on the pallas-ml
    # path, K2/K3 on the pallas-bvh2 path
    def record_waves(closest_name, shadow_name, cfg_):
        """The waves one 1-spp dispatch of cfg_ passes to walk.<closest_name>
        and walk.<shadow_name>, in launch order."""
        waves_ = []
        real_c, real_s = getattr(walk, closest_name), getattr(walk, shadow_name)

        def rec_closest(ws_, o_, d_, a_, *args_, width=0, height=0):
            waves_.append(dict(kind="closest", o=o_.clone(), d=d_.clone(),
                               a=a_.clone(), frame=(width, height)))
            return real_c(ws_, o_, d_, a_, *args_, width=width, height=height)

        def rec_shadow(ws_, o_, d_, md__, a_, min_visibility=0.05, t_eps=1e-3,
                       width=0, height=0):
            waves_.append(dict(kind="shadow", o=o_.clone(), d=d_.clone(),
                               a=a_.clone(), md=md__.contiguous().clone(),
                               mv=min_visibility, te=t_eps, frame=(width, height)))
            return real_s(ws_, o_, d_, md__, a_, min_visibility, t_eps, width=width,
                          height=height)

        setattr(walk, closest_name, rec_closest)
        setattr(walk, shadow_name, rec_shadow)
        try:
            render_radiance_with_stats(marrays, mcam, cfg_.replace(spp=1))
        finally:
            setattr(walk, closest_name, real_c)
            setattr(walk, shadow_name, real_s)
        require([w["kind"] for w in waves_] == ["closest", "shadow", "shadow", "closest",
                                                "closest", "closest", "closest"],
                f"the {cfg_.kernels} sample's waves: {[w['kind'] for w in waves_]}")
        return waves_

    def time_waves(tag, waves_, kind_, tab_bytes):
        """Each wave walked by the live-ray kernel of ``kind_`` ("misslink":
        K7, "bvh2": K2/K3) and by its plain walk, bit for bit; the kernel
        timed alone (median of 6), its lane utilisation, the wave's bound
        and the plain walk's work."""
        k7_ = kind_ == "misslink"
        new_c = walk.closest_walk_misslink if k7_ else walk.closest_walk
        new_s = walk.shadow_walk_misslink if k7_ else walk.shadow_walk_bvh2
        plain_c = (walk.misslink_closest_walk_reference if k7_
                   else walk.closest_walk_reference)
        plain_s = (walk.misslink_shadow_walk_reference if k7_
                   else walk.shadow_walk_reference)
        rows_, n_bounce, n_light = [], 0, 0
        for w in waves_:
            o_, d_, a_, (fw, fh) = w["o"], w["d"], w["a"], w["frame"]
            n, live = o_.shape[0], int(a_.sum())
            require((fw, fh) == (1920, 1080) and n == fw * fh,
                    f"{tag}: the wave is not the frame")
            if w["kind"] == "closest":
                name = f"closest bounce {n_bounce}"
                n_bounce += 1
                if k7_:
                    new = lambda: new_c(mws, o_, d_, a_, fw, fh)  # noqa: E731
                else:
                    new = lambda: new_c(mws, o_, d_, a_, None, fw, fh)  # noqa: E731
                plain = lambda wk: plain_c(mws, o_, d_, a_, work=wk)  # noqa: E731
                count = dict(max_dist=None)
                nb = tab_bytes + n * (1 + 24) + live * 24  # act; t, tri, cross, menc; o, d
            else:
                name = f"shadow light {n_light}"
                n_light += 1
                md__, mv, te = w["md"], w["mv"], w["te"]
                new = lambda: new_s(  # noqa: E731
                    mws, o_, d_, md__, a_, mv, te, width=fw, height=fh)[0]
                plain = lambda wk: plain_s(  # noqa: E731
                    mws, o_, d_, md__, a_, mv, te, work=wk)
                count = dict(max_dist=md__, min_visibility=mv, t_eps=te)
                nb = tab_bytes + n * (1 + 4) + live * (24 + 4)  # act; vis; o, d, maxd
            kn = new()
            kp, p_ms, work = counted(plain, torch, walk)
            seq = (lambda x: x) if w["kind"] == "closest" else (lambda x: (x,))
            same = all(bool(torch.equal(a, b)) for a, b in zip(seq(kn), seq(kp)))
            ms, got = median_ms(new, 10)
            out_, a__, sl_ = walk.live_lane_counts(mws, o_, d_, a_, kind=kind_,
                                                   width=fw, height=fh, **count)
            require(all(bool(torch.equal(x, y)) for x, y in zip(seq(out_), seq(kn))),
                    f"{tag}: the counting walk walked to another result ({name})")
            lanes = a__ / sl_ if sl_ else None
            b_ms, b_by = bound(work, nb)
            rows_.append(dict(wave=name, slots=n, live=live, ms=ms, plain_ms=p_ms,
                              bound_ms=b_ms, bound_by=b_by, nbytes=nb, lanes=lanes,
                              bitwise=same, work=work))
            say(f"[{tag}] {name}: {live} of {n} slots live ({live / n * 100:.2f}%); "
                f"kernel and plain bit for bit {same}; alone on {kind} ({smi}): "
                f"{ms:.4f} ms ({' '.join(f'{t:.4f}' for t in got)}); plain "
                f"{p_ms:.2f} ms; bound {b_ms:.4f} ms ({b_by}); walk-loop lane "
                f"utilisation {lanes}; work {work}")
            require(same, f"{tag}: the kernel differs from the plain version ({name})")
        say(f"[{tag}] one sample's 7 launches alone: " + ", ".join(
            f"{k} {sum(w[k] for w in rows_):.4f} ms" for k in ("ms", "bound_ms"))
            + (f"; the longest walk {max(w['work']['ml_chain'] for w in rows_)} node "
               "visits" if k7_ else ""))
        return rows_

    k7_budget = {f: walk.live_budget(f) for f in walk.LIVE_FORMS}
    say(f"[18 live walks] budgets: {k7_budget}")
    require(all(b["threads"] == 128 and b["regs"] <= 64 and b["warps_per_sm"] >= 32
                for b in k7_budget.values()), "a live-ray walk's budget")
    k7_waves = time_waves("18 K7 waves", record_waves(
        "closest_hit_misslink", "shadow_walk_misslink", mlcfg), "misslink",
        nbytes(mws.ml_nodes, mws.ml_tris))
    b2cfg = mcfg.replace(kernels="pallas-bvh2")
    k2_waves = time_waves("18 K2/K3 waves", record_waves(
        "closest_hit_bvh2", "shadow_walk_bvh2", b2cfg), "bvh2",
        nbytes(mws.inner_table, mws.leaf_table))

    # the other staged paths, once each with their launch counts and times
    staged = {}
    for kn, spp_ in (("pallas-bvh2", 4), ("pallas-nomega", 4), ("xla", 1)):
        c_ = mcfg.replace(kernels=kn, spp=spp_)
        if kn != "xla":
            render_radiance_with_stats(marrays, mcam, c_)  # warm-up
        ext.reset_launches()
        (im_, r_), ms = timed(lambda: render_radiance_with_stats(marrays, mcam, c_),
                              torch)
        got = {k: v for k, v in ext.LAUNCHES.items() if v}
        staged[kn] = dict(ms=ms, spp=spp_, rays=int(r_), launches=got)
        say(f"[18 staged] 1920x1080 spp {spp_}, kernels={kn!r}: {ms:.2f} ms, "
            f"{int(r_)} rays, {int(r_) / ms / 1e3:.1f} Mrays/s; launches {got}")
        require(bool(torch.isfinite(im_).all()), f"{kn} frame values")
        require(set(got) == {"pallas-bvh2": {"closest_hit_bvh2", "shadow_walk_bvh2"},
                             "pallas-nomega": {"closest_hit_frustum", "closest_hit_bvh2",
                                               "shadow_walk_bvh2"},
                             "xla": set()}[kn], f"{kn} launches")
        if kn == "pallas-nomega":  # K6 takes each sample's primary wave
            require(got["closest_hit_frustum"] == spp_, "pallas-nomega's K6 launches")

    inside_k1 = "device function inside K1 (csrc/walk.cuh, called by csrc/sample_kernel.cu)"
    inside_k1t = ("device function inside the tiered K1 (csrc/walk.cuh, called by "
                  "csrc/sample_kernel.cu)")
    R, cam_b = 1920 * 1080, 36 * 4
    mtab = nbytes(mws.inner_table, mws.leaf_table, mws.materials, mws.lights) + cam_b
    ftab = nbytes(fws.top_table, fws.tre_inner, fws.tre_leaf, fws.materials,
                  fws.lights) + cam_b
    # bytes per ray: uv 8 + active 1 in, colour 12 + rays 4 out; the state 52
    sample_b, state_b = 25, 52

    def cont_bytes(live):
        """The continuation's bytes: the live rays' 13 rows, their slots of
        the permutation and their pixels' colour in, the colour out, the
        live count and the ray total (no state output)."""
        return mtab - cam_b + live * (state_b + 4 + 12 + 12) + 4 + 16

    def row(name, source, replaces, launches, err, ms, plain_ms, work, nbytes_,
            **extra):
        b_ms, b_by = bound(work, nbytes_)
        return dict(name=name, route="cuda", source=f"rayzen_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    walk_work=work, **extra)

    mtab8 = nbytes(mws.inner8_table, mws.leaf8_table, mws.materials,
                   mws.lights) + cam_b
    walk8_b = nbytes(mws.inner8_table, mws.leaf8_table)
    walk2_b = nbytes(mws.inner_table, mws.leaf_table)

    def k1_64(k, work_1spp, tab):
        """A K1 form's 1080p/64 spp numbers: its time alone, the estimated
        bound (64 x the 1 spp plain walks' work), lane utilisation, budget."""
        b64 = bound({key: 64 * v for key, v in work_1spp.items()}, tab + R * sample_b)
        return dict(ms_1080p_64spp=k["ms_64spp"], bound_ms_1080p_64spp_estimate=b64[0],
                    walk_lane_utilisation_1080p_64spp=k["lanes"], budget=k["budget"])

    def knob_rows(kn, out, source_cuh, names, replaces, tables_b, k1_tab, extra):
        """The closest, shadow and K1 rows of phase 16 (K5) or 17 (K6)."""
        closest_name, shadow_name, k1_name = names
        inside = (f"device function inside the {k1_name} instantiation of K1 "
                  f"(csrc/{source_cuh}, called by csrc/sample_kernel.cu)")
        c, sh, k1, ko = out["closest"], out["shadow"], out["k1"], out["k1_octant"]
        wk = out["walk"]  # the standalone walk's lanes and budget, where counted
        return [
            row(f"{kn} {closest_name}", "walk_kernels.cu", replaces[0],
                out["launches"][closest_name], c["err"], c["ms"], c["plain_ms"],
                c["work"], tables_b + R * 49, on_main_path=inside,
                standalone_launches=out["standalone"][closest_name],
                k2_same_rays_ms=k2_ms, exact_t_ties=c["ties"],
                hits_k2_lacks=c["extra"], incoherent_rays_ms=c["incoherent_ms"],
                k2_incoherent_rays_ms=c["k2_incoherent_ms"],
                shape="demo 1080p primary rays",
                walk_lane_utilisation=wk.get("closest_lanes"),
                budget=wk.get("budget", {}).get("closest")),
            row(f"{kn} {shadow_name}", "walk_kernels.cu", replaces[1],
                out["launches"][shadow_name], sh["err"], sh["ms"], sh["plain_ms"],
                sh["work"], tables_b + R * 33, on_main_path=inside,
                standalone_launches=out["standalone"][shadow_name],
                k3_same_rays_ms=k3_ms, shape="demo 1080p shadow rays, point light",
                walk_lane_utilisation=wk.get("shadow_lanes"),
                budget=wk.get("budget", {}).get("shadow")),
            row(f"{kn} {k1_name}", "sample_kernel.cu", replaces[2],
                out["launches"][k1_name], k1["err"], k1["ms"], k1["plain_ms"],
                k1["work"], k1_tab + R * sample_b,
                standalone_launches=out["standalone"][k1_name],
                frame_vs_k1_max_abs=out["frame_err"],
                shape="demo 1080p, 1 spp", k1_same_shape_ms=k1_1spp_ms,
                **k1_64(k1, k1["work"], k1_tab),
                dispatch_1080p_64spp_median_ms=out["turns"][k1_name],
                octant_form_dispatch_median_ms=out["turns"][k1_name + "_octant"],
                k1_dispatch_1080p_64spp_median_ms=out["turns"]["K1"],
                field_1080p_4spp_median_ms=out["field_turns"][k1_name],
                field_whole_tree_k1_median_ms=out["field_turns"]["K1"], **extra),
            row(f"K9 {k1_name}_octant", "sample_kernel.cu",
                "rayzen_tpu/ops/megakernel.py:215", out["octant_launches"],
                ko["err"], ko["ms"], ko["plain_ms"], ko["work"], k1_tab + R * sample_b,
                standalone_launches=out["standalone"][k1_name + "_octant"],
                shape="demo 1080p, 1 spp", k1_same_shape_ms=k1_1spp_ms,
                **k1_64(ko, ko["work"], k1_tab),
                dispatch_1080p_64spp_median_ms=out["turns"][k1_name + "_octant"],
                k1_dispatch_1080p_64spp_median_ms=out["turns"]["K1"]),
        ]

    # the tiered K1's bound at the field's 1080p/4 spp, estimated: the plain
    # walks' work per traced ray at 320x180/1 spp times the rays K1 traced
    # at 1080p/4 spp (the plain version at that size would take most of an
    # hour)
    k1t_est_bound = bound({k: v * int(trays) / p1t_rays for k, v in k1t_work.items()},
                          ftab + R * sample_b)
    ph1_ms, pph1_ms, ph1_work, _ = k4["ph1"]
    cont_ms, pcont_ms, cont_work, _ = k4["cont"]
    kernels = [
        row("K1 sample_wave", "sample_kernel.cu", "rayzen_tpu/ops/megakernel.py:460",
            launches["sample_wave"], k1_err, k1_ms, p1_ms, k1_work,
            mtab + R * sample_b, shape="demo 1080p, 64 spp",
            plain_shape=f"{p1_pixels} pixels of the frame (every "
            f"{K1_PLAIN_STRIDE[mcfg.rng]}th column, {mcfg.rng} flow)",
            plain_pixels=p1_pixels,
            bound_ms_estimate="walk work of the plain version's column subset "
            "times the pixel ratio",
            walk_lane_utilisation=lanes_demo, budget=budget["bvh2"]),
        row("K2 closest_hit_bvh2", "walk_kernels.cu",
            "rayzen_tpu/ops/pallas_traverse.py:243", launches["closest_hit_bvh2"],
            k2_err, k2_ms, p2_ms, k2_work,
            nbytes(mws.inner_table, mws.leaf_table) + R * 49,
            on_main_path=inside_k1, standalone_launches=standalone["closest_hit_bvh2"],
            shape="demo 1080p primary rays"),
        row("K3 shadow_walk_bvh2", "walk_kernels.cu",
            "rayzen_tpu/ops/pallas_traverse.py:454", launches["shadow_walk_bvh2"],
            k3_err, k3_ms, p3_ms, k3_work,
            nbytes(mws.inner_table, mws.leaf_table) + R * 33,
            on_main_path=inside_k1, standalone_launches=standalone["shadow_walk_bvh2"],
            shape="demo 1080p shadow rays, point light"),
        row("K1 sample_wave_tiered", "sample_kernel.cu",
            "rayzen_tpu/ops/megakernel.py:460", flaunches["sample_wave_tiered"],
            k1t_err, k1t_ms, p1t_ms, k1t_work, ftab + 320 * 180 * sample_b,
            shape="field 320x180, 1 spp", field_1080p_4spp_ms=k1t_1080_ms,
            whole_tree_1080p_4spp_ms=k1w_1080_ms,
            field_1080p_4spp_bound_ms_estimate=k1t_est_bound[0],
            walk_lane_utilisation=lanes_field, budget=budget["tiered"]),
        row("K8 closest_hit_tiered", "walk_kernels.cu",
            "rayzen_tpu/ops/pallas_traverse.py:796", flaunches["closest_hit_tiered"],
            k8_err, k8_ms, p8_ms, k8_work, ftab - cam_b + R * 49,
            on_main_path=inside_k1t,
            standalone_launches=k8_standalone["closest_hit_tiered"],
            k2_whole_tree_ms=k2f_ms, shape="field 1080p primary rays",
            schedule="one node loop over both levels, one tagged stack",
            walk_lane_utilisation=k8_lanes, budget=k8_budget["closest_tiered"]),
        row("K8 shadow_walk_tiered", "walk_kernels.cu",
            "rayzen_tpu/ops/pallas_traverse.py:879", flaunches["shadow_walk_tiered"],
            k8s_err, k8s_ms, p8s_ms, k8s_work, ftab - cam_b + R * 33,
            on_main_path=inside_k1t,
            standalone_launches=k8_standalone["shadow_walk_tiered"],
            shape="field 1080p shadow rays, point light",
            walk_lane_utilisation=k8s_lanes, budget=k8_budget["shadow_tiered"]),
        row("K4 sample_wave_phase1", "sample_kernel.cu",
            "rayzen_tpu/ops/megakernel.py:981", xlaunches["sample_wave_phase1"],
            k4_err, ph1_ms, pph1_ms, ph1_work, mtab + R * (sample_b + state_b),
            standalone_launches=split_standalone["sample_wave_phase1"],
            shape="demo 1080p, 1 sample, split_bounce 2",
            schedule="regenerating (regen_phase1_kernel) with warp tiles",
            alone_ms=k4p["ms"], walk_lane_utilisation=k4p["lanes"], budget=ph1_budget),
        row("K4 continuation", "continuation_kernel.cu",
            "rayzen_tpu/ops/megakernel.py:743", xlaunches["continuation"], k4_err,
            cont_ms, pcont_ms, cont_work, cont_bytes(k4["live"]),
            standalone_launches=split_standalone["continuation"],
            shape="demo 1080p, 1 sample, bounces 2-4 of the live rays",
            schedule=f"{cont_label['continuation']}: persistent warps, 32 live rays "
            "a take, read through the permutation", live_rays=k4["live"],
            compaction_ms=k4["comp_ms"], alone_ms=k4c["ms"],
            walk_lane_utilisation=k4c["lanes"], budget=k4c["budget"],
            split_bounce_1=dict(live_rays=k4b1["live"], ms=k4b1["cont"][0],
                                plain_ms=k4b1["cont"][1], max_abs_err=k4b1["cont"][3],
                                alone_ms=k4b1c["ms"], walk_lane_utilisation=k4b1c[
                                    "lanes"], bound_ms=bound(k4b1["cont"][2], cont_bytes(
                                        k4b1["live"]))[0]),
            split_dispatch_profile=x_profile),
        row("K9 sample_wave_octant", "sample_kernel.cu",
            "rayzen_tpu/ops/megakernel.py:215", olaunches["sample_wave_octant"],
            k9_err, k9_ms, p9_ms, k9_work, mtab + R * sample_b,
            shape="demo 1080p, 1 spp", k1_same_shape_ms=k1_1spp_ms,
            schedule="lockstep (sample_kernel) with warp tiles",
            **k1_64(dict(ms_64spp=k9_64_ms, lanes=lanes9, budget=budget9["octant"]),
                    k9_work, mtab),
            dispatch_1080p_64spp_median_ms=k9_turns["K9"],
            k1_dispatch_1080p_64spp_median_ms=k9_turns["K1"]),
        row("K9 sample_wave_tiered_octant", "sample_kernel.cu",
            "rayzen_tpu/ops/megakernel.py:215",
            k9_paths["field"]["sample_wave_tiered_octant"], k9t_err, k9t_ms, p9t_ms,
            k9t_work, ftab + 160 * 90 * sample_b,
            standalone_launches=k9_standalone["sample_wave_tiered_octant"],
            shape="field 160x90, 1 spp", field_1080p_4spp_ms=k9t_1080_ms,
            walk_lane_utilisation_field_1080p_4spp=lanes9t,
            budget=budget9["tiered_octant"]),
        row("K9 sample_wave_phase1_octant", "sample_kernel.cu",
            "rayzen_tpu/ops/megakernel.py:215",
            k9_paths["split"]["sample_wave_phase1_octant"], k9x["ph1"][3], k9x["ph1"][0],
            k9x["ph1"][1], k9x["ph1"][2], mtab + R * (sample_b + state_b),
            standalone_launches=k9_standalone["sample_wave_phase1_octant"],
            shape="demo 1080p, 1 sample, split_bounce 2", alone_ms=k9xp["ms"],
            walk_lane_utilisation=k9xp["lanes"]),
        row("K9 continuation_octant", "continuation_kernel.cu",
            "rayzen_tpu/ops/megakernel.py:215", k9_paths["split"]["continuation_octant"],
            k9x["cont"][3], k9x["cont"][0], k9x["cont"][1], k9x["cont"][2],
            cont_bytes(k9x["live"]),
            standalone_launches=k9_standalone["continuation_octant"],
            shape="demo 1080p, 1 sample, bounces 2-4 of the live rays",
            schedule=f"{cont_label['continuation_octant']}: persistent warps, 32 live "
            "rays a take", live_rays=k9x["live"], compaction_ms=k9x["comp_ms"],
            alone_ms=k9xc["ms"], walk_lane_utilisation=k9xc["lanes"],
            budget=k9xc["budget"]),
    ]
    kernels += knob_rows(
        "K5", k5, "walk.cuh",
        ("closest_hit_bvh8", "shadow_walk_bvh8", "sample_wave_wide"),
        ("rayzen_tpu/ops/pallas_traverse.py:617",
         "rayzen_tpu/ops/pallas_traverse.py:728",
         "rayzen_tpu/ops/megakernel.py:503"), walk8_b, mtab8, {})
    kernels += knob_rows(
        "K6", k6, "frustum.cuh",
        ("closest_hit_frustum", "shadow_walk_frustum", "sample_wave_frustum"),
        ("rayzen_tpu/ops/pallas_traverse.py:1002",
         "rayzen_tpu/ops/pallas_traverse.py:1115",
         "rayzen_tpu/ops/megakernel.py:519"), walk2_b, mtab,
        dict(phase1_256x192_ms=k6x["ph1"][0], phase1_256x192_plain_ms=k6x["ph1"][1],
             phase1_256x192_err=k6x["ph1"][3],
             phase1_1080p={sfx or "_plain": dict(
                 ms=v["ph1"][0], plain_ms=v["ph1"][1], err=v["ph1"][3],
                 bound_ms=bound(v["ph1"][2], mtab + R * (sample_b + state_b))[0],
                 alone_1080p=v["alone"]) for sfx, v in k6x_1080.items()},
             phase1_standalone_launches=k6x_standalone["sample_wave_phase1_frustum"],
             phase1_split_path_launches=k6x_path.get("sample_wave_phase1_frustum", 0)))
    hit7 = k7c[1] >= 0
    kernels += [
        row("K7 closest_hit_misslink", "walk_kernels.cu",
            "rayzen_tpu/ops/pallas_traverse.py:128",
            ml_launches["closest_hit_misslink"],
            (k7c[0] - p7c[0])[hit7].abs().max().item(), k7_ms, p7c_ms, k7_work,
            nbytes(mws.ml_nodes, mws.ml_tris) + R * 49,
            standalone_launches=k7_standalone["closest_hit_misslink"],
            k2_same_rays_ms=k2_turn_ms, rays_other_triangle_than_k2=n_other,
            incoherent_rays_ms=k7_inc_ms, k2_incoherent_rays_ms=k2_inc_ms,
            shape="demo 1080p primary rays",
            main_path="kernels='pallas-ml', demo 1080p/64 spp",
            pallas_ml_dispatch_timed_ms=ml_ms, pallas_ml_warmup_ms=warm_ms,
            pallas_ml_profile=ml_profile,
            staged_dispatches=staged, budget=k7_budget["closest_misslink"],
            pallas_ml_sample_waves=[w for w in k7_waves if w["wave"].startswith("closest")],
            pallas_ml_dispatch_ms=k7_dispatch_closest,
            pallas_ml_dispatch_ms_by_wave={
                c: v for c, v in k7_dispatch.items() if c.startswith("closest")}),
        row("K7 shadow_walk_misslink", "walk_kernels.cu",
            "rayzen_tpu/ops/pallas_traverse.py:189",
            ml_launches["shadow_walk_misslink"], 0.0, k7s_ms, p7s_ms, k7s_work,
            nbytes(mws.ml_nodes, mws.ml_tris) + R * 33,
            standalone_launches=k7_standalone["shadow_walk_misslink"],
            k3_same_rays_ms=k3_turn_ms, shape="demo 1080p shadow rays, point light",
            main_path="kernels='pallas-ml', demo 1080p/64 spp",
            budget=k7_budget["shadow_misslink"],
            pallas_ml_sample_waves=[w for w in k7_waves if w["wave"].startswith("shadow")],
            pallas_ml_dispatch_ms=k7_dispatch_shadow,
            pallas_ml_dispatch_ms_by_wave={
                c: v for c, v in k7_dispatch.items() if c.startswith("shadow")}),
    ]
    # the standalone K2/K3 on their own path (kernels="pallas-bvh2", and the
    # bounces of "pallas-nomega"): the live-ray launch, timed on the waves of
    # one 1080p sample; launches from the 4-spp pallas-bvh2 dispatch
    for name, kn_, replaces, waves_ in (
            ("K2 closest_hit_bvh2", "closest_hit_bvh2",
             "rayzen_tpu/ops/pallas_traverse.py:428",
             [w for w in k2_waves if w["wave"].startswith("closest")]),
            ("K3 shadow_walk_bvh2", "shadow_walk_bvh2",
             "rayzen_tpu/ops/pallas_traverse.py:580",
             [w for w in k2_waves if w["wave"].startswith("shadow")])):
        w0 = waves_[0]
        kernels.append(row(
            f"{name} (standalone)", "walk_kernels.cu", replaces,
            staged["pallas-bvh2"]["launches"][kn_], 0.0,
            w0["ms"], w0["plain_ms"], w0["work"], w0["nbytes"],
            shape=f"the {w0['wave']} wave of one 1080p pallas-bvh2 sample",
            main_path="kernels='pallas-bvh2', demo 1080p/4 spp",
            schedule="live_walk_kernel<Bvh2Walk>: the live rays only, each in "
            "its slot's thread, in K1's warp tiles",
            budget=k7_budget["closest_bvh2" if kn_.startswith("closest")
                             else "shadow_bvh2"],
            pallas_bvh2_sample_waves=waves_,
            pallas_nomega_launches=staged["pallas-nomega"]["launches"].get(kn_, 0)))
    # ---- 19 frame loop: start-up, the interactive session, progressive,
    # preview, chunked ----
    fl = frame_loop_phase(torch, np, dev, fscene, warrays, out_dir)
    per_frame = {
        "K1 sample_wave": {"pt, interactive 1080p": fl["interactive"]["k1_launches_per_frame"],
                           "pt, progressive 800x600 64 spp": 1.0},
        "K7 closest_hit_misslink": {"preview 1080p": fl["preview"]["k7_launches_per_frame"]},
        "K7 shadow_walk_misslink": {"preview 1080p": 0},
        "K2 closest_hit_bvh2 (standalone)": {
            "chunked field 320x180 1 spp": fl["chunked"]["launches_per_frame"]["closest_hit_bvh2"]},
        "K3 shadow_walk_bvh2 (standalone)": {
            "chunked field 320x180 1 spp": fl["chunked"]["launches_per_frame"]["shadow_walk_bvh2"]},
    }
    for k in kernels:
        if k["name"] in per_frame:
            k["frame_loop_launches_per_frame"] = per_frame[k["name"]]
    # ---- 20 the last modules: deforming meshes, tiled frames, the native
    # builder ----
    p20 = deform_sharded_native_phase(torch, np, dev, mcfg, marrays, mcam, med, k1_ms,
                                      out_dir)
    k23 = p20["k2k3_vs_brute"]["launches"]
    phase20 = {
        "K1 sample_wave": dict(
            deform_1080p_spp2_per_frame=p20["frames"]["k1_launches_per_frame"],
            sharded_1080p_64spp_per_dispatch={
                name: v["launches"]["sample_wave"]
                for name, v in p20["sharded"]["checks"].items()},
            deform_frame_median_ms=p20["frames"]["demo_median_ms"],
            deform_k1_alone_ms=p20["alone"]["k1_ms"],
            deform_tables_alone_ms=p20["alone"]["tables_ms"],
            sharded_dispatch_median_ms=p20["sharded"]["median_ms"]),
        "K2 closest_hit_bvh2 (standalone)": dict(
            deform_tables_check=k23.get("closest_hit_bvh2", 0)),
        "K3 shadow_walk_bvh2 (standalone)": dict(
            deform_tables_check=k23.get("shadow_walk_bvh2", 0)),
    }
    for k in kernels:
        if k["name"] in phase20:
            k["phase20"] = phase20[k["name"]]
    # ---- 21 the last functions: the BLAS and scene walks, the BVH and PPM
    # files, ref_rand, build_scene_tlas ----
    last_functions_phase(torch, np, dev)
    print(json.dumps({"phase_seconds": phase_seconds(),
                      "total_s": round(time.perf_counter() - START, 1)}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", flush=True)
        sys.exit(1)
