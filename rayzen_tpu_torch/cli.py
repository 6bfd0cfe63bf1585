"""Demo application CLI (port of rayzen_tpu/cli.py: every flag, plus
--device).

Reference flags reproduced (RayZen/src/main.cpp:141-160): --log=debug|info|error,
--rebuild-bvh, --path-tracer-only, --warmup-frames=N. Plus offscreen-rendering
flags the windowless app needs: resolution, spp, bounces, frame count,
output path, camera fly-through, debug overlay toggles (the reference's F1/L/B/N
keys, main.cpp:441-499, become flags), and --preview (editor mode).

Run: python -m rayzen_tpu_torch [flags]; frames render on --device (default
cuda; cpu runs the kernels' plain versions). --multichip cuts each frame
into one tile per device of --device's type (parallel.py).
"""

from __future__ import annotations

import argparse
import sys
import time

from . import logging_util as log
from .config import RenderConfig
from .demo import build_demo_scene
from .image_io import write_png
from .renderer import Renderer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="rayzen_tpu_torch",
        description="path tracer demo on PyTorch and CUDA"
    )
    p.add_argument("--log", choices=["debug", "info", "error"], default="info")
    p.add_argument("--rebuild-bvh", action="store_true")
    p.add_argument("--path-tracer-only", action="store_true")
    p.add_argument("--warmup-frames", type=int, default=0)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--bounces", type=int, default=5)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--out", type=str, default="frame.png")
    p.add_argument("--preview", action="store_true", help="editor-mode render")
    p.add_argument("--accumulate", action="store_true")
    p.add_argument("--fly", action="store_true", help="orbit camera across frames")
    p.add_argument("--show-bvh", action="store_true", help="BVH wireframe overlay (B key)")
    p.add_argument("--bvh-mode", type=int, default=0, help="0=TLAS 1=BLAS (N key)")
    p.add_argument("--selected-blas", type=int, default=0)
    p.add_argument("--selected-tri", type=int, default=0)
    p.add_argument("--show-lights", action="store_true", help="light markers (L key)")
    p.add_argument("--show-fps", action="store_true")
    p.add_argument("--obj-dir", type=str, default=None, help="load OBJ assets from dir")
    p.add_argument("--cache-dir", type=str, default=".rayzen_cache")
    p.add_argument("--compile-cache", type=str, default=None)
    p.add_argument("--multichip", action="store_true",
                   help="shard over all devices of --device's type")
    p.add_argument(
        "--split-bounce", type=int, default=0,
        help="trace bounces 0..N-1 fused, stream-compact survivors, finish "
        "in a dense continuation kernel (config.split_bounce; 0 = off)",
    )
    p.add_argument(
        "--split-rebin", choices=["rank", "octant", "octcell"], default="rank",
        help="ordering of compacted survivors (config.split_rebin)",
    )
    p.add_argument(
        "--interactive",
        action="store_true",
        help="stdin-driven live session: WASD/look move the camera, p/l/b/n "
        "toggle preview/lights/BVH overlays, click picks — each command "
        "re-renders --out (see rayzen_tpu_torch/interactive.py for the protocol)",
    )
    p.add_argument(
        "--pipeline", type=int, default=1, metavar="N",
        help="with --interactive: keep up to N frames in flight (async "
        "dispatch; the reference's GL driver queues frames ahead the same "
        "way, main.cpp:637-654). 1 = strictly synchronous",
    )
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the frames (default cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        spp=args.spp,
        max_bounces=args.bounces,
        log_level=args.log,
        warmup_frames=args.warmup_frames,
        path_tracer_only=args.path_tracer_only,
        rebuild_bvh=args.rebuild_bvh,
        accumulate=args.accumulate,
        debug_show_bvh=args.show_bvh,
        debug_bvh_mode=args.bvh_mode,
        debug_selected_blas=args.selected_blas,
        debug_selected_tri=args.selected_tri,
        debug_show_lights=args.show_lights,
        show_fps_overlay=args.show_fps,
        cache_dir=args.cache_dir,
        compile_cache_dir=args.compile_cache,
        split_bounce=args.split_bounce,
        split_rebin=args.split_rebin,
    )
    log.set_level(cfg.log_level)
    scene = build_demo_scene(cfg.width, cfg.height, obj_dir=args.obj_dir)

    # Offscreen rendering gains nothing from the background kernel build
    # (that is for interactive use): build first, so the process teardown
    # never races a daemon build thread. The interactive session keeps it.
    if args.multichip:
        renderer = Renderer.multi_chip(scene, cfg, async_compile=args.interactive,
                                       device=args.device)
    else:
        renderer = Renderer(scene, cfg, async_compile=args.interactive,
                            device=args.device)

    if args.interactive:
        from .interactive import InteractiveSession

        session = InteractiveSession(renderer, out_path=args.out)
        frames = session.run(pipeline=max(1, args.pipeline))
        renderer.close()
        log.info(f"Interactive session ended after {frames} frame(s)")
        return 0

    mode = "preview" if args.preview else ("pt" if args.path_tracer_only else "auto")

    # "--out frames_{i:04d}.png" writes the whole sequence; a plain path keeps
    # only the last frame
    sequence = args.out and ("{" in args.out)
    last = None
    t0 = time.perf_counter()
    for i in range(args.frames):
        if args.fly and i > 0:
            scene.camera.rotate(4.0, 0.0)  # orbit-ish fly-through
            renderer.sync_camera()
        last = renderer.render_frame(mode=mode)
        if sequence:
            write_png(args.out.format(i=i), last)
    wall = time.perf_counter() - t0
    summ = renderer.profiler.summary(skip=1 if args.frames > 1 else 0)
    log.info(
        f"{args.frames} frame(s) in {wall * 1e3:.1f} ms — "
        f"avg total {summ.get('total', 0):.2f} ms, fps {summ.get('fps', 0):.1f}"
        + (
            f", {summ.get('mrays_per_s', 0):.1f} Mrays/s"
            if "mrays_per_s" in summ
            else ""
        )
    )
    if last is not None and args.out and not sequence:
        write_png(args.out, last)
        log.info(f"Wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
