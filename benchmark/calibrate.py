"""Readings for the check's limits, on the card, in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,... \\
        --seconds <s> --control 3 [--out <file.jsonl>]

For each seed: a window through the same calls as a run (set-up once,
the keys and the warm-up per seed), then the check's numbers against the
float32 reference (the program's readings, from which a limit's lower
reading comes), with the window's rate and latency tail. Then, on the
first ``--control`` seeds' frames and pixels, the control: the reference
in bfloat16 in the program's place, judged by the same numbers (the upper
readings), and a fault in the program's place (the reference from half
of each frame's samples; its first frame read back for every frame). One
JSON line per reading.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def state_unchanged_numbers(cell, seed: int, fl, pixels) -> dict:
    """A fault in the program's place: the reference's first checked frame
    read back for every checked frame (a step that leaves its state
    unchanged), judged by the check's numbers."""
    from benchmark.harness import check

    idx, _, (ref, ref_rpp) = cell.reference(seed, fl, pixels)
    return check.numbers(np.repeat(ref[:1], ref.shape[0], 0), ref, ref_rpp, ref_rpp, idx,
                         cell.accumulate)


def half_samples_numbers(cell, seed: int, fl, pixels) -> dict:
    """A fault in the program's place: the reference rendering each frame
    from half its samples (the mean over the rest, with its traced rays),
    judged by the check's numbers."""
    from benchmark.harness import check

    half_spp = max(1, cell.spp // 2)
    idx, _, (half, half_rpp) = cell.reference(seed, fl, pixels, spp=half_spp)
    *_, (ref, ref_rpp) = cell.reference(seed, fl, pixels)
    return check.numbers(half, ref, half_rpp * half_spp / cell.spp, ref_rpp, idx,
                         cell.accumulate)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from benchmark.harness import bench

    seeds = [int(s) for s in args.seeds.split(",")]
    cell = bench.Cell(args.workload)
    lines = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        lines.append(rec)

    kept = []
    for seed in seeds:
        cell.set_up(seed)
        fl, t0, t1, _tr, pixels = cell.window(seed, args.seconds, False)
        _, msps, lat = bench.window_numbers(fl, t0, t1, cell.paths)
        t = time.perf_counter()
        nums = cell.check_numbers(seed, fl, pixels)
        emit({"kind": "program", "workload": args.workload, "seed": seed,
              "frames": len(fl), "msamples_per_s": msps,
              "frame_ms_p95": float(np.percentile(lat, 95)),
              "reference_s": time.perf_counter() - t, **nums})
        if len(kept) < args.control:
            kept.append((seed, fl, pixels))
    for seed, fl, pixels in kept:
        t = time.perf_counter()
        nums = cell.control_numbers(seed, fl, pixels)
        emit({"kind": "control_bf16", "workload": args.workload, "seed": seed,
              "frames": len(fl), "reference_s": time.perf_counter() - t, **nums})
        for kind, fault in (("fault_half_samples", half_samples_numbers),
                            ("fault_state_unchanged", state_unchanged_numbers)):
            emit({"kind": kind, "workload": args.workload, "seed": seed,
                  "frames": len(fl), **fault(cell, seed, fl, pixels)})
    if args.out:
        with open(args.out, "a") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
