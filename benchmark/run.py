"""Run one cell of the benchmark of rayzen_tpu_torch on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, with --trace 1 also
breakdown, and last the check's numbers beside their limits); the numbers
compared are also the last lines of standard error. No CUDA card, fewer
cards than the cell asks for, a program that cannot be imported, or JAX
or the JAX package loaded in this process: a message on standard error,
exit code 2 or 3, and no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
# The bytecode of everything the run imports (torch's, the program's) is
# cached inside the checkout, at a fixed path, also where the environment
# forbids writing it beside the sources: otherwise every run compiles
# torch's Python sources again, which was most of a warm set-up.
sys.pycache_prefix = os.path.join(REPO, ".pycache")
sys.dont_write_bytecode = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t = time.perf_counter()
    try:
        import torch  # noqa: F401

        t_torch = time.perf_counter()
        from benchmark.harness import bench
    except ImportError as e:
        print(f"benchmark: cannot import what it runs: {e!r}", file=sys.stderr)
        return 2
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    log(f"# imports: torch {t_torch - t:.3f} s, the harness "
        f"{time.perf_counter() - t_torch:.3f} s")
    try:
        out = bench.run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), T0, log=log)
    except bench.NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    except ImportError as e:
        print(f"benchmark: cannot import the program: {e!r}", file=sys.stderr)
        return 2
    except bench.Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
