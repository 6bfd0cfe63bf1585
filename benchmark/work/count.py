"""Count the tracing work of a configuration's paths with the reference's
own BVH walk, and write it to work/<config>.json for the roofline.

    python3 benchmark/work/count.py --config demo [--pixels 2048 --samples 2]

The paths are those of ``--pixels`` pixels drawn from a fixed seed, at
``--samples`` consecutive sample indices each, in the world of frame 0 of
the configuration's scene kind (harness/kinds/): an estimate of a path's
average work, scaled to a frame by work/roofline.py. The count runs the
reference path tracer (reference/tracer.py) with its hits found by the
counting walk (reference/bvh.py) and imports nothing of the program.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def count(config: dict, pixels: int, samples: int, seed: int = 0, device="cpu",
          overrides: dict | None = None) -> dict:
    import numpy as np
    import torch

    from benchmark.harness import kinds
    from benchmark.reference import bvh, tracer

    config = dict(config, **(overrides or {}))
    kind = kinds.load(config)
    sc = kind.world(kind.scene(config, {}), 0)
    fr = sc["frame"]
    world = tracer.build_world(sc, device)
    work = bvh.Work()
    walker = bvh.Walker(world, work)
    g = np.random.default_rng(seed)
    idx = g.choice(fr["width"] * fr["height"], size=pixels, replace=False)
    u, v = tracer.pixel_uv(fr["width"], fr["height"], idx % fr["width"],
                           idx // fr["width"], device)
    samp = torch.arange(samples, dtype=torch.float32, device=u.device)
    uu, vv = u.repeat(samples), v.repeat(samples)
    ss = samp.repeat_interleave(pixels)
    _col, rays = tracer.trace_paths(world, fr, tracer.camera_table(sc["camera"]),
                                    uu, vv, ss, walker=walker)
    paths = pixels * samples
    visits, tests = work.visits / paths, work.tests / paths
    return {
        "config": config["name"], "estimate": True,
        "pixels": pixels, "samples": samples, "seed": seed, "paths": paths,
        "visits_per_path": visits, "tests_per_path": tests,
        "rays_per_path": float(rays.double().mean()),
        "ops_per_visit": bvh.OPS_PER_VISIT, "ops_per_test": bvh.OPS_PER_TEST,
        "ops_per_path": visits * bvh.OPS_PER_VISIT + tests * bvh.OPS_PER_TEST,
        "table_bytes": walker.bvh.table_bytes,
        "nodes": int(walker.bvh.bmin.shape[0]), "triangles": int(walker.bvh.order.shape[0]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--pixels", type=int, default=2048)
    ap.add_argument("--samples", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    from benchmark.harness import scenes

    t = time.perf_counter()
    cfg = scenes.load_config(os.path.join(scenes.BENCH_DIR, "configs", args.config + ".json"))
    out = count(cfg, args.pixels, args.samples, device=args.device)
    out["seconds"] = time.perf_counter() - t
    with open(os.path.join(HERE, args.config + ".json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
