"""The least time a frame's tracing work can take on the card: the larger
of its FP32 operations over the card's FP32 peak and its bytes over the
card's memory bandwidth (harness/peaks.py).

The work comes from work/<config>.json, which work/count.py writes from
the benchmark's own reference walk (reference/bvh.py), never from the
program: the operations a path makes (node visits and triangle tests
times the operations each costs, counted in reference/bvh.py), and the
bytes of the scene's tables read once. A frame's paths are width x
height x spp; its image (three float32 a pixel) is written once. A
configuration without a count file has no least time, and the metrics
that need it are left out.
"""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_count(config: str):
    path = os.path.join(HERE, config + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def least_seconds_for(count: dict, peak: dict, width: int, height: int,
                      spp: int) -> float:
    paths = width * height * spp
    ops = count["ops_per_path"] * paths
    nbytes = count["table_bytes"] + width * height * 3 * 4
    return max(ops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"])


def least_seconds(run):
    count = load_count(run.config_name)
    if count is None or run.peak is None:
        return None
    fr = run.frame
    return least_seconds_for(count, run.peak, fr["width"], fr["height"], run.spp)
