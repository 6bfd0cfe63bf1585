"""k1_roofline_pct: the least time of a frame's tracing work over K1's
device time per frame, in percent. The least time is the larger of the
work's FP32 operations over the card's FP32 peak and its bytes over the
card's memory bandwidth (work/roofline.py; the operations are the
benchmark's own count, an estimate from a pixel sample)."""

from benchmark.harness.trace import K1_KERNEL
from benchmark.work import roofline


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    least = roofline.least_seconds(run)
    us = run.trace.total_us(lambda o: o.cat == "kernel" and K1_KERNEL.search(o.name))
    if least is None or not us:
        return None
    return 100.0 * least / (us * 1e-6 / run.trace.frames)
