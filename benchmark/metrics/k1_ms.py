"""k1_ms: device time of the K1 sample kernel (matched by name), per
frame, from the trace."""

from benchmark.harness.trace import K1_KERNEL


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    us = run.trace.total_us(lambda o: o.cat == "kernel" and K1_KERNEL.search(o.name))
    return us * 1e-3 / run.trace.frames if us else None
