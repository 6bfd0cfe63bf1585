"""readback_ms: device time of the frame's device-to-host copy (the
read-back of PendingFrame.resolve), per frame, from the trace."""

from benchmark.harness.trace import D2H_COPY


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    us = run.trace.total_us(lambda o: o.cat == "gpu_memcpy" and D2H_COPY.search(o.name))
    return us * 1e-3 / run.trace.frames if us else None
