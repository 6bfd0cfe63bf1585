"""idle_dispatch_ms: device-idle time inside the program's
``rz.frame.dispatch`` spans (the host enqueueing a frame), per frame of the
traced window."""

from benchmark.harness import program_spans


def read(run):
    return program_spans.idle_ms_per_frame(run, "rz.frame.dispatch")
