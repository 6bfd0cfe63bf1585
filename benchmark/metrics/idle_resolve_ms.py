"""idle_resolve_ms: device-idle time inside the program's
``rz.frame.resolve`` spans (the host reading a frame back), per frame of
the traced window."""

from benchmark.harness import program_spans


def read(run):
    return program_spans.idle_ms_per_frame(run, "rz.frame.resolve")
