"""refit_host_ms: the host's time enqueueing a frame's refit (the
program's ``rz.refit`` spans, one a chunk on chunked scenes), median over
the traced window's frames."""

from benchmark.harness import program_spans


def read(run):
    return program_spans.host_ms_per_frame(run, "rz.refit")
