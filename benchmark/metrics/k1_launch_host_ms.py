"""k1_launch_host_ms: the host's time launching a frame's K1 (the
program's ``rz.k1.launch`` span: checks, the camera upload, the ctypes
call), median over the traced window's frames."""

from benchmark.harness import program_spans


def read(run):
    return program_spans.host_ms_per_frame(run, "rz.k1.launch")
