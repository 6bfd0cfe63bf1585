"""readback_wait_ms: how long a frame's readback waited behind queued
device work: from the start of the program's ``rz.readback.image`` span
to the start of the first device-to-host copy that begins inside it,
median over the traced window's frames."""

import statistics

from benchmark.harness import program_spans
from benchmark.harness.trace import D2H_COPY


def read(run):
    tr = run.trace
    if tr is None or not tr.in_window():
        return None
    spans = program_spans.aligned(run)
    if spans is None:
        return None
    copies = [o.start for o in tr.in_window()
              if o.cat == "gpu_memcpy" and D2H_COPY.search(o.name)]
    waits = []
    for s in spans:
        if s.name == "rz.readback.image":
            inside = [c for c in copies if s.start <= c <= s.end]
            if inside:
                waits.append(min(inside) - s.start)
    return statistics.median(waits) * 1e-3 if waits else None
