"""The program's own spans on the device trace's clock.

The program records a span at each layer boundary of its frame loop while
a torch profiler records (``rayzen_tpu_torch.profiler.spans()``: name,
frame, parent, start and end in ``perf_counter_ns``). The trace loader
keeps only the benchmark's ``bench.*`` spans, so this module puts the
program's spans on the trace's clock itself: a least-squares line from
each frame's host clock at its dispatch call (``Frame.t_dispatch``,
``perf_counter``) to the start of its ``bench.dispatch`` span in the
trace, which absorbs any drift between the two clocks over the window
(with a single frame, the line keeps the clocks' nominal rate).

``aligned(run)`` returns None where there is nothing to align: no trace,
a program that records no spans (one older than them), no frames, or a
line whose median absolute residual exceeds ``MAX_RESIDUAL_US``.
"""

from __future__ import annotations

import dataclasses
import statistics

MAX_RESIDUAL_US = 50.0


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    frame: int | None
    parent: str | None
    start: float  # microseconds, on the trace's clock
    end: float


def _recorded():
    """The program's span records, or None if it has no spans."""
    try:
        from rayzen_tpu_torch import profiler
    except ImportError:
        return None
    read = getattr(profiler, "spans", None)
    return read() if read is not None else None


def fit(xs, ys):
    """The least-squares line y = a x + b over the points, and the median
    absolute residual: (a, b, residual)."""
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    sxx = sum((x - mx) ** 2 for x in xs)
    a = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    b = my - a * mx
    return a, b, statistics.median(abs(y - (a * x + b)) for x, y in zip(xs, ys))


def align(records, frames, trace):
    """``records`` (the program's spans) as Span on ``trace``'s clock, those
    that fall in its window, by the line from ``frames``' dispatch times to
    the trace's ``bench.dispatch`` starts; None as the module says."""
    if trace is None or not records:
        return None
    starts = sorted(s for name, s, _ in trace.spans if name == "bench.dispatch")
    hosts = sorted(f.t_dispatch for f in frames)
    if len(starts) != len(hosts) or not hosts:
        return None
    # centred on the first frame, so the sums keep the clocks' digits
    h0, s0 = hosts[0], starts[0]
    if len(hosts) == 1:
        a, b, residual = 1e6, 0.0, 0.0
    else:
        a, b, residual = fit([h - h0 for h in hosts], [s - s0 for s in starts])
    if residual > MAX_RESIDUAL_US:
        return None
    t0, t1 = trace.window
    out = []
    for name, frame, parent, start_ns, end_ns in records:
        start = a * (start_ns * 1e-9 - h0) + b + s0
        end = a * (end_ns * 1e-9 - h0) + b + s0
        if start >= t0 and end <= t1:
            out.append(Span(name, frame, parent, start, end))
    return out


def aligned(run):
    """The program's spans of the traced window on the trace's clock."""
    if run.trace is None:
        return None
    return align(_recorded(), run.frames, run.trace)


def host_ms_per_frame(run, name: str):
    """The median over frames of a frame's host time in the spans ``name``
    (their sum, where a frame has several), in ms; None without them."""
    spans = aligned(run)
    if spans is None:
        return None
    per_frame = {}
    for s in spans:
        if s.name == name and s.frame is not None:
            per_frame[s.frame] = per_frame.get(s.frame, 0.0) + (s.end - s.start)
    return statistics.median(per_frame.values()) * 1e-3 if per_frame else None


def idle_ms_per_frame(run, name: str):
    """Device-idle time (the trace's gaps) inside the spans ``name``, over
    the window's frames, in ms; None on a trace with no device operations
    or without the spans."""
    tr = run.trace
    if tr is None or not tr.frames or not tr.in_window():
        return None
    spans = aligned(run)
    if spans is None:
        return None
    marked = sorted((s.start, s.end) for s in spans if s.name == name)
    if not marked:
        return None
    return overlap_us(tr.gaps(), marked) * 1e-3 / tr.frames


def overlap_us(xs, ys) -> float:
    """The time two lists of disjoint intervals, each sorted by start,
    share."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] <= ys[j][1]:
            i += 1
        else:
            j += 1
    return total
