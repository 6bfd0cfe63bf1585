"""The traffic generator: a closed loop of progressive frames through the
program's Renderer, a fixed number in flight.

A traffic file (traffic/<name>.json) holds its parameters:
- ``spp``: samples a pixel per frame (one full-frame dispatch each);
- ``in_flight``: frames dispatched and not yet read back; the host
  dispatches frame i + in_flight - 1 before it resolves frame i;
- ``warmup_frames``: frames run through the same calls before the window
  (their shapes are the window's), then the accumulation restarts;
- ``key_span``: the frames' RNG keys start at seed mod key_span, so the
  seed picks which samples of the progressive sequence are drawn;
- ``render``: the Renderer's options (``tiered``; ``single_tree``: one
  tree for the whole scene, however large, so nothing is chunked).

Each frame's record: its key, the host clock at its dispatch call, after
it, and after its readback returned, the read-back image's values at the
pixels the check compares, and the traced rays the program's profiler
recorded for it.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Frame:
    key: int
    t_dispatch: float
    t_dispatched: float
    t_done: float = 0.0
    values: np.ndarray | None = None  # (P, 3) float32 at the checked pixels
    rays: float = 0.0  # the program's traced rays of the frame (its profiler record)


def run_window(renderer, seconds: float, in_flight: int, xs, ys, span=None):
    """Frames until ``seconds`` have passed since the first dispatch, then
    the ones in flight are read back. Returns (frames, t_start, t_end).
    ``span(name)`` wraps each dispatch and readback (a profiler label)."""
    span = span or (lambda name: _null())
    q = collections.deque()
    frames = []
    t_start = time.perf_counter()
    t_end = t_start + seconds

    def dispatch():
        with span("bench.dispatch"):
            t0 = time.perf_counter()
            pf = renderer.render_frame_async("pt")
            t1 = time.perf_counter()
        f = Frame(pf.frame_no, t0, t1)
        frames.append(f)
        q.append((f, pf))

    while True:
        while len(q) < in_flight and time.perf_counter() < t_end:
            dispatch()
        if not q:
            break
        f, pf = q.popleft()
        with span("bench.resolve"):
            img = pf.resolve()
        f.t_done = time.perf_counter()
        f.values = np.array(img[ys, xs], np.float32)
        rec = renderer.profiler.history[-1]
        f.rays = rec.get("mrays_per_s", 0.0) * rec["total"] * 1e3
    return frames, t_start, t_end


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def warm_up(renderer, n: int) -> None:
    """n frames through the window's calls, read back; the accumulation then
    starts again (the keys go on)."""
    pending = [renderer.render_frame_async("pt") for _ in range(n)]
    for pf in pending:
        pf.resolve()
    renderer.reset_accumulation()
