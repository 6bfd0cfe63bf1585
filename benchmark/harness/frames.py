"""The traffic generator: a closed loop of frames through the program's
Renderer, a fixed number in flight.

A traffic file (traffic/<name>.json) holds its parameters:
- ``spp``: samples a pixel per frame (one full-frame dispatch each);
- ``in_flight``: frames dispatched and not yet read back; the host
  dispatches frame i + in_flight - 1 before it resolves frame i;
- ``warmup_frames``: frames run through the same calls before the window
  (their shapes are the window's), then the accumulation restarts;
- ``key_span``: the frames' numbers start at seed mod key_span, so the
  seed picks which samples of the progressive sequence are drawn;
- ``render``: the Renderer's options, any ``RenderConfig`` field by name
  (``accumulate``, ``tiered``, ``split_bounce``, ``kernels``,
  ``wide_nodes``, ...) but those that the configuration's frame settings
  or the harness set, and ``single_tree``: one tree for the whole scene,
  however large, so nothing is chunked (bench.render_config).

A frame's number in the sequence fixes its geometry (the scene kind's
``before_dispatch`` hands it to the program, and its ``world`` to the
reference); the RNG key the program draws it with follows from the number
by ``frame_key``. Each frame's record: both, the host clock before the
kind's hook and the dispatch call, after the call, and after its readback
returned, the read-back image's values at the pixels the check compares,
and the traced rays the program's profiler recorded for it.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np


def frame_key(number: int, accumulate: bool) -> int:
    """The RNG key the program draws frame ``number`` with: its number
    while it accumulates (a fresh key a frame), else 0 for every frame
    (Renderer._frame_key)."""
    return number if accumulate else 0


@dataclasses.dataclass
class Frame:
    number: int  # in the sequence: fixes the frame's geometry
    key: int  # the RNG key the program drew it with (frame_key)
    t_dispatch: float
    t_dispatched: float
    t_done: float = 0.0
    values: np.ndarray | None = None  # (P, 3) float32 at the checked pixels
    rays: float = 0.0  # the program's traced rays of the frame (its profiler record)


def run_window(renderer, seconds: float, in_flight: int, xs, ys, *, first: int,
               accumulate: bool, before, span=None):
    """Frames numbered from ``first`` until ``seconds`` have passed since
    the first dispatch, then the ones in flight are read back. Returns
    (frames, t_start, t_end). ``before(renderer, number)`` runs before each
    dispatch, inside its latency; ``span(name)`` wraps each dispatch and
    readback (a profiler label)."""
    span = span or (lambda name: _null())
    q = collections.deque()
    frames = []
    t_start = time.perf_counter()
    t_end = t_start + seconds

    def dispatch():
        number = first + len(frames)
        with span("bench.dispatch"):
            t0 = time.perf_counter()
            before(renderer, number)
            pf = renderer.render_frame_async("pt")
            t1 = time.perf_counter()
        f = Frame(number, frame_key(number, accumulate), t0, t1)
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


def warm_up(renderer, n: int, first: int, before) -> None:
    """n frames numbered from ``first`` through the window's calls (the
    hook ``before`` too), read back; the accumulation then starts again
    (the numbers go on)."""
    pending = []
    for i in range(n):
        before(renderer, first + i)
        pending.append(renderer.render_frame_async("pt"))
    for pf in pending:
        pf.resolve()
    renderer.reset_accumulation()
