"""Frame timing, throughput counters, and FPS smoothing.

Reference (SURVEY.md §5 "Tracing / profiling"): std::chrono spans everywhere —
startup step timers (main.cpp:163-176), per-frame total/input/bvh/send/render/swap
breakdowns logged for the first 100 frames (main.cpp:656-664), FPS EMA with
alpha=0.1 for the overlay (main.cpp:624-630). This module reproduces those
patterns for the port's frame loop (phases: update/render/overlay/readback) and adds
what the reference lacked (SURVEY.md §6): a rays/second counter, since the
benchmark target is Mrays/s.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from . import logging_util as log


class StartupTimer:
    """logStartupStep pattern (main.cpp:163-176)."""

    def __init__(self):
        self._last = time.perf_counter()
        self._t0 = self._last

    def step(self, name: str) -> float:
        now = time.perf_counter()
        dt = (now - self._last) * 1e3
        self._last = now
        log.info(f"[startup] {name}: {dt:.1f} ms")
        return dt

    def total(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3


class FrameProfiler:
    """Per-frame phase breakdown + FPS EMA + ray throughput."""

    def __init__(self, log_first_n: int = 100, fps_alpha: float = 0.1):
        self.log_first_n = log_first_n
        self.fps_alpha = fps_alpha
        self.frame_index = 0
        self.fps_ema: Optional[float] = None
        self.history: List[Dict[str, float]] = []
        self._phases: Dict[str, float] = {}
        self._frame_start = 0.0
        self._last_record_t: Optional[float] = None

    def begin_frame(self):
        self._phases = {}
        self._frame_start = time.perf_counter()

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._phases[name] = self._phases.get(name, 0.0) + (
                time.perf_counter() - t0
            ) * 1e3

    def end_frame(self, rays_traced: int = 0) -> Dict[str, float]:
        return self.record(
            (time.perf_counter() - self._frame_start) * 1e3,
            rays_traced=rays_traced,
            phases=self._phases,
        )

    def record(
        self, total_ms: float, rays_traced: int = 0,
        phases: Optional[Dict[str, float]] = None,
    ) -> Dict[str, float]:
        """Record a frame. ``total_ms`` is the frame's *latency* (kept in the
        record as "total"). Externally-timed frames (async/pipelined: measure
        dispatch->resolve wall themselves) pass no ``phases`` and get an empty
        phase dict — never the previous sync frame's leftovers (ADVICE r4).

        FPS is throughput-aware: with frames in flight, resolves arrive every
        inter-record interval (<< latency), so fps uses
        min(latency, interval-since-last-record) — which reduces to plain
        1000/latency in a synchronous loop."""
        self._phases = phases if phases is not None else {}
        now = time.perf_counter()
        frame_ms = total_ms
        if self._last_record_t is not None:
            frame_ms = min(total_ms, (now - self._last_record_t) * 1e3)
        self._last_record_t = now
        fps = 1000.0 / max(frame_ms, 1e-6)
        if self.fps_ema is None:
            self.fps_ema = fps
        else:  # EMA alpha = 0.1 (main.cpp:624-630)
            self.fps_ema = (1 - self.fps_alpha) * self.fps_ema + self.fps_alpha * fps
        rec = dict(self._phases)
        rec["total"] = total_ms
        rec["fps"] = fps
        if rays_traced:
            rec["mrays_per_s"] = rays_traced / (total_ms * 1e3)
        if self.frame_index < self.log_first_n:
            parts = " ".join(
                f"{k}={v:.2f}ms" for k, v in self._phases.items()
            )
            extra = (
                f" mrays/s={rec['mrays_per_s']:.1f}" if rays_traced else ""
            )
            log.debug(
                f"[frame {self.frame_index}] total={total_ms:.2f}ms {parts}"
                f" fps={fps:.1f}{extra}"
            )
        self.history.append(rec)
        self.frame_index += 1
        return rec

    def summary(self, skip: int = 0) -> Dict[str, float]:
        hist = self.history[skip:] or self.history
        if not hist:
            return {}
        keys = set().union(*(h.keys() for h in hist))
        return {k: sum(h.get(k, 0.0) for h in hist) / len(hist) for k in keys}
