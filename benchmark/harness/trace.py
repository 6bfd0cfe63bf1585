"""The reduction from a profiler trace to what the per-layer readers read.

The traced run records the window with torch.profiler (CPU and CUDA
activities) and exports its Chrome trace; this module reads that trace's
device operations (kernels, copies, fills) and the benchmark's own host
spans (``bench.window``, ``bench.dispatch``, ``bench.resolve``, recorded
around the calls into the program). Times are in microseconds, on the
profiler's one clock.
"""

from __future__ import annotations

import dataclasses
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# K1: the sample loops of csrc/sample_kernel.cu (the regenerating loop and
# the lockstep one), whichever instantiation the view asks for
K1_KERNEL = re.compile(r"\b(regen_kernel|sample_kernel)\b")
D2H_COPY = re.compile(r"DtoH|Device -> Pageable|Device -> Pinned")


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start: float
    dur: float

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclasses.dataclass
class Trace:
    ops: list  # DeviceOp, sorted by start
    spans: list  # (name, start, end) of the benchmark's host spans
    window: tuple  # (start, end) of bench.window
    frames: int  # frames dispatched inside the window
    read_s: float = 0.0  # seconds to export and read the trace
    bytes: int = 0  # size of the exported trace

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self):
        t0, t1 = self.window
        return [o for o in self.ops if o.end > t0 and o.start < t1]

    def busy_us(self) -> float:
        """The union of device operations' intervals inside the window."""
        t0, t1 = self.window
        busy, cur_s, cur_e = 0.0, None, None
        for o in self.in_window():
            s, e = max(o.start, t0), min(o.end, t1)
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def total_us(self, pred) -> float:
        return sum(o.dur for o in self.in_window() if pred(o))

    def gaps(self):
        """Idle intervals (start, end) between device operations inside the
        window, the window's edges included."""
        t0, t1 = self.window
        out, cur = [], t0
        for o in self.in_window():
            if o.start > cur:
                out.append((cur, o.start))
            cur = max(cur, o.end)
        if t1 > cur:
            out.append((cur, t1))
        return out

    def host_span_at(self, t: float) -> str:
        """The innermost benchmark span around host time t."""
        best = None
        for name, s, e in self.spans:
            if s <= t <= e and name != "bench.window" and (
                    best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "bench.loop"


def load(path: str, frames: int) -> Trace:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append(DeviceOp(e["name"], cat, float(e["ts"]), float(e.get("dur", 0.0))))
        elif cat == "user_annotation" and e["name"].startswith("bench."):
            s = float(e["ts"])
            spans.append((e["name"], s, s + float(e.get("dur", 0.0))))
    ops.sort(key=lambda o: o.start)
    win = [s for s in spans if s[0] == "bench.window"]
    if not win:
        raise ValueError("the trace has no bench.window span")
    return Trace(ops, spans, (win[0][1], win[0][2]), frames)


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps, by the benchmark span the host was in at the gap's middle."""
    by_name = {}
    for o in tr.in_window():
        by_name[o.name] = by_name.get(o.name, 0.0) + o.dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.gaps(), key=lambda g: g[0] - g[1])[:10]
    return {
        "device_ops": [[n[:200], d * 1e-6] for n, d in top],
        "idle_gaps": [[tr.host_span_at(0.5 * (s + e)), (e - s) * 1e-6] for s, e in gaps],
    }
