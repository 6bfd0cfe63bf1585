"""The readers of the program's spans (harness/program_spans.py and the
five metrics on it) on a synthetic trace whose clock runs at an offset and
a drift from the host's, checked by hand; None where the alignment is
loose, where the trace has no device operations and where the program
records no spans; and a traced run on the CPU reports the two host
readers."""

import os
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from benchmark.harness import bench, program_spans, trace  # noqa: E402
from benchmark.metrics import (  # noqa: E402
    idle_dispatch_ms, idle_resolve_ms, k1_launch_host_ms, readback_wait_ms,
    refit_host_ms)

READERS = (refit_host_ms, k1_launch_host_ms, readback_wait_ms, idle_dispatch_ms,
           idle_resolve_ms)
RATE = 1e6 * (1 + 20e-6)  # trace microseconds a host second: 20 ppm of drift
OFFSET = 1.7e12  # the trace clock's origin, far from the host's
T0 = 1000.0  # host seconds at the first dispatch
N, STEP = 4, 0.05  # frames, 50 ms apart


def on_trace(host_s: float) -> float:
    return OFFSET + RATE * (host_s - T0)


def synthetic(jitter_us: float = 3.0, device: bool = True):
    """(run, program span records): per frame at host time t (in ms after
    it) a dispatch 0.01-8 holding the refit 1-2 and K1's launch 3-3.5, a
    resolve 20-30 holding the image readback 20.1-29; on the device K1 4-24
    and the copy 25-28. The benchmark's dispatch spans start at t, give or
    take ``jitter_us``."""
    ms = 1e-3
    records, ops, spans, frames = [], [], [], []
    for k in range(N):
        t = T0 + k * STEP
        frames.append(bench.frames.Frame(k, t, t + 8 * ms))
        jitter = jitter_us if k % 2 else -jitter_us
        spans.append(("bench.dispatch", on_trace(t) + jitter, on_trace(t + 8 * ms)))
        for name, parent, a, b in (
                ("rz.frame.dispatch", None, 0.01, 8), ("rz.refit", "rz.frame.dispatch", 1, 2),
                ("rz.k1.launch", "rz.frame.dispatch", 3, 3.5),
                ("rz.frame.resolve", None, 20, 30),
                ("rz.readback.image", "rz.frame.resolve", 20.1, 29)):
            records.append((name, k, parent, round((t + a * ms) * 1e9),
                            round((t + b * ms) * 1e9)))
        if device:
            ops.append(trace.DeviceOp("void regen_kernel<rz::Bvh2Walk>(x)", "kernel",
                                      on_trace(t + 4 * ms), RATE * 20 * ms))
            ops.append(trace.DeviceOp("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
                                      on_trace(t + 25 * ms), RATE * 3 * ms))
    window = (on_trace(T0 - 1 * ms), on_trace(T0 + N * STEP))
    spans.append(("bench.window", *window))
    tr = trace.Trace(ops, spans, window, N)
    run = bench.Run("c", "demo", {}, 1, frames, T0, T0 + N * STEP, tr, None)
    return run, records


def _values(monkeypatch, run, records):
    monkeypatch.setattr(program_spans, "_recorded", lambda: records)
    return [r.read(run) for r in READERS]


def test_the_five_readers_by_hand(monkeypatch):
    run, records = synthetic()
    drift = RATE / 1e6
    refit, launch, wait, idle_d, idle_r = _values(monkeypatch, run, records)
    assert refit == pytest.approx(1.0 * drift, abs=1e-4)
    assert launch == pytest.approx(0.5 * drift, abs=1e-4)
    # the copy starts 4.9 ms into the image readback
    assert wait == pytest.approx(4.9 * drift, abs=1e-2)
    # idle before K1 in the dispatch (0.01-4); in the resolve 24-25 and 28-30
    assert idle_d == pytest.approx(3.99 * drift, abs=1e-2)
    assert idle_r == pytest.approx(3.0 * drift, abs=1e-2)
    # without the jitter, the line recovers the rate and the offset
    run, _ = synthetic(jitter_us=0.0)
    a, b, residual = program_spans.fit([f.t_dispatch - T0 for f in run.frames],
                                       [s - OFFSET for n, s, _ in run.trace.spans
                                        if n == "bench.dispatch"])
    assert a == pytest.approx(RATE, rel=1e-9) and abs(b) < 1e-3 and residual < 1e-3


def test_a_single_frame_aligns_at_the_nominal_rate(monkeypatch):
    run, records = synthetic(jitter_us=0.0)
    run.frames = run.frames[:1]
    first = min(s for n, s, _ in run.trace.spans if n == "bench.dispatch")
    run.trace.spans = [sp for sp in run.trace.spans
                       if sp[0] != "bench.dispatch" or sp[1] == first]
    refit, launch, wait, *_ = _values(monkeypatch, run, records)
    assert refit == pytest.approx(1.0, abs=1e-4) and launch == pytest.approx(0.5, abs=1e-4)
    assert wait == pytest.approx(4.9, abs=1e-2)


def test_loose_alignment_reads_none(monkeypatch):
    run, records = synthetic(jitter_us=200.0)
    assert _values(monkeypatch, run, records) == [None] * 5


def test_no_device_operations_read_none(monkeypatch):
    run, records = synthetic(device=False)
    refit, launch, *device = _values(monkeypatch, run, records)
    assert refit == pytest.approx(1.0, rel=1e-3) and launch == pytest.approx(0.5, rel=1e-3)
    assert device == [None] * 3


def test_a_program_without_spans_reads_none(monkeypatch):
    from rayzen_tpu_torch import profiler

    run, _ = synthetic()
    monkeypatch.delattr(profiler, "spans")
    assert [r.read(run) for r in READERS] == [None] * 5
    monkeypatch.undo()
    run.trace = None
    assert [r.read(run) for r in READERS] == [None] * 5


def test_traced_cpu_run_reports_the_host_readers():
    out = bench.run_cell("demo-1080p-64spp", 2024, 2.0, True, time.perf_counter(),
                         device="cpu", overrides=dict(
                             width=32, height=24, spp=2, pixels=96, frames=3,
                             ray_pixels=768, ray_samples=2),
                         log=lambda m: None)
    assert {"refit_host_ms", "k1_launch_host_ms"} <= set(out["metrics"])
    assert out["metrics"]["refit_host_ms"]["value"] > 0
    # no device operations on the CPU: the trace readers find nothing
    assert not {"readback_wait_ms", "idle_dispatch_ms", "idle_resolve_ms"} & set(out["metrics"])
