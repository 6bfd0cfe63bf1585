"""The frame loop's spans (profiler.span) on the CPU: off, nothing is
recorded and the shared no-op context is returned; under torch.profiler,
three frames two in flight carry their numbers through the dispatch's and
the resolve's children, nested in time, and the exported trace holds them
as user annotations; the buffer stops at its bound; the synchronous
frame's history keeps its phase keys. Demo scene, 24x16, 1 spp, 1 bounce,
accumulating under the FPS overlay, with the plain K1 walk replaced by a
constant wave: the spans are under test here, and
tests/test_torch_renderer_async.py holds the frames."""

import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rayzen_tpu_torch import RenderConfig, demo, profiler
from rayzen_tpu_torch.ops import megakernel
from rayzen_tpu_torch.renderer import Renderer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 24, 16
DISPATCH_CHILDREN = {"rz.refit", "rz.k1.launch", "rz.accumulate", "rz.overlay"}
RESOLVE_CHILDREN = {"rz.readback.image", "rz.readback.rays"}


def _constant_wave(ws, cfg, uv, active, camera_params, samp, rng_key,
                   max_bounces, n_samples):
    n = uv.shape[0]
    return (torch.full((n, 3), 0.5 * n_samples),
            torch.tensor(n * n_samples, dtype=torch.int64))


@pytest.fixture(scope="module")
def renderer(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(megakernel, "sample_wave_reference", _constant_wave)
        cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=1, accumulate=True,
                           show_fps_overlay=True,
                           cache_dir=str(tmp_path_factory.mktemp("cache")))
        yield Renderer(demo.build_demo_scene(W, H), cfg, async_compile=False,
                       device="cpu")


@pytest.fixture(autouse=True)
def empty_buffer():
    profiler._SPANS.clear()
    yield
    profiler._SPANS.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_enters_no_range(renderer, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiler.span("rz.a") is profiler.span("rz.b", frame=3) is profiler._NO_SPAN
    renderer.render_frame_async("pt").resolve()
    renderer.render_frame("pt")
    assert profiler.spans() == []


def _by_frame(spans, name):
    return {s[1]: s for s in spans if s[0] == name}


def _inside(child, parent):
    return parent[3] <= child[3] <= child[4] <= parent[4]


def test_frames_in_flight_carry_their_numbers_and_nest(renderer, tmp_path):
    with _cpu_profile() as prof:
        first = renderer.render_frame_async("pt")
        second = renderer.render_frame_async("pt")
        first.resolve()
        third = renderer.render_frame_async("pt")
        second.resolve()
        third.resolve()
    numbers = [first.frame_no, second.frame_no, third.frame_no]
    spans = profiler.spans()
    dispatch = _by_frame(spans, "rz.frame.dispatch")
    resolve = _by_frame(spans, "rz.frame.resolve")
    assert sorted(dispatch) == sorted(resolve) == numbers
    for outer, children in (("rz.frame.dispatch", DISPATCH_CHILDREN),
                            ("rz.frame.resolve", RESOLVE_CHILDREN)):
        parents = dispatch if outer == "rz.frame.dispatch" else resolve
        for n in numbers:
            assert parents[n][2] is None
            kids = [s for s in spans if s[2] == outer and s[1] == n]
            assert {s[0] for s in kids} == children
            assert all(_inside(s, parents[n]) for s in kids)
    # the second frame was dispatched before the first was resolved
    assert dispatch[numbers[1]][4] <= resolve[numbers[0]][3]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = collections.Counter(
        e["name"] for e in json.loads(path.read_text())["traceEvents"]
        if e.get("cat") == "user_annotation" and e["name"].startswith("rz."))
    for name in DISPATCH_CHILDREN | RESOLVE_CHILDREN | {"rz.frame.dispatch",
                                                       "rz.frame.resolve"}:
        assert names[name] == 3, name


def test_buffer_stops_at_its_bound(monkeypatch):
    assert profiler._SPANS.maxlen == profiler.SPAN_BUFFER == 65536
    monkeypatch.setattr(profiler, "_SPANS", collections.deque(maxlen=4))
    with _cpu_profile():
        for i in range(6):
            with profiler.span("rz.test", frame=i):
                pass
    assert [s[1] for s in profiler.spans()] == [2, 3, 4, 5]


def test_synchronous_frame_keeps_its_phase_keys(renderer):
    with _cpu_profile():
        renderer.render_frame("pt")
    rec = renderer.profiler.history[-1]
    assert {"update", "render", "overlay", "readback", "total", "fps",
            "mrays_per_s"} <= set(rec)
    spans = profiler.spans()
    frame = [s for s in spans if s[0] == "rz.frame"]
    assert len(frame) == 1 and frame[0][1] == renderer.frame_index - 1
    assert all(s[1] == frame[0][1] for s in spans)
    assert {s[0] for s in spans if s[2] == "rz.frame"} == {
        "rz.update", "rz.render", "rz.accumulate", "rz.overlay", "rz.readback"}
    assert {s[0] for s in spans if s[2] == "rz.render"} == {"rz.refit", "rz.k1.launch"}
    assert {s[0] for s in spans if s[2] == "rz.readback"} == RESOLVE_CHILDREN
    assert [s for s in spans if s[0] == s[2]] == []  # no span inside its namesake
