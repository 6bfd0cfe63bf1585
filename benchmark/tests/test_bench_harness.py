"""A rehearsal of the harness on the CPU: cells run end to end at a tiny
size, new files are found by name, the result line keeps the contract,
faults in the timed path and the control come out not correct, and no
card means no result."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from benchmark.harness import bench, check, frames, trace  # noqa: E402

TINY = dict(width=32, height=24, spp=2, pixels=96, frames=3, ray_pixels=768, ray_samples=2,
            grid_count=12)
CELLS = ("demo-1080p-64spp", "field-1080p-4spp", "field-1080p-4spp-whole")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


def _run(cell="demo-1080p-64spp", seed=2024, seconds=3.0, traced=False):
    return bench.run_cell(cell, seed, seconds, traced, time.perf_counter(),
                          device="cpu", overrides=TINY, log=lambda m: None)


def test_cell_runs_on_the_cpu_and_keeps_the_contract():
    out = _run()
    assert set(out) == KEYS and list(out)[-1] == "check"
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"msamples_per_s", "frame_ms_p95", "setup_s"}
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["check"]["frame_mae"]["value"] <= out["check"]["frame_mae"]["limit"]
    json.dumps(out)


def test_traced_run_reports_per_layer_metrics_and_a_breakdown():
    out = _run(traced=True, seconds=2.0)
    assert set(out) == KEYS | {"breakdown"} and list(out)[-1] == "check"
    assert "dispatch_host_ms" in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device operations on the CPU: the device readers find nothing
    assert "k1_ms" not in out["metrics"] and "readback_ms" not in out["metrics"]


def _break(monkeypatch, fault):
    """Plant a fault under the timed path (the program's calls)."""
    from rayzen_tpu_torch import renderer

    real = renderer.render_radiance_with_stats
    if fault == "state_unchanged":  # the accumulator keeps its first frame
        real_acc = renderer.Renderer._accumulate

        def acc(self, img):
            if self._accum is None:
                return real_acc(self, img)
            self._accum_count += 1
            return self._accum
        monkeypatch.setattr(renderer.Renderer, "_accumulate", acc)
    elif fault == "half_the_samples":  # the mean over half the batch

        def half(arrays, cam, cfg, *a, **kw):
            return real(arrays, cam, cfg.replace(spp=max(1, cfg.spp // 2)), *a, **kw)
        monkeypatch.setattr(renderer, "render_radiance_with_stats", half)
    elif fault == "answer_altered":  # each frame's image altered where made

        def altered(*a, **kw):
            img, rays = real(*a, **kw)
            return torch.clamp(img + 0.01, 0.0, 1.0), rays
        monkeypatch.setattr(renderer, "render_radiance_with_stats", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_samples", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    _break(monkeypatch, fault)
    out = _run(cell, seconds=3.0)
    assert out["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_and_control_at_a_tiny_size(cell):
    """The program passes its cell's limits; the control (the reference in
    bfloat16, in the program's place, on the same frames) fails them."""
    c = bench.Cell(cell, "cpu", TINY)
    c.set_up(31)
    fl, _t0, _t1, _tr, px = c.window(31, 1.5, False)
    ok, _ = check.judge(c.check_numbers(31, fl, px), c.limits["limits"])
    assert ok
    ok, _ = check.judge(c.control_numbers(31, fl, px), c.limits["limits"])
    assert not ok


def _checkout(tmp_path, with_program=True):
    """A copy of what a checkout holds: BENCHMARK.json, the benchmark and,
    unless asked otherwise, the program."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(REPO, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root / "BENCHMARK.json")
    if with_program:
        shutil.copytree(os.path.join(REPO, "rayzen_tpu_torch"), root / "rayzen_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__", "build"))
    return root


def _py(root, code, timeout=300):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=root,
                          capture_output=True, text=True, timeout=timeout, env=env)


def test_new_config_traffic_metric_and_cell_are_found_by_name(tmp_path):
    root = _checkout(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/demo.json").read_text())
    cfg.update(name="toy", instances=cfg["instances"][:2])
    (root / "benchmark/configs/toy.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/toy-1spp.json").write_text(json.dumps(
        {"spp": 1, "in_flight": 3, "warmup_frames": 1, "key_span": 64, "render": {}}))
    (root / "benchmark/metrics/toy_frames.py").write_text(
        "def read(run):\n    return float(len(run.frames))\n")
    (root / "benchmark/limits/toy-cell.json").write_text(json.dumps(
        {"check": {"pixels": 64, "frames": 2, "ray_pixels": 192, "ray_samples": 1},
         "limits": {"frame_mae": 1e-3, "rays_gap": 1e-3}}))
    spec["configs"].append({"name": "toy", "source": "a test", "reduced": [],
                            "file": "benchmark/configs/toy.json", "why": "a test"})
    spec["workloads"].append({"name": "toy-cell", "config": "toy", "traffic": "toy-1spp",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "toy_frames", "unit": "frames", "better": "higher",
                              "source": "host_clock", "layer": "frame loop",
                              "moves": "msamples_per_s", "workloads": ["toy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = _py(root, """
        import json, sys, time
        sys.path.insert(0, ".")
        from benchmark.harness import bench
        out = bench.run_cell("toy-cell", 5, 1.0, True, time.perf_counter(), device="cpu",
                             overrides=dict(width=16, height=12), log=lambda m: None)
        print(json.dumps(out))
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["toy_frames"]["value"] >= 1


def test_no_card_no_result(tmp_path):
    root = _checkout(tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "demo-1080p-64spp",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_without_the_program_no_result(tmp_path):
    root = _checkout(tmp_path, with_program=False)
    r = _py(root, """
        import sys, time
        sys.path.insert(0, ".")
        from benchmark.harness import bench
        bench.run_cell("demo-1080p-64spp", 1, 1.0, False, time.perf_counter(), device="cpu")
    """)
    assert r.returncode != 0 and "rayzen_tpu_torch" in r.stderr


def test_nothing_loads_jax_or_the_jax_package():
    """Every module the benchmark runs, and a whole tiny run, leave no jax,
    jaxlib, flax or rayzen_tpu among the loaded modules' top-level names
    (compared whole: rayzen_tpu_torch is not rayzen_tpu)."""
    r = _py(REPO, """
        import importlib, json, pkgutil, sys, time
        sys.path.insert(0, ".")
        import benchmark.run, benchmark.calibrate, benchmark.work.count
        for sub in ("harness", "reference", "metrics", "work"):
            pkg = importlib.import_module("benchmark." + sub)
            for m in pkgutil.iter_modules(pkg.__path__):
                importlib.import_module(f"benchmark.{sub}.{m.name}")
        from benchmark.harness import bench
        bench.run_cell("demo-1080p-64spp", 3, 1.0, False, time.perf_counter(), device="cpu",
                       overrides=dict(width=16, height=12, spp=1, pixels=16, frames=2, ray_samples=1,
                                      ray_pixels=16),
                       log=lambda m: None)
        print(json.dumps(bench.forbidden_modules()))
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    found, tops = (json.loads(x) for x in r.stdout.strip().splitlines()[-2:])
    assert found == [] and "rayzen_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "rayzen_tpu"} & set(tops)


@pytest.mark.parametrize("where", ["metric", "reference"])
def test_jax_loaded_after_the_window_leaves_no_result(monkeypatch, where):
    """A module imported after the window (a per-layer reader, the
    reference) that loads jax stops the run before it returns a result."""
    def plant():
        monkeypatch.setitem(sys.modules, "jax", sys)

    if where == "metric":
        from benchmark.metrics import dispatch_host_ms

        real = dispatch_host_ms.read
        monkeypatch.setattr(dispatch_host_ms, "read", lambda run: (plant(), real(run))[1])
    else:
        real = check.reference
        monkeypatch.setattr(check, "reference", lambda *a, **k: (plant(), real(*a, **k))[1])
    with pytest.raises(bench.Refused, match="jax"):
        _run(traced=where == "metric", seconds=1.0)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rayzen_tpu_torch_x", sys)
    assert "rayzen_tpu" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rayzen_tpu.ops", sys)
    assert "rayzen_tpu" in bench.forbidden_modules()


def test_trace_reduction_on_a_synthetic_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.resolve", "ts": 40, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "void regen_kernel<rz::Bvh2Walk>(x)", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "add_kernel", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "ts": 80, "dur": 10},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    tr = trace.load(str(p), frames=2)
    assert tr.busy_us() == 35.0 and tr.window_us == 100.0
    assert tr.gaps() == [(0.0, 10.0), (35.0, 80.0), (90.0, 100.0)]
    bd = trace.breakdown(tr)
    assert bd["idle_gaps"][0][0] == "bench.resolve"
    assert bd["idle_gaps"][0][1] == pytest.approx(45e-6)
    from benchmark.metrics import device_idle_pct, glue_device_ms, k1_ms, readback_ms

    run = bench.Run("c", "demo", {}, 1, [], 0.0, 1.0, tr, None)
    assert k1_ms.read(run) == pytest.approx(0.01)
    assert glue_device_ms.read(run) == pytest.approx(0.005)
    assert readback_ms.read(run) == pytest.approx(0.005)
    assert device_idle_pct.read(run) == pytest.approx(65.0)


# -- scene kinds, the render options and the frame numbers --------------------

def _cell(cell="demo-1080p-64spp", **render):
    """A cell at the tiny size whose mix's render options are ``render``
    over its own."""
    c = bench.Cell(cell, "cpu", TINY)
    c.traffic["render"] = dict(c.traffic.get("render", {}), **render)
    return c


@pytest.mark.parametrize("render", [
    {"no_such_option": 1},  # not a RenderConfig field
    {"width": 64},  # the configuration's frame settings
    {"max_bounces": 2},
    {"spp": 3},  # the harness's
    {"cache_dir": "elsewhere"},
    {"single_tree": True, "chunk_tris": 5},
])
def test_render_options_the_mix_may_not_pass_are_refused(render):
    c = _cell(**render)
    with pytest.raises(bench.Refused, match="render option"):
        c.set_up(1)


def test_render_options_pass_through_by_name_over_todays_defaults():
    from benchmark.harness import scenes

    fr = bench.Cell("demo-1080p-64spp", "cpu", TINY).frame
    rc = bench.render_config(fr, {"spp": 2, "render": {
        "accumulate": False, "split_bounce": 2, "kernels": "xla", "wide_nodes": True}}, 10)
    assert (rc.accumulate, rc.split_bounce, rc.kernels, rc.wide_nodes) == (False, 2, "xla", True)
    # the three mixes as they were: accumulating, tiered as named, one tree
    # for the whole scene where single_tree says so
    for cell, tiered, single in ((CELLS[0], "auto", False), (CELLS[1], "auto", False),
                                 (CELLS[2], "off", True)):
        c = bench.Cell(cell, "cpu", TINY)
        n = scenes.num_triangles(c.scene)
        rc = bench.render_config(c.frame, c.traffic, n)
        assert c.accumulate and rc.accumulate
        assert (rc.tiered, rc.chunk_tris, rc.spp) == (tiered, n if single else 0, TINY["spp"])


def test_unaccumulated_frames_are_drawn_at_key_0():
    """Without accumulation the program draws every frame at key 0: each
    readback equals the reference's frame at key 0, and not at the frame's
    number. The harness numbers the frames as the program counts them."""
    c = _cell(accumulate=False)
    c.set_up(41)
    fl, _t0, _t1, _tr, px = c.window(41, 1.5, False)
    assert len(fl) >= 2
    assert [f.number for f in fl] == list(range(c.first, c.first + len(fl)))
    assert c.renderer.frame_index == c.first + len(fl)
    assert all(f.key == 0 for f in fl)
    assert all(np.array_equal(f.values, fl[0].values) for f in fl)
    ok, judged = check.judge(c.check_numbers(41, fl, px), c.limits["limits"])
    assert ok, judged
    for f in fl:
        f.key = f.number
    ok, _ = check.judge(c.check_numbers(41, fl, px), c.limits["limits"])
    assert not ok


# the parent harness's readings of fixed frame records (no timed window):
# the candidates drawn from seed 77, six frames numbered 40-45 whose
# read-back values are drawn from a fixed generator, the first with 2.5
# traced rays a path; sha256 of the chosen indices (int64) and of the
# reference's images (float64)
PINNED = {
    "demo-1080p-64spp": dict(
        idx=[0, 2, 3], ref_rpp=2.3984375,
        sel="49728a4a712980027717d747f114651cbe22b634871e9e2205cbbb2e16a36f51",
        ref="e9886557d65a04bc4a73a404e3e32b0ae0e4e76407129f841ffed8736c27df70",
        numbers={"frame_mae": 0.8318276979307561, "frame_p90": 1.9809885203838349, "frame_off_share": 1.0, "rays_gap": 0.04234527687296417}),
    "field-1080p-4spp": dict(
        idx=[0, 2, 3], ref_rpp=1.783203125,
        sel="56eb112e77b4f08f18c0d3221ebe68c9a5bdefe7753cc6840f407eabd7090dca",
        ref="ccc9fc603b1e01ca467108d524653682933c5785ce9b38164f618f8e0e73e4ae",
        numbers={"frame_mae": 0.8187021687459984, "frame_p90": 1.9590158939361584, "frame_off_share": 1.0, "rays_gap": 0.4019715224534502}),
    "field-1080p-4spp-whole": dict(
        idx=[0, 2, 3], ref_rpp=1.783203125,
        sel="56eb112e77b4f08f18c0d3221ebe68c9a5bdefe7753cc6840f407eabd7090dca",
        ref="ccc9fc603b1e01ca467108d524653682933c5785ce9b38164f618f8e0e73e4ae",
        numbers={"frame_mae": 0.8187021687459984, "frame_p90": 1.9590158939361584, "frame_off_share": 1.0, "rays_gap": 0.4019715224534502}),
}


@pytest.mark.parametrize("cell", CELLS)
def test_fixed_frames_read_as_before(cell):
    c = bench.Cell(cell, "cpu", TINY)
    w, h = c.frame["width"], c.frame["height"]
    cand = check.sample_pixels(77, w, h, check.CANDIDATES * c.chk["pixels"])
    vals = np.random.default_rng(5).random((6, cand[0].shape[0], 3), dtype=np.float32)
    fl = [frames.Frame(number=40 + i, key=frames.frame_key(40 + i, c.accumulate),
                       t_dispatch=0.0, t_dispatched=0.0, values=vals[i],
                       rays=2.5 * c.paths if i == 0 else 0.0) for i in range(6)]
    idx, sel, (ref, ref_rpp) = c.reference(77, fl, cand)
    want = PINNED[cell]
    assert list(idx) == want["idx"] and ref_rpp == want["ref_rpp"]
    assert hashlib.sha256(np.asarray(sel, np.int64).tobytes()).hexdigest() == want["sel"]
    assert hashlib.sha256(np.ascontiguousarray(ref, np.float64).tobytes()).hexdigest() \
        == want["ref"]
    assert c.check_numbers(77, fl, cand) == want["numbers"]


DRIFT_KIND = '''
"""A scene that moves every frame: the static scene with every instance
carried by (number mod 8) times ``drift``, handed to the Renderer through
update_transforms (its refit) before each dispatch."""

import numpy as np

from . import static

program = static.program


def scene(cfg, overrides):
    return dict(static.scene(cfg, overrides), drift=cfg["drift"])


def transforms(sc, number):
    step = np.eye(4, dtype=np.float32)
    step[:3, 3] = np.float32(number % 8) * np.asarray(sc["drift"], np.float32)
    return np.stack([(step @ x).astype(np.float32) for _, x, _ in sc["instances"]])


def before_dispatch(program, sc, number):
    program.update_transforms(transforms(sc, number))


def world(sc, number):
    return dict(sc, instances=[(m, x, mo) for (m, _, mo), x
                               in zip(sc["instances"], transforms(sc, number))])
'''


@pytest.fixture(scope="module")
def moving_runs(tmp_path_factory):
    """A scene kind that moves the demo's instances every frame, a mix that
    does not accumulate, a limits file and a cell, added to a copy of the
    benchmark as new files and entries alone; a sound run, a run whose
    program is handed the next frame's transforms, and one whose reference
    renders every frame in frame 0's world."""
    root = _checkout(tmp_path_factory.mktemp("moving"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    old = json.loads(json.dumps(spec))
    cfg = json.loads((root / "benchmark/configs/demo.json").read_text())
    cfg.update(name="drifting", kind="drift", drift=[0.05, 0.02, 0.0])
    (root / "benchmark/harness/kinds/drift.py").write_text(DRIFT_KIND)
    (root / "benchmark/configs/drifting.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/still-2spp.json").write_text(json.dumps(
        {"spp": 2, "in_flight": 2, "warmup_frames": 1, "key_span": 16,
         "render": {"accumulate": False}}))
    (root / "benchmark/limits/drifting-cell.json").write_text(json.dumps(
        {"check": {"pixels": 64, "frames": 3, "ray_pixels": 192, "ray_samples": 1},
         "limits": {"frame_mae": 1e-3, "frame_p90": 2e-3, "frame_off_share": 0.02,
                    "rays_gap": 0.05}}))
    spec["configs"].append({"name": "drifting", "source": "a test", "reduced": [],
                            "file": "benchmark/configs/drifting.json", "why": "a test"})
    spec["workloads"].append({"name": "drifting-cell", "config": "drifting",
                              "traffic": "still-2spp", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = _py(root, """
        import json, sys, time
        sys.path.insert(0, ".")
        from benchmark.harness import bench
        from benchmark.harness.kinds import drift

        hook, world = drift.before_dispatch, drift.world
        out = {}
        for fault in ("none", "program_ahead", "reference_frozen"):
            drift.before_dispatch = ((lambda p, sc, n: hook(p, sc, n + 1))
                                     if fault == "program_ahead" else hook)
            drift.world = ((lambda sc, n: world(sc, 0))
                           if fault == "reference_frozen" else world)
            out[fault] = bench.run_cell("drifting-cell", 5, 1.0, False, time.perf_counter(),
                                        device="cpu", overrides=dict(width=16, height=12),
                                        log=lambda m: None)
        print(json.dumps(out))
    """, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    # no file edited; BENCHMARK.json only has entries added at the ends
    edited = [str(p) for p, b in before.items()
              if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    new = json.loads((root / "BENCHMARK.json").read_text())
    edited += [k for k, v in old.items()
               if (new[k][:len(v)] if isinstance(v, list) else new[k]) != v]
    return json.loads(r.stdout.strip().splitlines()[-1]), edited


@pytest.mark.parametrize("fault, correct", [
    ("none", True), ("program_ahead", False), ("reference_frozen", False)])
def test_a_scene_that_moves_every_frame_is_added_as_files(moving_runs, fault, correct):
    outs, edited = moving_runs
    assert edited == []
    out = outs[fault]
    assert out["attempted"] >= 3 and out["failed"] == 0
    assert out["correct"] is correct, out["check"]
