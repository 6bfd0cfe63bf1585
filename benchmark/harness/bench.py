"""One run of one cell: set-up, the measured window, the per-layer readers
and the check, as data in BENCHMARK.json and the files it names say.

A cell (BENCHMARK.json ``workloads``) names a configuration (its ``file``,
configs/<name>.json), a traffic mix (traffic/<traffic>.json) and the
chips. The configuration's scene kind is found by name (its ``"kind"``,
kinds/<kind>.py: the scene arrays, the program object, a hook before each
dispatch, the reference's world at a frame), as are the per-layer metrics
(metrics/<name>.py, a ``read(run)`` that returns a number or None) and the
check's limits (limits/<cell>.json). Nothing here names a cell, so a later
change adds a configuration, a kind, a mix, a metric or a cell as files
and entries.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import check, frames, kinds, scenes
from . import trace as trace_mod
from .peaks import peak_for

REPO = os.path.dirname(scenes.BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "rayzen_tpu")
# the Renderer's options where the traffic file's ``render`` block leaves
# them out; ``single_tree`` sets chunk_tris to the scene's triangles
RENDER_DEFAULTS = {"accumulate": True, "tiered": "auto"}
# RenderConfig fields that the harness sets itself (the frame settings of
# the configuration besides): a traffic file may not pass them
HARNESS_FIELDS = ("spp", "log_level", "cache_dir")


class NoDevice(RuntimeError):
    pass


class Refused(RuntimeError):
    pass


@dataclasses.dataclass
class Run:
    """What the per-layer readers read."""

    cell: str
    config_name: str
    frame: dict  # the configuration's frame settings
    spp: int
    frames: list  # frames.Frame of the window
    t_start: float
    t_end: float
    trace: object  # trace.Trace, or None without --trace 1
    peak: dict | None


def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _entry(items, name):
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(name)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (rayzen_tpu_torch is not rayzen_tpu)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def window_numbers(fl, t_start: float, t_end: float, paths: int):
    """(the frames read back in the window, Msamples/s, their latencies in
    ms): the samples of every frame read back in the window, over the time
    from the window's start to the last of them."""
    done = [f for f in fl if f.t_done <= t_end]
    msps = len(done) * paths / (done[-1].t_done - t_start) / 1e6 if done else 0.0
    return done, msps, [(f.t_done - f.t_dispatch) * 1e3 for f in done]


def render_options(traffic: dict) -> dict:
    """The traffic file's ``render`` block over RENDER_DEFAULTS."""
    return {**RENDER_DEFAULTS, **traffic.get("render", {})}


def render_config(fr: dict, traffic: dict, n_tris: int):
    """The program's RenderConfig: the configuration's frame settings
    ``fr``, the mix's spp, and its ``render`` options by name. An option
    that RenderConfig lacks, or that the frame settings or the harness set,
    is refused: the run never renders something else than it says."""
    from rayzen_tpu_torch.config import RenderConfig

    opts = render_options(traffic)
    single = bool(opts.pop("single_tree", False))
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    for k in opts:
        if k not in fields:
            raise Refused(f"render option {k!r}: RenderConfig has no such field")
        if k in fr or k in HARNESS_FIELDS or (single and k == "chunk_tris"):
            raise Refused(f"render option {k!r}: set by the configuration or the harness")
    return RenderConfig(
        width=fr["width"], height=fr["height"], spp=int(traffic["spp"]),
        max_bounces=fr["max_bounces"], rr_start_bounce=fr["rr_start_bounce"],
        rng=fr["rng"], ambient=tuple(fr["ambient"]),
        sky_horizon=tuple(fr["sky_horizon"]), sky_zenith=tuple(fr["sky_zenith"]),
        shadow_min_visibility=fr["shadow_min_visibility"],
        chunk_tris=n_tris if single else 0,
        log_level="error", cache_dir=os.path.join(REPO, ".rayzen_cache"),
        **{k: tuple(v) if isinstance(v, list) else v for k, v in opts.items()})


def _smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def _profiled_window(renderer, seconds, in_flight, xs, ys, cuda: bool, **loop):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tmp = tempfile.mkdtemp(prefix="rz_bench_")
    try:
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                out = frames.run_window(renderer, seconds, in_flight, xs, ys,
                                        span=record_function, **loop)
            if cuda:
                torch.cuda.synchronize()
        t = time.perf_counter()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        tr = trace_mod.load(path, frames=len(out[0]))
        tr.read_s, tr.bytes = time.perf_counter() - t, os.path.getsize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, tr


class Cell:
    """A cell set up for runs: its files read, the program built by the
    configuration's kind and warmed up. ``overrides`` replaces frame
    settings, check sizes and the kind's sizes (the CPU tests run a cell at
    a tiny size; the command line never passes it)."""

    def __init__(self, name: str, device: str = "cuda", overrides: dict | None = None):
        sp = spec()
        self.spec = sp
        self.name = name
        self.entry = _entry(sp["workloads"], name)
        conf = _entry(sp["configs"], self.entry["config"])
        self.device = device
        t = time.perf_counter()
        if device == "cuda" and (not torch.cuda.is_available()
                                 or torch.cuda.device_count() < self.entry["chips"]):
            raise NoDevice(
                f"cell {name} needs {self.entry['chips']} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        t_scene = time.perf_counter()
        overrides = overrides or {}
        cfg_json = scenes.load_config(os.path.join(REPO, conf["file"]))
        with open(os.path.join(scenes.BENCH_DIR, "traffic",
                               self.entry["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        with open(os.path.join(check.LIMITS_DIR, name + ".json")) as f:
            self.limits = json.load(f)
        self.chk = dict(self.limits["check"])
        for k in ("pixels", "frames", "ray_pixels", "ray_samples"):
            self.chk[k] = overrides.get(k, self.chk[k])
        cfg_json.update({k: v for k, v in overrides.items()
                         if k in ("width", "height", "max_bounces")})
        if "spp" in overrides:
            self.traffic["spp"] = overrides["spp"]
        try:
            self.kind = kinds.load(cfg_json)
        except kinds.UnknownKind as e:
            raise Refused(str(e)) from None
        self.scene = self.kind.scene(cfg_json, overrides)
        self.frame = self.scene["frame"]
        self.spp = int(self.traffic["spp"])
        self.paths = self.frame["width"] * self.frame["height"] * self.spp
        self.renderer = None
        self.first = 0  # the window's first frame number (set_up)
        self.setup_parts = {"cuda_check_s": t_scene - t,
                            "scene_s": time.perf_counter() - t_scene}

    @property
    def accumulate(self) -> bool:
        """Whether the program accumulates the frames (the mix's option)."""
        return bool(render_options(self.traffic)["accumulate"])

    def set_up(self, seed: int) -> None:
        """Build the program (kernel library, pack, start-up) and warm it
        up at the window's shapes; the seed picks the frames' numbers."""
        t_import = time.perf_counter()
        import rayzen_tpu_torch.renderer  # noqa: F401  (the system under test)

        t = time.perf_counter()
        warm = int(self.traffic["warmup_frames"])
        if warm < 1 and not self.accumulate:
            raise Refused("a mix that does not accumulate needs warmup_frames >= 1: "
                          "the program draws frame 0 with its first-frame bounces")
        if self.renderer is None:
            rcfg = render_config(self.frame, self.traffic, scenes.num_triangles(self.scene))
            self.renderer = self.kind.program(self.scene, rcfg, self.device)
        t_warm = time.perf_counter()
        self.renderer.reset_accumulation()
        start = int(seed) % int(self.traffic["key_span"])
        self.renderer.frame_index = start
        frames.warm_up(self.renderer, warm, start, self._before)
        self.first = start + warm
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.setup_parts.update({
            "program_import_s": t - t_import, "renderer_s": t_warm - t,
            "warmup_s": time.perf_counter() - t_warm,
            **{k: v * 1e-3 for k, v in self.renderer.startup_steps.items()}})

    def _before(self, program, number: int) -> None:
        """The kind's hook before the dispatch of frame ``number``."""
        self.kind.before_dispatch(program, self.scene, number)

    def ray_pixels(self, seed: int):
        """The pixels of the reference's ray count, drawn from the seed."""
        return check.sample_pixels(seed + 1, self.frame["width"], self.frame["height"],
                                   self.chk["ray_pixels"])

    def window(self, seed: int, seconds: float, traced: bool):
        """The measured window: (frames, t_start, t_end, trace or None,
        the candidate pixels (xs, ys) whose values each frame keeps)."""
        xs, ys = check.sample_pixels(seed, self.frame["width"], self.frame["height"],
                                     check.CANDIDATES * self.chk["pixels"])
        n = int(self.traffic["in_flight"])
        loop = dict(first=self.first, accumulate=self.accumulate, before=self._before)
        if traced:
            (fl, t0, t1), tr = _profiled_window(self.renderer, seconds, n, xs, ys,
                                                self.device == "cuda", **loop)
        else:
            (fl, t0, t1), tr = frames.run_window(self.renderer, seconds, n, xs, ys,
                                                 **loop), None
        return fl, t0, t1, tr, (xs, ys)

    def checked(self, cand, world: dict) -> np.ndarray:
        """The candidates' indices that the check compares, chosen on the
        reference's ``world`` (the first checked frame's)."""
        imgs, _ = check.reference(world, self.frame, self.spp, cand, cand, 1,
                                  list(check.SENSITIVITY_KEYS), self.device)
        score = np.abs(imgs[0] - imgs[1]).max(axis=-1)
        return check.choose_pixels(score, self.chk["pixels"])

    def reference(self, seed: int, fl, cand, spp=None, dtype=torch.float32):
        """The checked frames and pixels, and the reference's images of
        them, each from the kind's world at the frame's number and with
        its recorded key, and its rays a path."""
        idx = check.sample_frames(seed, len(fl), self.chk["frames"])
        worlds = [self.kind.world(self.scene, fl[j].number) for j in idx]
        sel = self.checked(cand, worlds[0])
        keys = [fl[j].key for j in idx]
        pixels = (cand[0][sel], cand[1][sel])
        return idx, sel, check.reference(
            worlds, self.frame, spp or self.spp, pixels, self.ray_pixels(seed),
            self.chk["ray_samples"], keys, self.device, dtype)

    def check_numbers(self, seed: int, fl, cand) -> dict:
        """The compared numbers of a window's frames: the frames that the
        accumulated readbacks imply, or each readback where the program
        does not accumulate."""
        idx, sel, (ref_img, ref_rpp) = self.reference(seed, fl, cand)
        vals = np.stack([f.values[sel] for f in fl])
        got = (check.implied_frames(vals, idx) if self.accumulate
               else vals[idx].astype(np.float64))
        return check.numbers(got, ref_img, fl[0].rays / self.paths, ref_rpp, idx,
                             self.accumulate)

    def control_numbers(self, seed: int, fl, pixels) -> dict:
        """The control in the program's place: the reference in bfloat16,
        judged by the same numbers against the float32 reference, on the
        frames and pixels a run checks."""
        idx, _, (low, low_rpp) = self.reference(seed, fl, pixels, dtype=torch.bfloat16)
        *_, (ref, ref_rpp) = self.reference(seed, fl, pixels)
        return check.numbers(low, ref, low_rpp, ref_rpp, idx, self.accumulate)


def run_cell(name: str, seed: int, seconds: float, traced: bool, t0: float,
             device: str = "cuda", overrides: dict | None = None, log=print):
    """One run; returns the result object of the contract's last line."""
    c = Cell(name, device, overrides)
    t_cell = time.perf_counter()
    c.set_up(seed)
    setup_s = time.perf_counter() - t0
    log(f"# setup {setup_s:.3f} s: to the cell's files read {t_cell - t0:.3f} s, "
        + ", ".join(f"{k} {v:.3f}" for k, v in c.setup_parts.items()))
    fl, t_start, t_end, tr, pixels = c.window(seed, seconds, traced)
    if tr is not None:
        log(f"# trace: {tr.bytes} B exported and read in {tr.read_s:.2f} s")

    dev_name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    mem_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    done, msps, lat = window_numbers(fl, t_start, t_end, c.paths)
    window = t_end - t_start
    prog_rpp = float(np.mean([f.rays for f in fl])) / c.paths
    log(f"# {name} seed={seed}: {len(done)} frames read back in {window:.3f} s "
        f"({len(fl)} dispatched), {msps:.4f} Msamples/s, latency median "
        f"{statistics.median(lat) if lat else float('nan'):.3f} ms, "
        f"{prog_rpp * msps:.1f} Mrays/s; memory peak {mem_peak} B; "
        f"card: {_smi() if device == 'cuda' else 'cpu'}")
    from rayzen_tpu_torch import ext

    log(f"# launches per frame: "
        f"{sum(ext.LAUNCHES.values()) / max(1, c.renderer.profiler.frame_index):.2f}")

    run = Run(name, c.entry["config"], c.frame, c.spp, fl, t_start, t_end, tr,
              peak_for(dev_name))
    metrics = {}
    if traced:
        for m in c.spec["per_layer"]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            v = importlib.import_module(f"benchmark.metrics.{m['name']}").read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {"msamples_per_s": msps, "setup_s": setup_s,
                  "frame_ms_p95": float(np.percentile(lat, 95)) if lat else None}
        for m in c.spec["end_to_end"]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    # the check: the program's state freed first, the reference after
    c.renderer = None
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums = c.check_numbers(seed, fl, pixels)
    correct, judged = check.judge(nums, c.limits["limits"])
    log(f"# check: {c.chk['frames']} frames x {c.chk['pixels']} pixels in "
        f"{time.perf_counter() - t_ref:.2f} s; numbers {nums}")
    out = {
        "correct": bool(correct), "attempted": len(fl),
        "failed": sum(f.values is None for f in fl), "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else "cpu", "kind": dev_name,
                   "count": int(c.entry["chips"]), "memory_peak_bytes": int(mem_peak)},
    }
    if tr is not None:
        out["device"]["busy_s"] = tr.busy_us() * 1e-6
        out["device"]["window_s"] = tr.window_us * 1e-6
        out["breakdown"] = trace_mod.breakdown(tr)
    out["check"] = judged
    # last, once the metric readers and the reference have been imported
    found = forbidden_modules()
    if found:
        raise Refused(f"modules loaded that the benchmark may not load: {found}")
    return out
