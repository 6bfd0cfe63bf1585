"""K1's schedule on one NVIDIA GPU, timed in turns against other builds of K1.

Builds the port's kernels (rayzen_tpu_torch/csrc) of this tree and of the
trees named on the command line, loads them side by side (ext.bind), and on
the demo scene at 1920x1080 / 64 spp and the 503k-triangle field of
chip_smoke.py at 1920x1080 / 4 spp (through the tiered view, and over the
whole tree with tiered="off"), for each build:
  - renders the frames of its forms: K1 (the demo in both RNG flows, the field
    tiered and whole, the demo with wide_nodes), its K9 forms
    (octant_bounce_walks: demo, tiered field, wide demo, whole field), its
    K6 forms (frustum_primary, with and without K9: demo, whole field), and
    holds each against the first build's (bit for bit, with its ray count,
    and the pixels that differ) and each K9 and K6 frame against the same
    build's K1 frame of its view;
  - reads its K1 forms' compiled budgets (registers, local bytes per
    thread, resident warps per SM: megakernel.sample_budget) and the spill
    stores of nvcc's -Xptxas -v report, where the build has them;
  - counts each form's walk-loop lane utilisation
    (megakernel.walk_lane_counts), where the build has its counting form;
then times each form's kernel alone and the demo and field dispatches
(render_radiance_with_stats, refit included), every timed build in turns
(a b c, c b a) x 3, one call each, with CUDA events.

Run from the root of a checkout, on a machine with a CUDA device and nvcc:

    python scripts/k1_schedule.py [--tree NAME=DIR[:DEFINE,...]]...
                                  [--sweep [POINT,...]] [--count NAME=DIR]...
                                  [--forms PREFIX,...] [--out FILE]

--tree: a build to time, from DIR/rayzen_tpu_torch/csrc ("." is this tree)
with nvcc -D DEFINEs; the first is the reference of the bitwise checks (by
default ".", alone). --sweep adds this tree at each register budget of
SWEEP, or at the named points of it. --count: a build used only for its
frames and lane counts (a copy of an older K1 with the counter added).
--forms: only the frames whose names start with a PREFIX (and the
K1 frames they are held to), and no dispatches. Prints one JSON object as
its last line, and writes it to --out.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# The register sweep: (name, threads per block, blocks per SM that
# __launch_bounds__ asks for). Registers per thread are held to 65536 /
# (threads x blocks): b1 leaves them free (up to 255).
SWEEP = [("t128b1", 128, 1), ("t128b4", 128, 4), ("t128b5", 128, 5),
         ("t128b6", 128, 6), ("t128b8", 128, 8), ("t128b10", 128, 10),
         ("t128b12", 128, 12), ("t128b16", 128, 16), ("t64b16", 64, 16),
         ("t64b20", 64, 20), ("t256b2", 256, 2), ("t256b3", 256, 3),
         ("t256b4", 256, 4), ("t256b5", 256, 5)]


def _spec(arg: str):
    """NAME=DIR[:DEFINE,...] -> (name, csrc dir, defines)."""
    name, rest = arg.split("=", 1)
    tree, _, defs = rest.partition(":")
    csrc = os.path.join(os.path.abspath(tree), "rayzen_tpu_torch", "csrc")
    return name, csrc, tuple(d for d in defs.split(",") if d)


def _lib_path(name: str, csrc: str) -> str:
    return os.path.join(csrc, "build", f"k1s-{name}", "librayzen_kernels.so")


def build_all(specs) -> dict:
    """Build every spec, one process each, all at once; returns name -> the
    nvcc log (ptxas report)."""
    procs = {}
    for name, csrc, defines in specs:
        out = _lib_path(name, csrc)
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--build", csrc, out,
             *defines], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"build {name} failed:\n{logs[name][-4000:]}")
    return logs


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--build"]:  # one build, in its own process
        from rayzen_tpu_torch import ext

        ext.build(force=True, csrc=args[1], out=args[2], defines=tuple(args[3:]))
        print(ext.build_log)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("k1_schedule: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import build_field_scene, nvidia_smi_line, timed
    from rayzen_tpu_torch import ext
    from rayzen_tpu_torch.config import RenderConfig
    from rayzen_tpu_torch.demo import build_demo_scene
    from rayzen_tpu_torch.integrator import render_radiance_with_stats
    from rayzen_tpu_torch.ops import megakernel
    from rayzen_tpu_torch.ops.camera_rays import pixel_grid
    from rayzen_tpu_torch.packing import pack_scene, world_geometry

    trees, counts, out_path, prefixes = [], [], None, None
    i = 0
    while i < len(args):
        if args[i] == "--tree":
            trees.append(_spec(args[i + 1]))
            i += 2
        elif args[i] == "--count":
            counts.append(_spec(args[i + 1]))
            i += 2
        elif args[i] == "--sweep":
            points = None
            if i + 1 < len(args) and not args[i + 1].startswith("--"):
                points = args[i + 1].split(",")
                i += 1
            trees += [(n, os.path.join(ROOT, "rayzen_tpu_torch", "csrc"),
                       (f"RZ_K1_THREADS={t}", f"RZ_K1_MIN_BLOCKS={b}"))
                      for n, t, b in SWEEP if points is None or n in points]
            i += 1
        elif args[i] == "--forms":
            prefixes = tuple(args[i + 1].split(","))
            i += 2
        elif args[i] == "--out":
            out_path = args[i + 1]
            i += 2
        else:
            raise SystemExit(f"unknown argument {args[i]}")
    if not trees:
        trees = [_spec(".=.")]
    t0 = time.perf_counter()

    def say(msg):
        print(f"{msg} [{time.perf_counter() - t0:.0f} s]", flush=True)

    kind, smi = torch.cuda.get_device_name(0), nvidia_smi_line()
    say(f"[device] {kind} | {smi}")
    logs = build_all(trees + counts)
    say(f"[build] {len(logs)} builds")
    libs = {}
    for name, csrc, _defs in trees + counts:
        L = ext.bind(_lib_path(name, csrc))
        if L.rz_sample_params_size() != ext.ctypes.sizeof(ext.SampleParams):
            raise RuntimeError(f"{name}: SampleParams layout differs")
        libs[name] = L

    dev = torch.device("cuda", 0)
    mcfg = RenderConfig(width=1920, height=1080, spp=64, max_bounces=5)
    mscene = build_demo_scene(1920, 1080)
    marrays = pack_scene(mscene, mcfg, dev)
    mws, mcam = world_geometry(marrays), mscene.camera.device_params()
    fcfg = RenderConfig(width=1920, height=1080, spp=4, max_bounces=5)
    fscene = build_field_scene(1920, 1080)
    farrays = pack_scene(fscene, fcfg, dev)
    fws, fcam = world_geometry(farrays), fscene.camera.device_params()
    if not fws.tiered:
        raise RuntimeError("the field did not pack tiered")
    whole = world_geometry(pack_scene(fscene, fcfg.replace(tiered="off"), dev))
    _, uv = pixel_grid(1920, 1080, dev)
    act = torch.ones(uv.shape[0], dtype=torch.bool, device=dev)
    say("[scenes] demo and field packed")

    k9, k6 = dict(octant_bounce_walks=True), dict(frustum_primary=True)
    # frame name -> (view, its config, camera, spp, the same view's K1 frame)
    demo, field = (mws, mcfg, mcam, 64), (fws, fcfg, fcam, 4)
    fwhole = (whole, fcfg, fcam, 4)
    forms = {
        "k1_demo_reference": (*demo, None),
        "k1_demo_threefry": (mws, mcfg.replace(rng="threefry"), mcam, 64, None),
        "k1_field_tiered": (*field, None),
        "k1_demo_wide": (mws, mcfg.replace(wide_nodes=True), mcam, 64, None),
        "k1_field_whole": (*fwhole, None),
        "k9_demo": (mws, mcfg.replace(**k9), mcam, 64, "k1_demo_reference"),
        "k9_field_tiered": (fws, fcfg.replace(**k9), fcam, 4, "k1_field_tiered"),
        "k9_demo_wide": (mws, mcfg.replace(wide_nodes=True, **k9), mcam, 64,
                         "k1_demo_wide"),
        "k9_field_whole": (whole, fcfg.replace(**k9), fcam, 4, "k1_field_whole"),
        "k6_demo": (mws, mcfg.replace(**k6), mcam, 64, "k1_demo_reference"),
        "k6_field_whole": (whole, fcfg.replace(**k6), fcam, 4, "k1_field_whole"),
        "k6_k9_demo": (mws, mcfg.replace(**k6, **k9), mcam, 64, "k1_demo_reference"),
        "k6_k9_field_whole": (whole, fcfg.replace(**k6, **k9), fcam, 4,
                              "k1_field_whole"),
    }

    if prefixes:
        keep = {f for f in forms if f.startswith(prefixes)}
        keep |= {forms[f][4] for f in keep if forms[f][4]}
        forms = {f: v for f, v in forms.items() if f in keep}

    def k1(ws, cfg, cam, spp, _k1=None):
        return lambda: megakernel.sample_wave(ws, cfg, uv, act, cam, 0, 0, 5, spp)

    def count_name(ws, cfg):
        c = megakernel._consts(cfg, 0, 0, 5, 1, ws.tiered)
        return ("rz_sample_wave" + ("_tiered" if ws.tiered else "")
                + ("_wide" if c.wide else "") + ("_frustum" if c.frustum else "")
                + ("_octant" if c.octant else "") + "_count")

    def differ(a, b):
        """(bit for bit, max abs, pixels that differ) of two (R, 3) frames."""
        d = (a - b).abs()
        return (bool(torch.equal(a, b)), d.max().item(),
                int((d.amax(-1) > 0).sum()))

    ref, report = {}, {}
    for name, csrc, defines in trees + counts:
        ext._lib = libs[name]
        rep = report[name] = dict(tree=os.path.dirname(os.path.dirname(csrc)),
                                  defines=list(defines),
                                  timed=any(t[0] == name for t in trees))
        rep["ptxas"] = {k: v for k, v in ext.ptxas_summary(logs[name]).items()
                        if k.startswith("regen_kernel")}
        if hasattr(libs[name], "rz_sample_budget"):
            # an older build knows policies 0-2 (the regenerating forms)
            n_pol = (len(megakernel.BUDGET_POLICIES)
                     if hasattr(libs[name], "rz_sample_wave_wide_count") else 3)
            rep["budget"] = {p: megakernel.sample_budget(p)
                             for p in megakernel.BUDGET_POLICIES[:n_pol]}
        bit = rep["bitwise"] = {}
        own = rep["vs_k1"] = {}
        frames = {}
        for fname, (ws, cfg, cam, spp, k1_of) in forms.items():
            c, r = k1(ws, cfg, cam, spp)()
            frames[fname] = (c, int(r))
            if fname not in ref:
                ref[fname] = (c, int(r))
            eq, mx, npx = differ(c, ref[fname][0])
            bit[fname] = dict(equal=eq, max_abs=mx, pixels_differ=npx, rays=int(r),
                              ref_rays=ref[fname][1])
            if k1_of:
                eq, mx, npx = differ(c, frames[k1_of][0])
                own[fname] = dict(equal=eq, max_abs=mx, pixels_differ=npx,
                                  rays=int(r), k1_rays=frames[k1_of][1])
        del frames
        lanes = rep["lanes"] = {}
        for fname, (ws, cfg, cam, spp, _k1) in forms.items():
            if fname == "k1_demo_threefry" or not hasattr(libs[name],
                                                          count_name(ws, cfg)):
                continue
            c, r, a, sl = megakernel.walk_lane_counts(ws, cfg, uv, act, cam, 0, 0,
                                                      5, spp)
            lanes[fname] = dict(active=a, slots=sl, utilisation=a / sl,
                                frame_equal=bool(torch.equal(c, k1(ws, cfg, cam, spp)()[0])))
        say(f"[build {name}] " + json.dumps({k: rep[k] for k in rep if k != "tree"}))
    del ref

    timed_names = [t[0] for t in trees]
    quantities = {f"{f}_ms": k1(*forms[f]) for f in forms if f != "k1_demo_threefry"}
    if not prefixes:
        quantities.update({
            "dispatch_demo_ms": lambda: render_radiance_with_stats(marrays, mcam, mcfg),
            "dispatch_field_ms": lambda: render_radiance_with_stats(farrays, fcam, fcfg),
        })
    times = {}
    for q, fn in quantities.items():
        got = {n: [] for n in timed_names}
        for n in timed_names:  # warm-up
            ext._lib = libs[n]
            fn()
        for order in (timed_names, timed_names[::-1]) * 3:
            for n in order:
                ext._lib = libs[n]
                got[n].append(timed(fn, torch)[1])
        times[q] = {n: dict(median=statistics.median(v), all=v) for n, v in got.items()}
        say(f"[turns {q}] " + "; ".join(
            f"{n} {statistics.median(v):.3f}" for n, v in got.items()))
    ext._lib = None
    result = dict(device=kind, smi=smi, builds=report, times=times,
                  seconds=time.perf_counter() - t0)
    line = json.dumps(result)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
