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

K4's phase 1 and K7 the same way, where --forms names them ("p1", "k7"):
  - p1: the four phase-1 forms (plain, K9, K6, K6 + K9) on the demo at
    1920x1080, one sample, split_bounce 2: colour, rays and the 13 state
    rows against the first build's (bit for bit, and the pixels that
    differ), the plain form's budget, each form's lane utilisation (where
    the build has the counting phase 1), each form alone and the split
    dispatch (demo 1080p/64 spp, split_bounce 2, octant rebin) timed;
  - k7: the K7 waves of one sample of the 1080p/64 spp kernels="pallas-ml"
    dispatch (5 closest, 2 shadow), recorded once at the wrappers; in each
    build that has the live-ray K7 (rz_misslink_budget) the kernel and the
    parent's one-thread-per-slot K7 over the records walk every wave (bit
    for bit against each other and the first such build), with both
    forms' budgets and lane utilisation, and both are timed (20 launches a
    call).

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
    nvcc log (ptxas report) of each build that succeeded. A build that
    fails is reported and left out, unless it is the first (the
    reference)."""
    procs = {}
    for name, csrc, defines in specs:
        out = _lib_path(name, csrc)
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--build", csrc, out,
             *defines], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    logs = {}
    for k, (name, proc) in enumerate(procs.items()):
        log_ = proc.communicate()[0]
        if proc.returncode:
            errors = [ln for ln in log_.splitlines()
                      if "error" in ln.lower() and "ptxas info" not in ln]
            msg = f"build {name} failed:\n" + "\n".join(errors[:40])
            if k == 0:
                raise RuntimeError(msg + f"\n{log_[-2000:]}")
            print(msg, flush=True)
            continue
        logs[name] = log_
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
    from rayzen_tpu_torch.ops import megakernel, walk
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
    trees = [t for t in trees if t[0] in logs]
    counts = [t for t in counts if t[0] in logs]
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

    # K4's phase 1: form name -> its config (demo 1080p, one sample)
    xcfg = mcfg.replace(split_bounce=2, split_rebin="octant")
    p1_forms = {"p1_plain": xcfg, "p1_k9": xcfg.replace(**k9),
                "p1_k6": xcfg.replace(**k6), "p1_k6_k9": xcfg.replace(**k6, **k9)}
    if prefixes:
        keep = {f for f in forms if f.startswith(prefixes)}
        keep |= {forms[f][4] for f in keep if forms[f][4]}
        forms = {f: v for f, v in forms.items() if f in keep}
        p1_forms = {f: v for f, v in p1_forms.items() if f.startswith(prefixes)}
    k7_on = not prefixes or any("k7".startswith(p) for p in prefixes)

    def p1(cfg):
        return lambda: megakernel.sample_wave_phase1(mws, cfg, uv, act, mcam, 0, 0, 5)

    # the K7 waves of one pallas-ml sample, recorded at the wrappers with this
    # tree's kernels (the first build that has the live-ray K7)
    waves = []
    new_k7 = [n for n, *_ in trees + counts if hasattr(libs[n], "rz_misslink_budget")]
    if k7_on and new_k7:
        ext._lib = libs[new_k7[0]]
        real_c, real_s = walk.closest_hit_misslink, walk.shadow_walk_misslink

        def rec_c(ws_, o, d, a, width=0, height=0):
            waves.append(("closest", (o.clone(), d.clone(), a.clone()), (width, height)))
            return real_c(ws_, o, d, a, width, height)

        def rec_s(ws_, o, d, md, a, min_visibility=0.05, t_eps=1e-3, width=0,
                  height=0):
            waves.append(("shadow", (o.clone(), d.clone(), md.contiguous().clone(),
                                     a.clone(), min_visibility, t_eps),
                          (width, height)))
            return real_s(ws_, o, d, md, a, min_visibility, t_eps, width, height)

        walk.closest_hit_misslink, walk.shadow_walk_misslink = rec_c, rec_s
        try:
            render_radiance_with_stats(marrays, mcam,
                                       mcfg.replace(kernels="pallas-ml", spp=1))
        finally:
            walk.closest_hit_misslink, walk.shadow_walk_misslink = real_c, real_s
        ext._lib = None
        names = [f"k7_closest{b}" for b in range(5)]
        names[1:1] = ["k7_shadow0", "k7_shadow1"]
        waves = [(nm, *w) for nm, w in zip(names, waves)]
        say(f"[k7] recorded {len(waves)} waves: " + ", ".join(
            f"{nm} {int(args[-1 if kind == 'closest' else 3].sum())} live"
            for nm, kind, args, _f in waves))

    def k7(kind, args, frame, rows=False, reps=1):
        """One K7 form's walk of a wave (``reps`` launches; the last's
        result)."""
        def run():
            for _ in range(reps):
                if kind == "closest":
                    out = (walk.closest_walk_misslink_rows(mws, *args) if rows else
                           walk.closest_walk_misslink(mws, *args, *frame))
                else:
                    out = ((walk.shadow_walk_misslink_rows(mws, *args),) if rows else
                           walk.shadow_walk_misslink(mws, *args, *frame)[:1])
            return out
        return run

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
                        if k.startswith(("regen_", "misslink_kernel",
                                         "sample_kernel<Bvh2Walk,tiles",
                                         "sample_kernel<Bvh2Walk>"))}
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
        for fname, pcfg in p1_forms.items():
            c, r, st = p1(pcfg)()
            if fname not in ref:
                ref[fname] = (c, int(r), st)
            eq, mx, npx = differ(c, ref[fname][0])
            bit[fname] = dict(equal=eq and torch.equal(st, ref[fname][2]), max_abs=mx,
                              pixels_differ=int(((c != ref[fname][0]).any(-1)
                                                 | (st != ref[fname][2]).any(0)).sum()),
                              rays=int(r), ref_rays=ref[fname][1])
        p1_count = hasattr(libs[name], "rz_sample_wave_phase1_count")
        if p1_forms and p1_count:
            rep["budget_phase1"] = megakernel.sample_budget("phase1")
        if name in new_k7:
            rep["budget_k7"] = {f: walk.misslink_budget(f) for f in walk.MISSLINK_FORMS}
            for wname, kind, args, frame in waves:
                kn, kr = k7(kind, args, frame)(), k7(kind, args, frame, rows=True)()
                if wname not in ref:
                    ref[wname] = kn
                same = all(torch.equal(a, b) and torch.equal(a, c)
                           for a, b, c in zip(kn, kr, ref[wname]))
                lanes_ = {}
                for form, rows_ in (("kernel", False), ("parent", True)):
                    cargs = dict(max_dist=args[2], min_visibility=args[4],
                                 t_eps=args[5]) if kind == "shadow" else {}
                    o, d, a = (args[0], args[1], args[3] if kind == "shadow" else args[2])
                    _out, la, ls = walk.misslink_lane_counts(
                        mws, o, d, a, width=frame[0], height=frame[1], rows=rows_,
                        **cargs)
                    lanes_[form] = la / ls if ls else None
                bit[wname] = dict(equal=same, lanes=lanes_)
        lanes = rep["lanes"] = {}
        for fname, (ws, cfg, cam, spp, _k1) in forms.items():
            if fname == "k1_demo_threefry" or not hasattr(libs[name],
                                                          count_name(ws, cfg)):
                continue
            c, r, a, sl = megakernel.walk_lane_counts(ws, cfg, uv, act, cam, 0, 0,
                                                      5, spp)
            lanes[fname] = dict(active=a, slots=sl, utilisation=a / sl,
                                frame_equal=bool(torch.equal(c, k1(ws, cfg, cam, spp)()[0])))
        for fname, pcfg in p1_forms.items() if p1_count else ():
            c, r, a, sl = megakernel.walk_lane_counts(mws, pcfg, uv, act, mcam, 0, 0,
                                                      5, phase1=True)
            lanes[fname] = dict(active=a, slots=sl, utilisation=a / sl,
                                frame_equal=bool(torch.equal(c, p1(pcfg)()[0])))
        say(f"[build {name}] " + json.dumps({k: rep[k] for k in rep if k != "tree"}))
    del ref

    timed_names = [t[0] for t in trees]
    quantities = {f"{f}_ms": k1(*forms[f]) for f in forms if f != "k1_demo_threefry"}
    if not prefixes:
        quantities.update({
            "dispatch_demo_ms": lambda: render_radiance_with_stats(marrays, mcam, mcfg),
            "dispatch_field_ms": lambda: render_radiance_with_stats(farrays, fcam, fcfg),
        })
    quantities.update({f"{f}_ms": p1(c) for f, c in p1_forms.items()})
    if p1_forms:
        quantities["dispatch_split_ms"] = lambda: render_radiance_with_stats(
            marrays, mcam, xcfg)
    # K7: 20 launches a call, so the time is per launch / 20
    reps = 20
    for wname, kind, args, frame in waves:
        quantities[f"{wname}_ms"] = k7(kind, args, frame, reps=reps)
        quantities[f"{wname}_rows_ms"] = k7(kind, args, frame, rows=True, reps=reps)
        # the kernel without the warp tiles: the wave's slots in order
        quantities[f"{wname}_linear_ms"] = k7(kind, args, (0, 0), reps=reps)
    per_call = {q: (reps if q.startswith("k7_") else 1) for q in quantities}
    times = {}
    for q, fn in quantities.items():
        names_q = [n for n in timed_names
                   if not q.startswith("k7_") or n in new_k7]
        got = {n: [] for n in names_q}
        for n in names_q:  # warm-up
            ext._lib = libs[n]
            fn()
        for order in (names_q, names_q[::-1]) * 3:
            for n in order:
                ext._lib = libs[n]
                got[n].append(timed(fn, torch)[1] / per_call[q])
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
