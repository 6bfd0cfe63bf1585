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

K4 and the standalone walks the same way, where --forms names them:
  - p1: the four phase-1 forms (plain, K9, K6, K6 + K9) on the demo at
    1920x1080, one sample, split_bounce 2: colour, rays and the 13 state
    rows against the first build's (bit for bit, and the pixels that
    differ), the plain form's budget, each form's lane utilisation (where
    the build has the counting phase 1), each form alone and the split
    dispatch (demo 1080p/64 spp, split_bounce 2, octant rebin) timed;
  - cont: K4's continuation (plain and K9 forms) on the rows phase 1 leaves
    at 1080p (split_bounce 2 and 1, octant rebin): the colour and rays it
    adds against the first build's (bit for bit), its budget and lane
    utilisation, the kernel alone and the split dispatch, timed;
  - k7, k2: the K7 waves of one sample of the 1080p/64 spp
    kernels="pallas-ml" dispatch and the K2/K3 waves of one sample of the
    "pallas-bvh2" dispatch (5 closest, 2 shadow each), recorded once at the
    wrappers; each build walks every wave (bit for bit against the first
    build), with the live-ray walks' budgets and lane utilisation, and each
    is timed (20 launches a call); K2/K3 also with the slots in wave order
    (no warp tiles: "_flat"); with k2 also the "pallas-bvh2" dispatch at
    1080p/4 spp;
  - k8: the tiered walk's harness launch (K8) on the field's 1080p primary
    rays and on the shadow rays from their hits toward its point light:
    each build against the first (bit for bit) and the first against the
    plain version, the K8 budgets and lane utilisation (where the build has
    the counting K8), each wave timed (20 launches a call), and the field
    dispatch through the tiered view and over the whole tree
    (tiered="off").

A tree whose kernels take other arguments than this tree's (an earlier
PR's) is timed with --own instead: each such build runs in a process of
its own on its tree's package and kernels, and only through the entry
points every tree has, timed in turns across the processes: with "cont",
each continuation form's whole split sample (megakernel.sample_wave_split:
phase 1, the compaction, any torch gathers, the continuation) and its
phase 1 alone, and the split dispatch, plus one split dispatch per build
under torch.profiler (the continuation's and phase 1's device time, the
torch gathers and the compaction's scans); with "k2", the K2/K3 waves of
one "pallas-bvh2" sample replayed through the wrappers as the per-wave
loop calls them, and the "pallas-bvh2" dispatch; with "k6", the
standalone K6 (the frustum walk of kernels="pallas-nomega") at the demo's
1080p primary rays and point-light shadow rays, each through its tree's
wrapper (with the frame where the wrapper takes it, so in K1's warp
tiles), held to its tree's plain version with the same packets (bit for
bit), with its lanes and budget where the tree has them, and the
"pallas-nomega" dispatch at 1080p/4 spp. The results of the builds are
held to each other by digest (bit for bit).

Run from the root of a checkout, on a machine with a CUDA device and nvcc:

    python scripts/k1_schedule.py [--tree NAME=DIR[:DEFINE,...]]...
                                  [--own NAME=DIR[:DEFINE,...]]...
                                  [--sweep [POINT,...]] [--count NAME=DIR]...
                                  [--forms PREFIX,...] [--out FILE]

--tree: a build to time in this process, from DIR/rayzen_tpu_torch/csrc
("." is this tree) with nvcc -D DEFINEs, driven through this tree's
package; the first is the reference of the bitwise checks (by default
".", alone, unless --own is given). --own: a build timed through its own
tree's package (above). --sweep adds this tree at each register budget of
SWEEP, or at the named points of it. --count: a build used only for its
K1 frames and lane counts (a copy of an older K1 with the counter added).
--forms: only the frames whose names start with a PREFIX (and the K1
frames they are held to), and no dispatches but the split's and
"pallas-bvh2"'s. Defines for the continuation and the live-ray walks:
RZ_CONT_THREADS, RZ_CONT_MIN_BLOCKS, RZ_LIVE_THREADS, RZ_LIVE_MIN_BLOCKS.
Prints one JSON object as its last line, and writes it to --out.
"""

from __future__ import annotations

import contextlib
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


def _digest(x, h=None):
    """A hash of every tensor in x (tensors, tuples, lists, objects'
    fields), to hold two trees' results bit for bit across processes."""
    import hashlib

    import torch

    top = h is None
    h = h or hashlib.sha1()
    if isinstance(x, torch.Tensor):
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    elif isinstance(x, (tuple, list)):
        for v in x:
            _digest(v, h)
    elif hasattr(x, "__dict__"):
        for v in vars(x).values():
            _digest(v, h)
    return h.hexdigest() if top else h


def own_worker(name: str, tree: str, prefixes: tuple, defines: tuple) -> int:
    """The --own build ``name``: ``tree``'s package and kernels (with
    ``defines``), driven through the entry points every tree has. Speaks
    one JSON line per request on the stdout it was started with: first its
    quantities and the digests of its results; then, per request, {"run":
    q} -> the ms of one timed call of q, {"profile": 1} -> one split
    dispatch under torch.profiler, {"quit": 1}."""
    import torch

    from chip_smoke import profile_dispatch, timed  # this tree's helpers

    proto = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)  # the package's prints go to stderr
    sys.path.insert(0, os.path.abspath(tree))
    from rayzen_tpu_torch import ext
    from rayzen_tpu_torch.config import RenderConfig
    from rayzen_tpu_torch.demo import build_demo_scene
    from rayzen_tpu_torch.integrator import render_radiance_with_stats
    from rayzen_tpu_torch.ops import megakernel, walk
    from rayzen_tpu_torch.ops.camera_rays import pixel_grid
    from rayzen_tpu_torch.packing import pack_scene, world_geometry

    if os.path.dirname(os.path.dirname(ext.__file__)) != os.path.abspath(tree):
        raise RuntimeError(f"{name}: imported {ext.__file__}, not {tree}'s package")
    csrc = os.path.join(os.path.abspath(tree), "rayzen_tpu_torch", "csrc")
    out = _lib_path(f"own-{name}", csrc)
    ext.build(force=True, csrc=csrc, out=out, defines=defines)
    ext._lib = ext.bind(out)
    if ext._lib.rz_sample_params_size() != ext.ctypes.sizeof(ext.SampleParams):
        raise RuntimeError(f"{name}: SampleParams layout differs")

    dev = torch.device("cuda", 0)
    mcfg = RenderConfig(width=1920, height=1080, spp=64, max_bounces=5)
    mscene = build_demo_scene(1920, 1080)
    marrays = pack_scene(mscene, mcfg, dev)
    mws, mcam = world_geometry(marrays), mscene.camera.device_params()
    _, uv = pixel_grid(1920, 1080, dev)
    act = torch.ones(uv.shape[0], dtype=torch.bool, device=dev)
    xcfg = mcfg.replace(split_bounce=2, split_rebin="octant")
    k9 = dict(octant_bounce_walks=True)

    def on(prefix):
        return not prefixes or prefix.startswith(prefixes)

    # quantity -> (its call, launches a call); digests: the results
    calls, digests = {}, {}
    for form, cfg in (("plain", xcfg), ("k9", xcfg.replace(**k9)),
                      ("plain_b1", xcfg.replace(split_bounce=1)),
                      ("k9_b1", xcfg.replace(split_bounce=1, **k9))):
        if not on("cont"):
            break
        split = (lambda c: lambda: megakernel.sample_wave_split(
            mws, c, uv, act, mcam, 0, 0, 5))(cfg)
        calls[f"split_{form}_ms"] = (split, 1)
        calls[f"phase1_{form}_ms"] = ((lambda c: lambda: megakernel.sample_wave_phase1(
            mws, c, uv, act, mcam, 0, 0, 5))(cfg), 1)
        digests[f"split_{form}"] = _digest(split())
    if on("cont"):
        calls["dispatch_split_ms"] = (lambda: render_radiance_with_stats(
            marrays, mcam, xcfg), 1)
    if on("k2"):
        # the K2/K3 waves of one 1080p "pallas-bvh2" sample, recorded at
        # the wrappers as the per-wave loop calls them, replayed 20 a call
        got, real = [], (walk.closest_hit_bvh2, walk.shadow_walk_bvh2)

        def recorder(kind, fn):
            def rec(*args, **kw):
                got.append((kind, fn, tuple(a.clone() if isinstance(a, torch.Tensor)
                                            else a for a in args), kw))
                return fn(*args, **kw)
            return rec

        walk.closest_hit_bvh2 = recorder("closest", real[0])
        walk.shadow_walk_bvh2 = recorder("shadow", real[1])
        try:
            render_radiance_with_stats(marrays, mcam,
                                       mcfg.replace(kernels="pallas-bvh2", spp=1))
        finally:
            walk.closest_hit_bvh2, walk.shadow_walk_bvh2 = real
        names = [f"k2_closest{b}" for b in range(5)]
        names[1:1] = ["k2_shadow0", "k2_shadow1"]
        if len(got) != len(names):
            raise RuntimeError(f"{name}: {len(got)} K2/K3 waves, not {len(names)}")
        for wname, (_kind, fn, args, kw) in zip(names, got):
            def replay(fn=fn, args=args, kw=kw):
                for _ in range(20):
                    out_ = fn(*args, **kw)
                return out_
            calls[f"{wname}_ms"] = (replay, 20)
            digests[wname] = _digest(fn(*args, **kw))
            digests[f"{wname}_input"] = _digest(
                [a for a in args if isinstance(a, torch.Tensor)])
        calls["dispatch_bvh2_ms"] = (lambda: render_radiance_with_stats(
            marrays, mcam, mcfg.replace(kernels="pallas-bvh2", spp=4)), 1)
    info = {}
    if on("k6"):
        info = k6_waves(torch, walk, megakernel, mws, mcam, uv, act, calls,
                        digests)
        calls["dispatch_nomega_ms"] = (lambda: render_radiance_with_stats(
            marrays, mcam, mcfg.replace(kernels="pallas-nomega", spp=4)), 1)

    def say(msg):
        proto.write(json.dumps(msg) + "\n")
        proto.flush()

    say(dict(quantities=list(calls), digests=digests, package=ext.__file__,
             info=info))
    while True:
        line = sys.stdin.readline()
        if not line:
            break
        req = json.loads(line)
        if "run" in req:
            fn, per_call = calls[req["run"]]
            say(dict(ms=timed(fn, torch)[1] / per_call))
        elif "profile" in req:
            wall, busy, top = profile_dispatch(
                lambda: render_radiance_with_stats(marrays, mcam, xcfg), torch, None)
            # kernel classes: the continuation, phase 1, the torch gathers
            # and scatters (indexing kernels) and the compaction's scans
            classes = {"continuation": ("continuation",), "phase1": ("phase1",),
                       "gathers": ("index_elementwise", "gather"),
                       "scans": ("scan", "cumsum")}
            rows = {c: [(ms, n) for ms, k, n in top if any(w in k.lower() for w in keys)]
                    for c, keys in classes.items()}
            say(dict(wall_ms=wall, device_busy_ms=busy,
                     **{f"{c}_ms": sum(ms for ms, _ in v) for c, v in rows.items()},
                     **{f"{c}_launches": sum(n for _, n in v) for c, v in rows.items()},
                     top={k[:60]: [ms, n] for ms, k, n in top[:12]}))
        else:
            say({})
            break
    return 0


def wave_rays(torch, walk, megakernel, ws, cam, uv, act, hit_fn):
    """A frame's primary rays (K1's ray generation, no jitter), and the
    shadow rays from the closest hits (``hit_fn``) toward the scene's
    light 0, a point light: (origin, direction, active), (origin,
    direction, max_dist, active)."""
    z = torch.zeros_like(uv[:, 0])
    ray = megakernel._raygen_tiles(uv[:, 0], uv[:, 1], z, z,
                                   megakernel._pack_camera(cam, uv.device))
    o, d = torch.stack(ray[:3], 1), torch.stack(ray[3:], 1)
    hit = hit_fn(ws, o, d, act)
    g = ws.lights[0]
    if float(g[3]) != 1.0:
        raise RuntimeError("light 0 is not a point light")
    lv = g[:3] - hit.point
    dist = torch.clamp_min(lv.norm(dim=1), 0.001)
    ld = (lv / dist[:, None]).contiguous()
    return (o, d, act), (hit.point + ld * 0.001, ld, dist, hit.found)


def k6_waves(torch, walk, megakernel, ws, cam, uv, act, calls, digests) -> dict:
    """The standalone K6 of the tree in use at the demo's 1080p primary and
    point-light waves, through the tree's wrappers: adds their timed calls
    (20 launches each) and digests; returns whether each equals the tree's
    plain version (same packets), its lane utilisation and budgets where
    the tree has them."""
    import inspect

    framed = "width" in inspect.signature(walk.closest_walk_frustum).parameters
    frame = (1920, 1080) if framed else ()
    pframe = dict(width=1920, height=1080) if framed else {}
    prim, shad = wave_rays(torch, walk, megakernel, ws, cam, uv, act,
                            walk.closest_hit_bvh2)
    runs = {"k6_closest": lambda: walk.closest_walk_frustum(ws, *prim, *frame),
            "k6_shadow": lambda: walk.shadow_walk_frustum(
                ws, *shad, 0.05, 1e-3, *frame)[0]}
    plain = {"k6_closest": lambda: walk.frustum_closest_walk_reference(
        ws, *prim, **pframe), "k6_shadow": lambda: walk.frustum_shadow_walk_reference(
            ws, *shad, **pframe)}
    info = dict(packets="warp tiles" if framed else "32 consecutive rays")
    for wname, run in runs.items():
        out = run()
        digests[wname] = _digest(out)
        ref = plain[wname]()
        info[f"{wname}_equals_plain"] = bool(
            torch.equal(out, ref) if isinstance(out, torch.Tensor)
            else all(torch.equal(a, b) for a, b in zip(out, ref)))

        def replay(run=run):
            for _ in range(20):
                out_ = run()
            return out_
        calls[f"{wname}_ms"] = (replay, 20)
    if "closest_frustum" in walk.LIVE_FORMS:
        for wname, args, kw in (("k6_closest", prim, {}),
                                ("k6_shadow", (*shad[:2], shad[3]),
                                 dict(max_dist=shad[2]))):
            _o, a_, sl_ = walk.live_lane_counts(ws, *args, kind="frustum",
                                                **kw, **pframe)
            info[f"{wname}_lanes"] = a_ / sl_
        info["budget"] = {f: walk.live_budget(f)
                          for f in ("closest_frustum", "shadow_frustum")}
    return info


def own_turns(owns, prefixes, say) -> dict:
    """Time the --own builds in turns: each runs in its own process on its
    own tree's package (own_worker); every quantity all of them have is
    timed (a b c, c b a) x 3, one call each, with CUDA events, after a
    warm-up call each; then one profiled split dispatch each. Returns
    {builds: their quantities and digests, equal: which results agree
    across the builds, times, profiles}."""
    procs = {
        name: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--own-worker", name, tree,
             ",".join(prefixes or ()), *defines],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for name, tree, defines in owns}

    def read(n):
        line = procs[n].stdout.readline()
        if not line:
            raise RuntimeError(f"own build {n} ended (exit {procs[n].wait()})")
        return json.loads(line)

    def ask(n, req):
        procs[n].stdin.write(json.dumps(req) + "\n")
        procs[n].stdin.flush()
        return read(n)

    try:
        hello = {n: read(n) for n in procs}
        names = list(procs)
        say("[own] " + "; ".join(f"{n}: {hello[n]['package']}" for n in names))
        first = hello[names[0]]["digests"]
        equal = {k: all(hello[n]["digests"].get(k) == v for n in names)
                 for k, v in first.items()}
        qs = [q for q in hello[names[0]]["quantities"]
              if all(q in hello[n]["quantities"] for n in names)]
        times = {}
        for q in qs:
            for n in names:  # warm-up
                ask(n, {"run": q})
            got = {n: [] for n in names}
            for order in (names, names[::-1]) * 3:
                for n in order:
                    got[n].append(ask(n, {"run": q})["ms"])
            times[q] = {n: dict(median=statistics.median(v), all=v)
                        for n, v in got.items()}
            say(f"[own turns {q}] " + "; ".join(
                f"{n} {statistics.median(v):.4f}" for n, v in got.items()))
        profiles = {}
        if "dispatch_split_ms" in qs:
            for n in names:
                profiles[n] = ask(n, {"profile": 1})
                say(f"[own profile {n}] " + json.dumps(
                    {k: v for k, v in profiles[n].items() if k != "top"}))
        for n in names:
            ask(n, {"quit": 1})
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    return dict(builds=hello, equal=equal, times=times, profiles=profiles)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--build"]:  # one build, in its own process
        from rayzen_tpu_torch import ext

        ext.build(force=True, csrc=args[1], out=args[2], defines=tuple(args[3:]))
        print(ext.build_log)
        return 0
    if args[:1] == ["--own-worker"]:  # one --own build, in its own process
        return own_worker(args[1], args[2], tuple(p for p in args[3].split(",") if p),
                          tuple(args[4:]))

    import torch

    if not torch.cuda.is_available():
        print("k1_schedule: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import nvidia_smi_line

    trees, counts, owns, out_path, prefixes = [], [], [], None, None
    i = 0
    while i < len(args):
        if args[i] == "--tree":
            trees.append(_spec(args[i + 1]))
            i += 2
        elif args[i] == "--own":
            name, tree, defines = _spec(args[i + 1])
            owns.append((name, os.path.dirname(os.path.dirname(tree)), defines))
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
    if not (trees or owns):
        trees = [_spec(".=.")]
    t0 = time.perf_counter()

    def say(msg):
        print(f"{msg} [{time.perf_counter() - t0:.0f} s]", flush=True)

    kind, smi = torch.cuda.get_device_name(0), nvidia_smi_line()
    say(f"[device] {kind} | {smi}")
    result = dict(device=kind, smi=smi)
    if owns:
        result["own"] = own_turns(owns, prefixes, say)
    if trees:
        result.update(in_turns(trees, counts, prefixes, say))
    result["seconds"] = time.perf_counter() - t0
    line = json.dumps(result)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


def in_turns(trees, counts, prefixes, say) -> dict:
    """The --tree builds (and the --count builds), loaded side by side in
    this process and driven through this tree's package: their frames,
    budgets and lane counts, and every quantity timed in turns. Returns
    {builds, times}."""
    import torch

    from chip_smoke import build_field_scene, timed
    from rayzen_tpu_torch import ext
    from rayzen_tpu_torch.config import RenderConfig
    from rayzen_tpu_torch.demo import build_demo_scene
    from rayzen_tpu_torch.integrator import render_radiance_with_stats
    from rayzen_tpu_torch.ops import megakernel, walk
    from rayzen_tpu_torch.ops.camera_rays import pixel_grid
    from rayzen_tpu_torch.packing import pack_scene, world_geometry

    logs = build_all(trees + counts)
    trees = [t for t in trees if t[0] in logs]
    counts = [t for t in counts if t[0] in logs]
    say(f"[build] {len(logs)} builds")
    libs = {}
    for name, csrc, _defs in trees + counts:
        L = ext.bind(_lib_path(name, csrc))
        if L.rz_sample_params_size() != ext.ctypes.sizeof(ext.SampleParams):
            raise RuntimeError(f"{name}: SampleParams layout differs")
        if any(t[0] == name for t in trees) and not all(
                hasattr(L, e) for e in ("rz_live_walk_budget", "rz_continuation_budget")):
            raise SystemExit(f"{name}: its kernels take other arguments than this "
                             "tree's; time it through its own package (--own)")
        libs[name] = L

    def has(name, entry):
        return hasattr(libs[name], entry)

    dev = torch.device("cuda", 0)
    mcfg = RenderConfig(width=1920, height=1080, spp=64, max_bounces=5)
    mscene = build_demo_scene(1920, 1080)
    marrays = pack_scene(mscene, mcfg, dev)
    mws, mcam = world_geometry(marrays), mscene.camera.device_params()
    _, uv = pixel_grid(1920, 1080, dev)
    act = torch.ones(uv.shape[0], dtype=torch.bool, device=dev)

    k9, k6 = dict(octant_bounce_walks=True), dict(frustum_primary=True)
    demo = (mws, mcfg, mcam, 64)
    # frame name -> (view, its config, camera, spp, the same view's K1 frame)
    forms = {
        "k1_demo_reference": (*demo, None),
        "k1_demo_threefry": (mws, mcfg.replace(rng="threefry"), mcam, 64, None),
        "k1_demo_wide": (mws, mcfg.replace(wide_nodes=True), mcam, 64, None),
        "k9_demo": (mws, mcfg.replace(**k9), mcam, 64, "k1_demo_reference"),
        "k9_demo_wide": (mws, mcfg.replace(wide_nodes=True, **k9), mcam, 64,
                         "k1_demo_wide"),
        "k6_demo": (mws, mcfg.replace(**k6), mcam, 64, "k1_demo_reference"),
        "k6_k9_demo": (mws, mcfg.replace(**k6, **k9), mcam, 64, "k1_demo_reference"),
    }
    field_forms = ("k1_field_tiered", "k1_field_whole", "k9_field_tiered",
                   "k9_field_whole", "k6_field_whole", "k6_k9_field_whole", "k8")
    need_field = not prefixes or any(f.startswith(prefixes) for f in field_forms)
    if need_field:
        fcfg = RenderConfig(width=1920, height=1080, spp=4, max_bounces=5)
        fscene = build_field_scene(1920, 1080)
        farrays = pack_scene(fscene, fcfg, dev)
        fws, fcam = world_geometry(farrays), fscene.camera.device_params()
        if not fws.tiered:
            raise RuntimeError("the field did not pack tiered")
        warrays = pack_scene(fscene, fcfg.replace(tiered="off"), dev)
        whole = world_geometry(warrays)
        field, fwhole = (fws, fcfg, fcam, 4), (whole, fcfg, fcam, 4)
        forms.update({
            "k1_field_tiered": (*field, None),
            "k1_field_whole": (*fwhole, None),
            "k9_field_tiered": (fws, fcfg.replace(**k9), fcam, 4, "k1_field_tiered"),
            "k9_field_whole": (whole, fcfg.replace(**k9), fcam, 4, "k1_field_whole"),
            "k6_field_whole": (whole, fcfg.replace(**k6), fcam, 4, "k1_field_whole"),
            "k6_k9_field_whole": (whole, fcfg.replace(**k6, **k9), fcam, 4,
                                  "k1_field_whole"),
        })
    say("[scenes] demo" + (" and field" if need_field else "") + " packed")

    # K4's phase 1: form name -> its config (demo 1080p, one sample)
    xcfg = mcfg.replace(split_bounce=2, split_rebin="octant")
    p1_forms = {"p1_plain": xcfg, "p1_k9": xcfg.replace(**k9),
                "p1_k6": xcfg.replace(**k6), "p1_k6_k9": xcfg.replace(**k6, **k9)}
    # K4's continuation: form name -> its config, on phase 1's rows
    cont_forms = {"cont_plain": xcfg, "cont_k9": xcfg.replace(**k9),
                  "cont_plain_b1": xcfg.replace(split_bounce=1),
                  "cont_k9_b1": xcfg.replace(split_bounce=1, **k9)}
    if prefixes:
        keep = {f for f in forms if f.startswith(prefixes)}
        keep |= {forms[f][4] for f in keep if forms[f][4]}
        forms = {f: v for f, v in forms.items() if f in keep}
        p1_forms = {f: v for f, v in p1_forms.items() if f.startswith(prefixes)}
        cont_forms = {f: v for f, v in cont_forms.items() if f.startswith(prefixes)}
    on = {w: not prefixes or any(w.startswith(p) for p in prefixes)
          for w in ("k7", "k2", "k8")}

    def p1(cfg):
        return lambda: megakernel.sample_wave_phase1(mws, cfg, uv, act, mcam, 0, 0, 5)

    @contextlib.contextmanager
    def using(name):
        """Launch through build ``name``."""
        ext._lib = libs[name]
        yield

    # the per-wave walks of one sample of a 1080p dispatch, recorded at the
    # wrappers with the first build: K7's (kernels="pallas-ml") and K2/K3's
    # ("pallas-bvh2")
    waves = []
    for w_kind, kernels_, c_name, s_name in (
            ("k7", "pallas-ml", "closest_hit_misslink", "shadow_walk_misslink"),
            ("k2", "pallas-bvh2", "closest_hit_bvh2", "shadow_walk_bvh2")):
        if not on[w_kind]:
            continue
        got = []
        real_c, real_s = getattr(walk, c_name), getattr(walk, s_name)

        def rec_c(ws_, o, d, a, *rest, width=0, height=0):
            got.append(("closest", (o.clone(), d.clone(), a.clone()), (width, height)))
            return real_c(ws_, o, d, a, *rest, width=width, height=height)

        def rec_s(ws_, o, d, md, a, min_visibility=0.05, t_eps=1e-3, width=0,
                  height=0):
            got.append(("shadow", (o.clone(), d.clone(), md.contiguous().clone(),
                                   a.clone(), min_visibility, t_eps), (width, height)))
            return real_s(ws_, o, d, md, a, min_visibility, t_eps, width=width,
                          height=height)

        setattr(walk, c_name, rec_c)
        setattr(walk, s_name, rec_s)
        try:
            with using(trees[0][0]):
                render_radiance_with_stats(marrays, mcam,
                                           mcfg.replace(kernels=kernels_, spp=1))
        finally:
            setattr(walk, c_name, real_c)
            setattr(walk, s_name, real_s)
        names = [f"{w_kind}_closest{b}" for b in range(5)]
        names[1:1] = [f"{w_kind}_shadow0", f"{w_kind}_shadow1"]
        waves += [(nm, w_kind, *w) for nm, w in zip(names, got)]
    ext._lib = None
    if waves:
        say("[waves] recorded " + ", ".join(
            f"{nm} {int(args[2 if kind == 'closest' else 3].sum())} live"
            for nm, _wk, kind, args, _f in waves))

    def wave_walk(w_kind, kind, args, frame, reps=1):
        """The walk of a recorded wave through the build in use (``reps``
        launches; the last's result)."""
        def run():
            for _ in range(reps):
                if w_kind == "k7" and kind == "closest":
                    out = walk.closest_walk_misslink(mws, *args, *frame)
                elif w_kind == "k7":
                    out = walk.shadow_walk_misslink(mws, *args, *frame)[:1]
                elif kind == "closest":
                    out = walk.closest_walk(mws, *args, None, *frame)
                else:
                    out = walk.shadow_walk_bvh2(mws, *args, width=frame[0],
                                                height=frame[1])[:1]
            return out
        return run

    # K8's harness waves on the field (the tiered view), made with the first
    # build, and the plain version's results of them
    k8_waves, k8_plain = {}, {}
    if on["k8"]:
        with using(trees[0][0]):
            prim, shad = wave_rays(torch, walk, megakernel, fws, fcam, uv, act,
                                   walk.closest_hit_tiered)
        k8_waves = {"k8_closest": ("closest", prim), "k8_shadow": ("shadow", shad)}
        k8_plain = {"k8_closest": walk.tiered_closest_walk_reference(fws, *prim),
                    "k8_shadow": walk.tiered_shadow_walk_reference(fws, *shad)}
        say("[k8] field 1080p waves: " + ", ".join(
            f"{k} {int(v[1][-1].sum())} live" for k, v in k8_waves.items()))

    def k8_walk(kind, args, reps=1):
        """K8 on a recorded wave through the build in use (``reps``
        launches; the last's result)."""
        def run():
            for _ in range(reps):
                out = (walk.closest_walk_tiered(fws, *args) if kind == "closest"
                       else walk.shadow_walk_tiered(fws, *args)[0])
            return out
        return run

    def same(a, b):
        return (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else all(torch.equal(x, y) for x, y in zip(a, b)))

    # K4's continuation on phase 1's 1080p rows (one phase 1 a split point,
    # with this tree's kernels): each build's colour and rays added in
    cont_inputs = {}
    if cont_forms:
        with using(trees[0][0]):
            for sb in sorted({c.split_bounce for c in cont_forms.values()}):
                c1, r1, st = p1(xcfg.replace(split_bounce=sb))()
                dest, order, live = megakernel._compaction_permutation(
                    st[10] > 0.5, st[3], st[4], st[5], "octant",
                    origins=(st[0], st[1], st[2]))
                cont_inputs[sb] = (c1, r1, st, order, live)
        say("[cont] phase-1 rows: " + ", ".join(
            f"split_bounce {sb} {int(v[4])} live" for sb, v in cont_inputs.items()))

    def cont_run(cfg, scratch=None):
        """The continuation of form cfg on its phase-1 rows through the
        build in use: (colour, rays). ``scratch``: the (colour, rays) to add
        into (the timed calls)."""
        c1, r1, st, order, live = cont_inputs[cfg.split_bounce]

        def run():
            col, rays = scratch or (c1.clone(), r1.clone())
            megakernel.continuation(mws, cfg, st, order, live, col, rays, 0, 0, 5,
                                    cfg.split_bounce, 5, False)
            return col, rays
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
                        if k.startswith(("regen_", "live_walk_kernel",
                                         "continuation_kernel",
                                         "sample_kernel<Bvh2Walk"))}
        if has(name, "rz_sample_budget"):
            # an older build knows policies 0-2 (the regenerating forms)
            n_pol = (len(megakernel.BUDGET_POLICIES)
                     if has(name, "rz_sample_wave_wide_count") else 3)
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
        p1_count = has(name, "rz_sample_wave_phase1_count")
        if p1_forms and p1_count:
            rep["budget_phase1"] = megakernel.sample_budget("phase1")
        # an older K1 of --count may take other arguments in K4 and the walks
        timed_ = rep["timed"]
        with using(name):
            for fname, ccfg in cont_forms.items() if cont_inputs and timed_ else ():
                c, r = cont_run(ccfg)()
                if fname not in ref:
                    ref[fname] = (c, int(r))
                eq, mx, npx = differ(c, ref[fname][0])
                bit[fname] = dict(equal=eq and int(r) == ref[fname][1], max_abs=mx,
                                  pixels_differ=npx, rays=int(r), ref_rays=ref[fname][1])
        if cont_forms and cont_inputs and has(name, "rz_continuation_budget"):
            rep["budget_continuation"] = {f: megakernel.sample_budget(f)
                                          for f in megakernel.CONTINUATION_FORMS}
        if has(name, "rz_live_walk_budget"):
            # an older build knows forms 0-3 (K7, K2/K3)
            n_live = (len(walk.LIVE_FORMS) if has(name, "rz_closest_tiered_count")
                      else 4)
            rep["budget_live_walks"] = {f: walk.live_budget(f)
                                        for f in walk.LIVE_FORMS[:n_live]}
        for wname, (kind, args) in k8_waves.items() if timed_ else ():
            out = k8_walk(kind, args)()
            if wname not in ref:
                ref[wname] = out
            bit[wname] = dict(equal=same(out, ref[wname]),
                              equals_plain=same(out, k8_plain[wname]))
            if has(name, "rz_closest_tiered_count"):
                cargs = (dict(max_dist=args[2]) if kind == "shadow" else {})
                o, d, a = args[0], args[1], args[-1]
                _out, la, ls = walk.live_lane_counts(fws, o, d, a, kind="tiered",
                                                     **cargs)
                bit[wname]["lanes"] = la / ls if ls else None
        for wname, w_kind, kind, args, frame in waves if timed_ else ():
            out = wave_walk(w_kind, kind, args, frame)()
            if wname not in ref:
                ref[wname] = out
            bit[wname] = dict(equal=all(torch.equal(a, b)
                                        for a, b in zip(out, ref[wname])))
            if w_kind == "k2":  # the same walks with the slots in wave order
                bit[wname]["flat_equal"] = all(torch.equal(a, b) for a, b in zip(
                    wave_walk(w_kind, kind, args, (0, 0))(), out))
            cargs = (dict(max_dist=args[2], min_visibility=args[4], t_eps=args[5])
                     if kind == "shadow" else {})
            o, d, a = args[0], args[1], args[3] if kind == "shadow" else args[2]
            _out, la, ls = walk.live_lane_counts(
                mws, o, d, a, kind="misslink" if w_kind == "k7" else "bvh2",
                width=frame[0], height=frame[1], **cargs)
            bit[wname]["lanes"] = la / ls if ls else None
        lanes = rep["lanes"] = {}
        for fname, (ws, cfg, cam, spp, _k1) in forms.items():
            if fname == "k1_demo_threefry" or not has(name, count_name(ws, cfg)):
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
        for fname, ccfg in cont_forms.items() if cont_inputs and timed_ else ():
            c1, r1, st, order, live = cont_inputs[ccfg.split_bounce]
            col, rays = c1.clone(), r1.clone()
            a, sl = megakernel.continuation_lane_counts(
                mws, ccfg, st, order, live, col, rays, 0, 0, 5, ccfg.split_bounce, 5,
                False)
            lanes[fname] = dict(active=a, slots=sl, utilisation=a / sl,
                                frame_equal=bool(torch.equal(col, cont_run(ccfg)()[0])))
        say(f"[build {name}] " + json.dumps({k: rep[k] for k in rep if k != "tree"}))
    del ref
    ext._lib = None

    timed_names = [t[0] for t in trees]
    reps = 20  # launches a call for the continuation and the walks

    def repeated(fn):
        def run():
            for _ in range(reps):
                out = fn()
            return out
        return run

    # quantity -> (a factory of its call, made through the build in use;
    # launches a call)
    quantities = {f"{f}_ms": ((lambda f_: lambda _n: k1(*forms[f_]))(f), 1)
                  for f in forms if f != "k1_demo_threefry"}
    if not prefixes:
        quantities["dispatch_demo_ms"] = (lambda _n: lambda: render_radiance_with_stats(
            marrays, mcam, mcfg), 1)
        quantities["dispatch_field_ms"] = (lambda _n: lambda: render_radiance_with_stats(
            farrays, fcam, fcfg), 1)
    quantities.update({f"{f}_ms": ((lambda c_: lambda _n: p1(c_))(c), 1)
                       for f, c in p1_forms.items()})
    for f, c in cont_forms.items() if cont_inputs else ():
        scratch = (cont_inputs[c.split_bounce][0].clone(),
                   cont_inputs[c.split_bounce][1].clone())
        quantities[f"{f}_ms"] = ((lambda c_, s_: lambda _n: repeated(
            cont_run(c_, s_)))(c, scratch), reps)
    if p1_forms or cont_forms:
        quantities["dispatch_split_ms"] = (lambda _n: lambda: render_radiance_with_stats(
            marrays, mcam, xcfg), 1)
    for wname, w_kind, kind, args, frame in waves:
        quantities[f"{wname}_ms"] = ((lambda *a_: lambda _n: wave_walk(
            *a_, reps=reps))(w_kind, kind, args, frame), reps)
        if w_kind == "k2":  # K2/K3 with the slots in wave order, not tiles
            quantities[f"{wname}_flat_ms"] = ((lambda *a_: lambda _n: wave_walk(
                *a_, reps=reps))(w_kind, kind, args, (0, 0)), reps)
    for wname, (kind, args) in k8_waves.items():
        quantities[f"{wname}_ms"] = ((lambda *a_: lambda _n: k8_walk(
            *a_, reps=reps))(kind, args), reps)
    if on["k8"]:  # the field dispatch, tiered and over the whole tree
        quantities["dispatch_field_ms"] = (lambda _n: lambda: render_radiance_with_stats(
            farrays, fcam, fcfg), 1)
        quantities["dispatch_field_whole_ms"] = (
            lambda _n: lambda: render_radiance_with_stats(
                warrays, fcam, fcfg.replace(tiered="off")), 1)
    if on["k2"]:  # K2/K3's path: the kernels="pallas-bvh2" dispatch, 4 spp
        quantities["dispatch_bvh2_ms"] = (lambda _n: lambda: render_radiance_with_stats(
            marrays, mcam, mcfg.replace(kernels="pallas-bvh2", spp=4)), 1)
    times = {}
    for q, (make, per_call) in quantities.items():
        got = {n: [] for n in timed_names}
        for n in timed_names:  # warm-up
            with using(n):
                make(n)()
        for order in (timed_names, timed_names[::-1]) * 3:
            for n in order:
                with using(n):
                    got[n].append(timed(make(n), torch)[1] / per_call)
        times[q] = {n: dict(median=statistics.median(v), all=v) for n, v in got.items()}
        say(f"[turns {q}] " + "; ".join(
            f"{n} {statistics.median(v):.4f}" for n, v in got.items()))
    ext._lib = None
    return dict(builds=report, times=times)


if __name__ == "__main__":
    sys.exit(main())
