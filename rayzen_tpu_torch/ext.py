"""Build and bind the port's CUDA kernels (csrc/).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one process
per source, all started together, and linked into one shared library with a
plain C interface, loaded through ctypes; pointers go in as
``tensor.data_ptr()`` and the stream as ``torch.cuda.current_stream()``.
The build runs at first use, under a file lock, into ``csrc/build/`` (listed
in .gitignore), and again whenever a source is newer than the library.

Flags: ``-O3 -std=c++17``, no ``--use_fast_math`` (it would swap sinf for
__sinf, which the sin-hash RNG amplifies), and ``--fmad=false`` so every
multiply and add rounds on its own, as in the plain PyTorch versions the
kernels are held against.

``LAUNCHES`` counts kernel launches per wrapper; each wrapper in
ops/walk.py and ops/megakernel.py adds one where it launches its kernel.
K1, its K9, wide (K5) and frustum (K6) forms and K4's phase 1 are
instantiations of sample_kernel.cu behind separate entry points, so each
has its own count: K1 over the whole tree, the tiered view and the wide
tables runs a ``regen_kernel`` (K4's plain phase 1 ``regen_phase1_kernel``);
the K9 and K6 forms of both run the warp-tiled lockstep ``sample_kernel``.
K4's continuation runs ``continuation_kernel`` over the live rays of the
split, read through the compaction's permutation. The standalone walks
K2, K3, K5, K7 and K8 run ``live_walk_kernel``, one template over the
walk, over the live rays of their wave; K6 runs ``frustum_walk_kernel``
over the same map, a packet per warp.

``build`` also takes another source tree, output path and ``-D`` defines,
and ``bind`` loads any such library: scripts/k1_schedule.py builds K1, K4
and the standalone walks at other register budgets and schedules beside
these.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
LIB_PATH = os.path.join(BUILD_DIR, "librayzen_kernels.so")
SOURCES = ("walk_kernels.cu", "sample_kernel.cu", "continuation_kernel.cu")
HEADERS = ("common.cuh", "walk.cuh", "frustum.cuh", "shade.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# csrc/common.cuh STACK_DEPTH: the walks' per-thread stack (checked at load)
STACK_DEPTH = 64

# kernel -> launches made by its wrapper (reset with reset_launches()); the
# "_octant" entries are the instantiations with K9 bounce walks, "_wide" the
# K5 ones, "_frustum" those with the K6 primary walk, "_count" the counting
# K1, K4 and standalone walks (megakernel.walk_lane_counts,
# megakernel.continuation_lane_counts, walk.live_lane_counts: diagnostics)
LAUNCHES = {
    "sample_wave": 0, "sample_wave_tiered": 0,
    "sample_wave_octant": 0, "sample_wave_tiered_octant": 0,
    "sample_wave_wide": 0, "sample_wave_wide_octant": 0,
    "sample_wave_frustum": 0, "sample_wave_frustum_octant": 0,
    "sample_wave_phase1": 0, "sample_wave_phase1_octant": 0,
    "sample_wave_phase1_frustum": 0, "sample_wave_phase1_frustum_octant": 0,
    "sample_wave_count": 0, "sample_wave_tiered_count": 0,
    "sample_wave_wide_count": 0, "sample_wave_octant_count": 0,
    "sample_wave_tiered_octant_count": 0, "sample_wave_wide_octant_count": 0,
    "sample_wave_frustum_count": 0, "sample_wave_frustum_octant_count": 0,
    "continuation": 0, "continuation_octant": 0,
    "continuation_count": 0, "continuation_octant_count": 0,
    "closest_hit_bvh2": 0, "shadow_walk_bvh2": 0,
    "closest_hit_bvh2_count": 0, "shadow_walk_bvh2_count": 0,
    "closest_hit_tiered": 0, "shadow_walk_tiered": 0,
    "closest_hit_tiered_count": 0, "shadow_walk_tiered_count": 0,
    "closest_hit_bvh8": 0, "shadow_walk_bvh8": 0,
    "closest_hit_frustum": 0, "shadow_walk_frustum": 0,
    "closest_hit_frustum_count": 0, "shadow_walk_frustum_count": 0,
    "closest_hit_misslink": 0, "shadow_walk_misslink": 0,
    "closest_hit_misslink_count": 0, "shadow_walk_misslink_count": 0,
    "sample_wave_phase1_count": 0, "sample_wave_phase1_octant_count": 0,
    "sample_wave_phase1_frustum_count": 0,
    "sample_wave_phase1_frustum_octant_count": 0,
}

_lib = None
# serialises the build and binding of _lib between threads of one process
# (the file lock in build serialises processes only): the Renderer builds
# in a background thread while the caller's preview frames need K7
_lib_lock = threading.Lock()
build_log = ""  # nvcc's output of the last build (ptxas register/spill report)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _stale(csrc: str, out: str) -> bool:
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(
        os.path.getmtime(os.path.join(csrc, f)) > built for f in SOURCES + HEADERS
    )


def build(force: bool = False, csrc: str = CSRC, out: str = LIB_PATH,
          defines: tuple = ()) -> str:
    """Compile the sources of ``csrc`` into the library ``out`` if it is
    missing or stale, with ``-D`` ``defines`` ("NAME=VALUE"). Returns the
    library path. Safe to call from several processes at once."""
    global build_log
    build_dir = os.path.dirname(out)
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if force or _stale(csrc, out):
            exe = nvcc()
            flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
            objs = [os.path.join(build_dir, f + ".o") for f in SOURCES]
            procs = [
                subprocess.Popen(
                    [exe, *flags, "-c", "-o", obj, os.path.join(csrc, f)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for f, obj in zip(SOURCES, objs)
            ]
            logs = [p.communicate()[0] for p in procs]
            build_log = "".join(logs)
            if any(p.returncode for p in procs):
                raise RuntimeError(f"nvcc failed:\n{build_log}")
            tmp = out + f".tmp{os.getpid()}"
            proc = subprocess.run([exe, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            build_log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{build_log}")
            os.replace(tmp, out)
    return out


def ptxas_summary(log: str) -> dict:
    """Registers, stack frame and spill stores per kernel from nvcc's
    -Xptxas -v report, keyed "kernel<Walk>" (",octant" for the K9 forms,
    ",frustum" for those with the K6 primary walk, ",count" for the counting
    forms; the standalone walks' kernel is "live_walk_kernel<closest,Walk>"
    or "<shadow,Walk>", K6's "frustum_walk_kernel<closest>" or
    "<shadow>")."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            # (an anonymous namespace's mangling names the source file, so
            # every kernel of sample_kernel.cu holds "sample_kernel")
            kernel = next((k for k in ("continuation_kernel", "regen_kernel",
                                       "regen_phase1_kernel", "live_walk_kernel",
                                       "frustum_walk_kernel", "sample_kernel")
                           if k in mangled), mangled)
            count = (",count" if "LaneCount" in mangled or "Counted" in mangled
                     else "")
            walk = next((w for w in ("TieredWalk", "Bvh8Walk", "Bvh2Walk",
                                     "MisslinkWalk") if w in mangled), "Bvh2Walk")
            if kernel in ("live_walk_kernel", "frustum_walk_kernel"):
                # template <int kMode, ...>: 0 closest, 1 shadow
                mode = "closest" if f"{kernel}ILi0E" in mangled else "shadow"
                of = f",{walk}" if kernel == "live_walk_kernel" else ""
                cur = f"{kernel}<{mode}{of}{count}>"
                out[cur] = {}
                continue
            flags = re.findall(r"Lb([01])E", mangled)
            octant = ",octant" if flags[:1] == ["1"] else ""
            frustum = ",frustum" if flags[1:2] == ["1"] else ""
            cur = f"{kernel}<{walk}{octant}{frustum}{count}>"
            out[cur] = {}
        elif cur and "bytes stack frame" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[cur]["stack"], out[cur]["spill"] = nums[0], nums[1]
        elif cur and "Used" in ln and "registers" in ln:
            out[cur]["regs"] = int(ln.split("Used")[1].split()[0])
    return out


class SampleParams(ctypes.Structure):
    """Mirror of SampleParams in csrc/sample_kernel.cu (field for field)."""

    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("n_samples", ctypes.c_int32),
        ("max_bounces", ctypes.c_int32),
        ("rr_start", ctypes.c_int32),
        ("rng_hash", ctypes.c_int32),
        ("key", ctypes.c_int32),
        ("n_mats", ctypes.c_int32),
        ("n_lights", ctypes.c_int32),
        ("fuse", ctypes.c_int32),
        ("b_start", ctypes.c_int32),
        ("b_stop", ctypes.c_int32),
        ("samp0", ctypes.c_float),
        ("min_vis", ctypes.c_float),
        ("shadow_eps", ctypes.c_float),
        ("sky_h", ctypes.c_float * 3),
        ("sky_d", ctypes.c_float * 3),
        ("ambient", ctypes.c_float * 3),
    ]


def bind(path: str) -> ctypes.CDLL:
    """Load a kernel library and declare its entry points' arguments (those
    it has: a library built from an older tree lacks the newer ones)."""
    L = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sp = ctypes.POINTER(SampleParams)
    # tables, mats, lights, cam, uv, act, n, params, color, rays
    bvh2 = [p, p, i, i, p, p, p, p, p, i, sp, p, p]
    tiered = [p, p, p, i, i, i, i, p, p, p, p, p, i, sp, p, p]
    # tables, mats, state, n, order, live, params, color, rays, next, emit,
    # stream
    cont = [p, p, i, i, p, p, i, p, p, sp, p, p, p, i, p]
    # tables, orig, dir, act, n, t, tri, cross, menc, stream
    closest = [p, p, i, i, p, p, p, i, p, p, p, p, p]
    # tables, orig, dir, maxd, act, n, min_vis, t_eps, vis, stream
    shadow = [p, p, i, i, p, p, p, p, i, f, f, p, p]
    # K2: tables, orig, dir, act, t_init, n, width, height, t, tri, cross,
    # menc, stream; K3: tables, orig, dir, maxd, act, n, width, height,
    # min_vis, t_eps, vis, stream
    k2 = [p, p, i, i, p, p, p, p, i, i, i, p, p, p, p, p]
    k3 = [p, p, i, i, p, p, p, p, i, i, i, f, f, p, p]
    # K6: K2's arguments without t_init, and K3's
    k6 = [p, p, i, i, p, p, p, i, i, i, p, p, p, p, p]
    # K8: top, tre_inner, tre_leaf, si, sl, leaf_w, leaf_k, then as K5's
    k8_closest = [p, p, p, i, i, i, i, p, p, p, i, p, p, p, p, p]
    k8_shadow = [p, p, p, i, i, i, i, p, p, p, p, i, f, f, p, p]
    # K7: nodes, tris, leaf_k, orig, dir, (maxd,) act, n, width, height, ...
    k7_closest = [p, p, i, p, p, p, i, i, i, p, p, p, p, p]
    k7_shadow = [p, p, i, p, p, p, p, i, i, i, f, f, p, p]
    for name, args, res in (
        ("rz_error_string", [i], ctypes.c_char_p),
        ("rz_stack_depth", [], i),
        ("rz_sample_params_size", [], i),
        ("rz_closest_bvh2", k2, i),
        ("rz_shadow_bvh2", k3, i),
        ("rz_closest_bvh2_count", k2, i),
        ("rz_shadow_bvh2_count", k3, i),
        ("rz_closest_bvh8", closest, i),
        ("rz_shadow_bvh8", shadow, i),
        ("rz_closest_frustum", k6, i),
        ("rz_shadow_frustum", k3, i),
        ("rz_closest_frustum_count", k6, i),
        ("rz_shadow_frustum_count", k3, i),
        ("rz_closest_misslink", k7_closest, i),
        ("rz_shadow_misslink", k7_shadow, i),
        ("rz_closest_misslink_count", k7_closest, i),
        ("rz_shadow_misslink_count", k7_shadow, i),
        ("rz_live_walk_lanes", [p, i], i),
        ("rz_live_walk_budget", [i, p], i),
        ("rz_closest_tiered", k8_closest, i),
        ("rz_shadow_tiered", k8_shadow, i),
        ("rz_closest_tiered_count", k8_closest, i),
        ("rz_shadow_tiered_count", k8_shadow, i),
        ("rz_sample_wave", bvh2 + [p], i),
        ("rz_sample_wave_octant", bvh2 + [p], i),
        ("rz_sample_wave_tiered", tiered + [p], i),
        ("rz_sample_wave_tiered_octant", tiered + [p], i),
        ("rz_sample_wave_wide", bvh2 + [p], i),
        ("rz_sample_wave_wide_octant", bvh2 + [p], i),
        ("rz_sample_wave_frustum", bvh2 + [p], i),
        ("rz_sample_wave_frustum_octant", bvh2 + [p], i),
        ("rz_sample_wave_phase1", bvh2 + [p, p], i),
        ("rz_sample_wave_phase1_octant", bvh2 + [p, p], i),
        ("rz_sample_wave_phase1_frustum", bvh2 + [p, p], i),
        ("rz_sample_wave_phase1_frustum_octant", bvh2 + [p, p], i),
        ("rz_sample_wave_phase1_count", bvh2 + [p, p], i),
        ("rz_sample_wave_phase1_octant_count", bvh2 + [p, p], i),
        ("rz_sample_wave_phase1_frustum_count", bvh2 + [p, p], i),
        ("rz_sample_wave_phase1_frustum_octant_count", bvh2 + [p, p], i),
        ("rz_sample_wave_count", bvh2 + [p], i),
        ("rz_sample_wave_tiered_count", tiered + [p], i),
        ("rz_sample_wave_wide_count", bvh2 + [p], i),
        ("rz_sample_wave_octant_count", bvh2 + [p], i),
        ("rz_sample_wave_tiered_octant_count", tiered + [p], i),
        ("rz_sample_wave_wide_octant_count", bvh2 + [p], i),
        ("rz_sample_wave_frustum_count", bvh2 + [p], i),
        ("rz_sample_wave_frustum_octant_count", bvh2 + [p], i),
        ("rz_walk_lanes", [p, i], i),
        ("rz_sample_budget", [i, p], i),
        ("rz_continuation", cont, i),
        ("rz_continuation_octant", cont, i),
        ("rz_continuation_count", cont, i),
        ("rz_continuation_octant_count", cont, i),
        ("rz_continuation_lanes", [p, i], i),
        ("rz_continuation_budget", [i, p], i),
    ):
        if hasattr(L, name):
            fn = getattr(L, name)
            fn.argtypes = args
            fn.restype = res
    return L


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            L = bind(build())
            if L.rz_sample_params_size() != ctypes.sizeof(SampleParams):
                raise RuntimeError("SampleParams layout differs from the CUDA source")
            if L.rz_stack_depth() != STACK_DEPTH:
                raise RuntimeError("STACK_DEPTH differs from the CUDA source")
            _lib = L
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        msg = lib().rz_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
