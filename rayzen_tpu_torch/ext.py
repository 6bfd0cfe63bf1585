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
instantiations of one kernel (sample_kernel.cu) behind separate entry
points, so each has its own count.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess

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
# K5 ones and "_frustum" those with the K6 primary walk
LAUNCHES = {
    "sample_wave": 0, "sample_wave_tiered": 0,
    "sample_wave_octant": 0, "sample_wave_tiered_octant": 0,
    "sample_wave_wide": 0, "sample_wave_wide_octant": 0,
    "sample_wave_frustum": 0, "sample_wave_frustum_octant": 0,
    "sample_wave_phase1": 0, "sample_wave_phase1_octant": 0,
    "sample_wave_phase1_frustum": 0, "sample_wave_phase1_frustum_octant": 0,
    "continuation": 0, "continuation_octant": 0,
    "closest_hit_bvh2": 0, "shadow_walk_bvh2": 0,
    "closest_hit_tiered": 0, "shadow_walk_tiered": 0,
    "closest_hit_bvh8": 0, "shadow_walk_bvh8": 0,
    "closest_hit_frustum": 0, "shadow_walk_frustum": 0,
    "closest_hit_misslink": 0, "shadow_walk_misslink": 0,
}

_lib = None
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


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(
        os.path.getmtime(os.path.join(CSRC, f)) > built for f in SOURCES + HEADERS
    )


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into LIB_PATH if it is missing or stale. Returns the
    library path. Safe to call from several processes at once."""
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if force or _stale():
            exe = nvcc()
            objs = [os.path.join(BUILD_DIR, f + ".o") for f in SOURCES]
            procs = [
                subprocess.Popen(
                    [exe, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, f)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for f, obj in zip(SOURCES, objs)
            ]
            logs = [p.communicate()[0] for p in procs]
            build_log = "".join(logs)
            if any(p.returncode for p in procs):
                raise RuntimeError(f"nvcc failed:\n{build_log}")
            tmp = LIB_PATH + f".tmp{os.getpid()}"
            proc = subprocess.run([exe, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            build_log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{build_log}")
            os.replace(tmp, LIB_PATH)
    return LIB_PATH


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


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        path = build()
        L = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L.rz_error_string.argtypes = [i]
        L.rz_error_string.restype = ctypes.c_char_p
        L.rz_stack_depth.restype = i
        L.rz_sample_params_size.restype = i
        sp = ctypes.POINTER(SampleParams)
        # tables, mats, lights, cam, uv, act, n, params, color, rays
        bvh2 = [p, p, i, i, p, p, p, p, p, i, sp, p, p]
        tiered = [p, p, p, i, i, i, i, p, p, p, p, p, i, sp, p, p]
        # tables, mats, state_in, n, params, color, rays, state_out, stream
        cont = [p, p, i, i, p, p, i, sp, p, p, p, p]
        # tables, orig, dir, act, n, t, tri, cross, menc, stream
        closest = [p, p, i, i, p, p, p, i, p, p, p, p, p]
        # tables, orig, dir, maxd, act, n, min_vis, t_eps, vis, stream
        shadow = [p, p, i, i, p, p, p, p, i, f, f, p, p]
        for name, args in (
            ("rz_closest_bvh2", [p, p, i, i, p, p, p, p, i, p, p, p, p, p]),
            ("rz_shadow_bvh2", shadow),
            ("rz_closest_bvh8", closest),
            ("rz_shadow_bvh8", shadow),
            ("rz_closest_frustum", closest),
            ("rz_shadow_frustum", shadow),
            ("rz_closest_misslink", [p, i, i, p, p, p, i, p, p, p, p, p]),
            ("rz_shadow_misslink", [p, i, i, p, p, p, p, i, f, f, p, p]),
            ("rz_closest_tiered", [p, p, p, i, i, i, i, p, p, p, i, p, p, p, p, p]),
            ("rz_shadow_tiered", [p, p, p, i, i, i, i, p, p, p, p, i, f, f, p, p]),
            ("rz_sample_wave", bvh2 + [p]),
            ("rz_sample_wave_octant", bvh2 + [p]),
            ("rz_sample_wave_tiered", tiered + [p]),
            ("rz_sample_wave_tiered_octant", tiered + [p]),
            ("rz_sample_wave_wide", bvh2 + [p]),
            ("rz_sample_wave_wide_octant", bvh2 + [p]),
            ("rz_sample_wave_frustum", bvh2 + [p]),
            ("rz_sample_wave_frustum_octant", bvh2 + [p]),
            ("rz_sample_wave_phase1", bvh2 + [p, p]),
            ("rz_sample_wave_phase1_octant", bvh2 + [p, p]),
            ("rz_sample_wave_phase1_frustum", bvh2 + [p, p]),
            ("rz_sample_wave_phase1_frustum_octant", bvh2 + [p, p]),
            ("rz_continuation", cont),
            ("rz_continuation_octant", cont),
        ):
            fn = getattr(L, name)
            fn.argtypes = args
            fn.restype = i
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
