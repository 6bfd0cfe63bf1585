"""ctypes binding of the native (C++) host runtime: the SAH/midpoint BVH
builders and the OBJ parser.

Port of rayzen_tpu/accel/native.py. ``native/rayzen_native.cpp`` (a copy of
the JAX package's, C ABI unchanged) is built with g++ at first use into
``rayzen_tpu_torch/native/build/`` (listed in .gitignore), under a file
lock so that several processes can ask at once, and again whenever the
source is newer than the library. It is built without ``-march=native``:
the library may be carried to another host with the checkout, where it
must still load. Set RAYZEN_NATIVE=0 to use the numpy builders and parser
instead; they are also used where the compiler is missing. This is host
code that runs once per mesh, not a device kernel.

The native and numpy builders produce identical arrays
(tests/test_torch_native.py), so the BLAS disk cache and the frames do not
depend on which one ran.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

from .. import logging_util as log
from .builder import BLAS, build_blas as _py_build_blas, build_tlas as _py_build_tlas

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "native")
SRC = os.path.normpath(os.path.join(_NATIVE, "rayzen_native.cpp"))
BUILD_DIR = os.path.normpath(os.path.join(_NATIVE, "build"))
LIB_PATH = os.path.join(BUILD_DIR, "librayzen_native.so")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def _stale() -> bool:
    return (not os.path.exists(LIB_PATH)
            or os.path.getmtime(LIB_PATH) < os.path.getmtime(SRC))


def _compile_library() -> bool:
    """Build the library if it is missing or stale; False if g++ failed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():  # another process built it meanwhile
            return True
        tmp = f"{LIB_PATH}.tmp{os.getpid()}"
        try:
            res = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp],
                                 capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            log.error(f"native build failed to run: {e}")
            return False
        if res.returncode != 0:
            log.error(f"native build failed:\n{res.stderr[:2000]}")
            if os.path.exists(tmp):
                os.remove(tmp)
            return False
        os.replace(tmp, LIB_PATH)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("RAYZEN_NATIVE", "1") == "0":
            return None
        if _stale() and not _compile_library():
            return None
        try:
            lib = ctypes.CDLL(LIB_PATH)
        except OSError as e:
            log.error(f"native library load failed: {e}")
            return None
        lib.rz_build_blas.restype = ctypes.c_void_p
        lib.rz_build_blas.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.rz_build_tlas.restype = ctypes.c_void_p
        lib.rz_build_tlas.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        lib.rz_bvh_num_nodes.restype = ctypes.c_int64
        lib.rz_bvh_num_nodes.argtypes = [ctypes.c_void_p]
        lib.rz_bvh_num_prims.restype = ctypes.c_int64
        lib.rz_bvh_num_prims.argtypes = [ctypes.c_void_p]
        lib.rz_bvh_copy.restype = None
        lib.rz_bvh_copy.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rz_bvh_free.restype = None
        lib.rz_bvh_free.argtypes = [ctypes.c_void_p]
        lib.rz_obj_parse.restype = ctypes.c_void_p
        lib.rz_obj_parse.argtypes = [ctypes.c_char_p]
        lib.rz_obj_num_triangles.restype = ctypes.c_int64
        lib.rz_obj_num_triangles.argtypes = [ctypes.c_void_p]
        lib.rz_obj_copy.restype = None
        lib.rz_obj_copy.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.rz_obj_free.restype = None
        lib.rz_obj_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        log.debug("native runtime loaded")
        return _lib


def available() -> bool:
    return _load() is not None


def _unpack(lib, handle) -> BLAS:
    try:
        n_nodes = lib.rz_bvh_num_nodes(handle)
        n_prims = lib.rz_bvh_num_prims(handle)
        bounds = np.empty((n_nodes, 6), dtype=np.float32)
        meta = np.empty((n_nodes, 3), dtype=np.int32)
        order = np.empty((n_prims,), dtype=np.int64)
        lib.rz_bvh_copy(
            handle,
            bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    finally:
        lib.rz_bvh_free(handle)
    return BLAS(
        bounds_min=np.ascontiguousarray(bounds[:, :3]),
        bounds_max=np.ascontiguousarray(bounds[:, 3:]),
        left_first=np.ascontiguousarray(meta[:, 0]),
        count=np.ascontiguousarray(meta[:, 1]),
        miss=np.ascontiguousarray(meta[:, 2]),
        order=order,
    )


def build_blas(tri_verts: np.ndarray, leaf_size: int = 4,
               split_method: str = "sah") -> BLAS:
    """Native BLAS build; the numpy builder where the runtime is
    unavailable."""
    lib = _load()
    if lib is None:
        return _py_build_blas(tri_verts, leaf_size, split_method)
    verts = np.ascontiguousarray(tri_verts, dtype=np.float32).reshape(-1, 9)
    handle = lib.rz_build_blas(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        verts.shape[0],
        leaf_size,
        1 if split_method == "sah" else 0,
    )
    return _unpack(lib, handle)


def build_tlas(inst_bmin: np.ndarray, inst_bmax: np.ndarray) -> BLAS:
    """Native TLAS build; the numpy builder where the runtime is
    unavailable."""
    lib = _load()
    if lib is None:
        return _py_build_tlas(inst_bmin, inst_bmax)
    bmin = np.ascontiguousarray(inst_bmin, dtype=np.float32).reshape(-1, 3)
    bmax = np.ascontiguousarray(inst_bmax, dtype=np.float32).reshape(-1, 3)
    if bmin.shape != bmax.shape:
        raise ValueError("build_tlas: bmin and bmax differ in shape")
    handle = lib.rz_build_tlas(
        bmin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bmax.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bmin.shape[0],
    )
    return _unpack(lib, handle)


def parse_obj_file(path: str):
    """Native OBJ parse: (T, 3, 3) float32 vertices, or None when the file
    cannot be opened or the runtime is unavailable (callers fall back to the
    Python parser)."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.rz_obj_parse(os.fsencode(path))
    if not handle:
        return None
    try:
        n = lib.rz_obj_num_triangles(handle)
        verts = np.empty((n, 9), dtype=np.float32)
        if n:
            lib.rz_obj_copy(handle, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    finally:
        lib.rz_obj_free(handle)
    return verts.reshape(-1, 3, 3)
