"""Disk caches: the packed scene (NPZ) and, in place of JAX's compile cache,
where the kernel library lives.

Port of rayzen_tpu/cache.py. ``cached_pack_scene`` persists the host pack
(every SceneArrays table and its static layout) keyed by a content hash of
geometry, materials and lights plus the build config, and refreshes the
instance transforms from the live scene after a hit (main.cpp:1054-1060);
``force_rebuild`` is ``--rebuild-bvh``. A file that does not load is
rebuilt and rewritten.

The port's files live under ``cfg.cache_dir/packing.CACHE_SUBDIR`` and carry
a format tag (``SCENE_FORMAT``): the JAX package, whose default cache
directory is the same ``.rayzen_cache``, reads ``cache_dir/scene_*.npz``
and never this subdirectory, and the port reads only tagged files of its
own.

``setup_compile_cache`` has no XLA to configure: the port's only compiled
program is the kernel library, already a stale-checked build on disk
(ext.build, rebuilt only when a source is newer). It logs where the library
lives and does nothing else.
"""

from __future__ import annotations

import dataclasses
import os
import time
import zipfile

import numpy as np

from . import ext
from . import logging_util as log
from .config import RenderConfig
from .packing import (
    _SCENE_ARRAY_FIELDS, _SCENE_STATIC_FIELDS, CACHE_SUBDIR,
    SINGLE_TREE_VMEM_BUDGET, InstanceMeta, SceneArrays, host_array,
    pack_scene_host, save_npz,
)
from .scene import Scene

SCENE_FORMAT = "rayzen_tpu_torch/scene/v1"


def save_scene_arrays(path: str, arrays: SceneArrays) -> None:
    """Write a pack (numpy or tensor leaves) with its static layout."""
    data = {f: host_array(getattr(arrays, f)) for f in _SCENE_ARRAY_FIELDS}
    data["instance_meta"] = np.asarray(
        [dataclasses.astuple(m) for m in arrays.instance_meta], dtype=np.int64
    ).reshape(-1, 5)
    data["static"] = np.asarray(
        [getattr(arrays, f) for f in _SCENE_STATIC_FIELDS[1:]], dtype=np.int64)
    data["format"] = np.asarray(SCENE_FORMAT)
    save_npz(path, data)


def load_scene_arrays(path: str) -> SceneArrays:
    """Read a pack written by save_scene_arrays (numpy leaves); raises
    ValueError for a file without the port's format tag."""
    with np.load(path) as z:
        if "format" not in z.files or str(z["format"]) != SCENE_FORMAT:
            raise ValueError(f"not a {SCENE_FORMAT} file")
        kwargs = {f: z[f] for f in _SCENE_ARRAY_FIELDS}
        meta = tuple(InstanceMeta(*(int(x) for x in row))
                     for row in z["instance_meta"])
        static = dict(zip(_SCENE_STATIC_FIELDS[1:],
                          (int(x) for x in z["static"])))
    return SceneArrays(instance_meta=meta, **static, **kwargs)


def scene_cache_key(scene: Scene, cfg: RenderConfig) -> str:
    """JAX's key (geometry hash, leaf size, split method, tiered, treelet
    rows) and the single-tree budget, which decides the view under
    tiered="auto" (RAYZEN_TREE_BUDGET_MB)."""
    return (
        f"{scene.geometry_hash()}_{cfg.leaf_size}_{cfg.split_method}"
        f"_{cfg.tiered}_{cfg.treelet_rows}_{SINGLE_TREE_VMEM_BUDGET}"
    )


def scene_cache_path(scene: Scene, cfg: RenderConfig) -> str:
    return os.path.join(cfg.cache_dir, CACHE_SUBDIR,
                        f"scene_{scene_cache_key(scene, cfg)}.npz")


def cached_pack_scene(
    scene: Scene, cfg: RenderConfig, device, force_rebuild: bool = False
) -> SceneArrays:
    """pack_scene with the disk cache: the pack on ``device``, its
    transforms always those of the live scene."""
    path = scene_cache_path(scene, cfg)
    if not force_rebuild and os.path.exists(path):
        t0 = time.perf_counter()
        try:
            arrays = load_scene_arrays(path).with_transforms(scene.transforms())
            log.info(f"Scene cache hit: {path} "
                     f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")
            return arrays.to(device)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:  # corrupt: rebuild
            log.error(f"Scene cache load failed ({e}); rebuilding")
    t0 = time.perf_counter()
    host_arrays = pack_scene_host(scene, cfg)
    try:
        save_scene_arrays(path, host_arrays)
        log.info(f"Scene cache written: {path} "
                 f"(build {(time.perf_counter() - t0) * 1e3:.1f} ms)")
    except OSError as e:
        log.error(f"Scene cache write failed: {e}")
    return host_arrays.to(device)


def setup_compile_cache(cache_dir: str | None) -> None:
    """The counterpart of JAX's persistent XLA cache. The port compiles one
    thing, the kernel library, and ext.build already keeps it on disk and
    rebuilds it only when a source is newer; so this only logs where it
    lives (``cache_dir`` is not used)."""
    if cache_dir:
        log.info(f"Kernel library at {ext.LIB_PATH} (stale-checked build; "
                 f"no compile cache to set up at {cache_dir})")
