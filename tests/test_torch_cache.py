"""The disk caches, the profiler and the PNG writer of the port: the scene
cache round-trip and its hit (the JAX package's tables, the live
transforms), the per-mesh BLAS disk tier and --rebuild-bvh, corrupt files,
the two packages' files kept apart in one cache directory, FrameProfiler
against JAX's on the same recorded frames, and write_png at both deflate
levels. Small scene (build_small_scene), 32x24."""

import dataclasses
import os
import struct
import types
import zlib

import numpy as np
import pytest

from rayzen_tpu import cache as jcache
from rayzen_tpu import config as jconfig
from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu import profiler as jprofiler
from rayzen_tpu_torch import RenderConfig, cache, demo, packing, profiler
from rayzen_tpu_torch.image_io import to_uint8, write_png
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 32, 24


@pytest.fixture
def cfgs(tmp_path):
    jcfg = jconfig.RenderConfig(width=W, height=H, cache_dir=str(tmp_path))
    return jcfg, RenderConfig(**dataclasses.asdict(jcfg))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_scene_cache_roundtrip_and_hit_match_jax(cfgs):
    """The cached pack holds the JAX package's tables; a hit brings back
    every table and the static layout, with the live scene's transforms."""
    jcfg, cfg = cfgs
    jpack._blas_cache.clear()
    jarrays = jpack.pack_scene(jdemo.build_small_scene(W, H), jcfg)
    scene = demo.build_small_scene(W, H)
    first = cache.cached_pack_scene(scene, cfg, "cpu")
    for f in ("tri_v0", "node_meta", "uni_meta", "bvh2_child_ref", "node_leaf_tri",
              "transforms", "lights"):
        np.testing.assert_array_equal(getattr(first, f).numpy(),
                                      np.asarray(getattr(jarrays, f)))
    scene.game_objects[1].transform = scene.game_objects[1].transform.copy()
    scene.game_objects[1].transform[1, 3] += 2.0
    hit = cache.cached_pack_scene(scene, cfg, "cpu")
    np.testing.assert_array_equal(hit.transforms.numpy(), scene.transforms())
    np.testing.assert_allclose(
        hit.inv_transforms.numpy()[1],
        np.linalg.inv(scene.transforms()[1].astype(np.float64)), atol=1e-6)
    for f in packing._SCENE_ARRAY_FIELDS:
        if f not in ("transforms", "inv_transforms"):
            np.testing.assert_array_equal(getattr(hit, f).numpy(),
                                          getattr(first, f).numpy())
    for f in packing._SCENE_STATIC_FIELDS:
        assert getattr(hit, f) == getattr(first, f)


def test_blas_disk_tier_and_rebuild_bvh(cfgs, monkeypatch):
    """A pack with an empty memo reads the per-mesh files and runs no
    builder; rebuild_bvh skips the files and builds."""
    _, cfg = cfgs
    scene = demo.build_small_scene(W, H)
    packing._blas_cache.clear()
    ref = packing.pack_scene_host(scene, cfg)  # builds, writes the files
    assert any(p.startswith(os.path.join(packing.CACHE_SUBDIR, "blas"))
               for p in _tree(cfg.cache_dir))

    def boom(*a, **k):
        raise AssertionError("BLAS builder ran despite a disk-cache hit")

    packing._blas_cache.clear()
    monkeypatch.setattr(packing, "build_blas", boom)
    again = packing.pack_scene_host(scene, cfg)
    np.testing.assert_array_equal(again.node_meta, ref.node_meta)
    packing._blas_cache.clear()
    with pytest.raises(AssertionError, match="builder ran"):
        packing.pack_scene_host(scene, cfg.replace(rebuild_bvh=True))


def test_corrupt_files_rebuild(cfgs):
    _, cfg = cfgs
    scene = demo.build_small_scene(W, H)
    packing._blas_cache.clear()
    good = cache.cached_pack_scene(scene, cfg, "cpu")
    for rel in _tree(cfg.cache_dir):
        with open(os.path.join(cfg.cache_dir, rel), "wb") as f:
            f.write(b"not an npz")
    packing._blas_cache.clear()
    again = cache.cached_pack_scene(scene, cfg, "cpu")
    np.testing.assert_array_equal(again.node_meta.numpy(), good.node_meta.numpy())
    # both tiers were rewritten and load again
    cache.load_scene_arrays(cache.scene_cache_path(scene, cfg))
    packing._blas_cache.clear()
    cache.cached_pack_scene(scene, cfg, "cpu")


def test_port_and_jax_files_stay_apart(cfgs):
    """In one cache directory each package writes and reads only its own
    files: the port's misses on JAX's files and rewrites its own, and JAX
    still hits its own after the port wrote."""
    jcfg, cfg = cfgs
    jpack._blas_cache.clear()
    jcache.cached_pack_scene(jdemo.build_small_scene(W, H), jcfg)
    jax_files = _tree(cfg.cache_dir)
    packing._blas_cache.clear()
    scene = demo.build_small_scene(W, H)
    cache.cached_pack_scene(scene, cfg, "cpu")
    ours = sorted(set(_tree(cfg.cache_dir)) - set(jax_files))
    assert ours and all(p.startswith(packing.CACHE_SUBDIR + os.sep) for p in ours)
    assert not any(p.startswith(packing.CACHE_SUBDIR) for p in jax_files)
    with pytest.raises(ValueError):  # a JAX file is not the port's format
        cache.load_scene_arrays(os.path.join(
            cfg.cache_dir, next(p for p in jax_files if p.startswith("scene_"))))
    jpack._blas_cache.clear()
    jcache.cached_pack_scene(jdemo.build_small_scene(W, H), jcfg)
    assert sorted(set(_tree(cfg.cache_dir)) - set(jax_files)) == ours


def test_profiler_matches_jax_on_recorded_frames(monkeypatch):
    """The same frames on the same clock give both packages' profilers the
    same records, EMA and summary: sync frames with phases, an async record
    (no phases carried over), and resolves that arrive faster than their
    latency (throughput-aware fps)."""
    times = np.arange(0.0, 100.0, 0.01).tolist()

    def run(mod):
        it = iter(times)
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(perf_counter=lambda: next(it)))
        p = mod.FrameProfiler(fps_alpha=0.5)
        for _ in range(3):
            p.begin_frame()
            with p.phase("render"):
                pass
            p.end_frame(rays_traced=1000)
        p.record(300.0)
        p.record(300.0, rays_traced=5)
        return p

    ours, ref = run(profiler), run(jprofiler)
    assert ours.history == ref.history and ours.fps_ema == ref.fps_ema
    assert ours.summary(skip=1) == ref.summary(skip=1)
    assert "render" not in ours.history[3] and ours.history[4]["fps"] > 50.0


@pytest.mark.parametrize("level", [1, 6])
def test_write_png_roundtrips(tmp_path, level):
    """Both deflate levels write a PNG whose pixels read back (top-down
    rows, the frame's bottom-up rows flipped)."""
    img = np.random.RandomState(level).uniform(0, 1, (H, W, 3)).astype(np.float32)
    path = str(tmp_path / f"f{level}.png")
    write_png(path, img, compress_level=level)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + W * 3)
    assert (raw[:, 0] == 0).all()
    np.testing.assert_array_equal(raw[:, 1:].reshape(H, W, 3), to_uint8(img)[::-1])
