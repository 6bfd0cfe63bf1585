"""The split-bounce wavefront (K4) and the octant-masked bounce walks (K9)
of the port against the JAX package: the compaction permutation bit for
bit, the plain split against the JAX split path and against the plain K1,
the plain octant K1 against the JAX megakernel with octant_bounce_walks
(interpret mode), and which configs take the split in render_rays."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_rays
from rayzen_tpu import config as jconfig
from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu.integrator import render_radiance_with_stats
from rayzen_tpu.ops import megakernel as jmk
from rayzen_tpu_torch import RenderConfig, convert, pack_scene
from rayzen_tpu_torch.demo import build_small_scene
from rayzen_tpu_torch.integrator import check_config, render_rays
from rayzen_tpu_torch.ops import megakernel, walk
from rayzen_tpu_torch.ops.camera_rays import pixel_grid
from rayzen_tpu_torch.packing import world_geometry

W, H, MB = 32, 24, 4


def _jax_leaves(x):
    return {f.name: (getattr(x, f.name) if f.metadata.get("static")
                     else np.asarray(getattr(x, f.name)))
            for f in dataclasses.fields(x)}


@pytest.mark.parametrize("n", [1000, 4097])
@pytest.mark.parametrize("mode", ["rank", "octant", "octcell", "other"])
def test_compaction_permutation_is_bitwise_jax(mode, n):
    rs = np.random.RandomState(n)
    alive = rs.uniform(size=n) < 0.3
    d = rs.normal(size=(3, n)).astype(np.float32)
    o = rs.uniform(-4.0, 4.0, size=(3, n)).astype(np.float32)
    jd, jo = jmk._compaction_permutation(
        jnp.asarray(alive), *map(jnp.asarray, d), mode,
        origins=tuple(map(jnp.asarray, o)))
    td, to = megakernel._compaction_permutation(
        torch.from_numpy(alive), *map(torch.from_numpy, d), mode,
        origins=tuple(map(torch.from_numpy, o)))
    for t, j in ((td, jd), (to, jo)):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (to.sort().values == torch.arange(n, dtype=torch.int32)).all()
    assert alive[to[: int(alive.sum())].numpy()].all()  # the live rays first


@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    """The small scene packed by the JAX package, its refit tables carried
    into the port, and the camera."""
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    scene = jdemo.build_small_scene(W, H)
    jcfg = jconfig.RenderConfig(width=W, height=H, spp=1, max_bounces=MB,
                                kernels="pallas",
                                cache_dir=str(tmp_path_factory.mktemp("blas")))
    arrays = jpack.pack_scene(scene, jcfg)
    tws = convert.world_arrays_from_numpy(
        _jax_leaves(jpack.world_geometry(arrays)), "cpu")
    return jcfg, arrays, tws, scene.camera.device_params()


def _jax_render(jax_world, **knobs):
    jcfg, arrays, _tws, cam = jax_world
    jimg, jrays = render_radiance_with_stats(
        arrays, {k: jnp.asarray(v) for k, v in cam.items()},
        jcfg.replace(**knobs))
    return np.asarray(jimg), int(jrays)


def _port_image(total, rays, spp=1):
    img = torch.clamp(total / float(spp), 0.0, 1.0).reshape(H, W, 3).numpy()
    assert rays.dtype == torch.int64 and rays.dim() == 0
    return img, int(rays)


def _assert_close(port, jax, atol=1e-6):
    (timg, trays), (jimg, jrays) = port, jax
    assert np.abs(timg - jimg).max() <= atol
    assert trays == jrays


def test_plain_split_matches_jax_split_path(jax_world):
    knobs = dict(split_bounce=2, split_rebin="octant")
    _jcfg, _arrays, tws, cam = jax_world
    _, uv = pixel_grid(W, H, "cpu")
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=MB, **knobs)
    port = _port_image(*megakernel.sample_wave_split(
        tws, cfg, uv, torch.ones(uv.shape[0], dtype=torch.bool), cam, 0, 0, MB))
    _assert_close(port, _jax_render(jax_world, **knobs))


def test_plain_octant_k1_matches_jax_megakernel(jax_world):
    _jcfg, _arrays, tws, cam = jax_world
    _, uv = pixel_grid(W, H, "cpu")
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=MB,
                       octant_bounce_walks=True)
    port = _port_image(*megakernel.sample_wave(
        tws, cfg, uv, torch.ones(uv.shape[0], dtype=torch.bool), cam, 0, 0, MB))
    _assert_close(port, _jax_render(jax_world, octant_bounce_walks=True))


def test_plain_octant_walk_matches_plain_k2(jax_world):
    tws = jax_world[2]
    o, d = (torch.from_numpy(x) for x in random_rays(512, seed=5, spread=2.5))
    act = torch.from_numpy(np.random.RandomState(6).uniform(size=512) < 0.9)
    k2 = walk.closest_walk_reference(tws, o, d, act)
    k9 = megakernel.octant_walk_reference(tws, o, d, act)
    assert k2[1].ge(0).any() and (k2[1] != k9[1]).sum() == 0
    for a, b in zip(k9, k2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


SW, SH = 40, 36


@pytest.fixture(scope="module")
def small_k1():
    """The port's own pack of the small scene at 40x36 (not a multiple of a
    warp or a packet), spp 2, rng_key 3, and the plain K1's frame."""
    walk_scene = build_small_scene(SW, SH)
    cfg = RenderConfig(width=SW, height=SH, spp=2, max_bounces=5)
    arrays = pack_scene(walk_scene, cfg, "cpu")
    cam = walk_scene.camera.device_params()
    frag, uv = pixel_grid(SW, SH, "cpu")
    img, rays = render_rays(arrays, frag, uv, cam, cfg, rng_key=3,
                            with_stats=True)
    return cfg, arrays, cam, frag, uv, img, int(rays)


@pytest.mark.parametrize("knobs", [
    dict(split_bounce=1), dict(split_bounce=2), dict(split_bounce=3),
    dict(split_bounce=2, split_rebin="octcell"),
    dict(split_bounce=2, split_rebin="octant", split_every=True),
    dict(split_bounce=1, octant_bounce_walks=True, split_every=True),
], ids=["b1", "b2", "b3", "octcell", "every", "octant_walks_every"])
def test_plain_split_matches_plain_k1(small_k1, knobs, monkeypatch):
    cfg, arrays, cam, frag, uv, img, rays = small_k1
    calls = []
    split = megakernel.sample_wave_split
    monkeypatch.setattr(megakernel, "sample_wave_split",
                        lambda *a: calls.append(1) or split(*a))
    simg, srays = render_rays(arrays, frag, uv, cam, cfg.replace(**knobs),
                              rng_key=3, with_stats=True)
    assert len(calls) == cfg.spp  # one split per sample
    assert (simg - img).abs().max().item() <= 1e-6
    assert int(srays) == rays


def test_split_continuation_state(small_k1):
    """Phase 1's rows: the live rays carry their paths, the others zeros
    and alive 0; the seeds are the sampler's. A continuation that emits
    leaves only rays it traced alive."""
    cfg, arrays, cam, _frag, uv, _img, _rays = small_k1
    cfg = cfg.replace(split_bounce=1)
    ws = world_geometry(arrays)
    act = torch.arange(uv.shape[0]) % 5 != 0
    color, rays, state = megakernel.sample_wave_phase1(
        ws, cfg, uv, act, cam, 0, 3, 5)
    alive = state[10] > 0.5
    assert state.shape == (13, uv.shape[0]) and alive.any() and not alive.all()
    assert (state[:10, ~alive] == 0).all() and (state[:, ~act] == 0).all()
    assert (state[6:9, alive] > 0).all()  # throughput after bounce 0
    assert (color[~act] == 0).all() and int(rays) > int(act.sum())
    _c, _r, state2 = megakernel.continuation(ws, cfg, state, 0, 3, 5, 1, 2,
                                             emit=True)
    assert not (state2[10] > 0.5)[~alive].any()
    torch.testing.assert_close(state2[11:], state[11:], rtol=0, atol=0)


def test_octant_tiered_k1_matches_tiered_k1(small_k1):
    """K9 over the treelet view (K8 sub-walks): the plain octant tiered K1
    renders the plain tiered K1's frame."""
    cfg, _arrays, cam, _frag, uv, _img, _rays = small_k1
    cfg = cfg.replace(tiered="on", treelet_rows=8, max_bounces=4)
    ws = world_geometry(pack_scene(build_small_scene(SW, SH), cfg, "cpu"))
    assert ws.tiered
    act = torch.ones(uv.shape[0], dtype=torch.bool)
    base = megakernel.sample_wave(ws, cfg, uv, act, cam, 0, 0, 4)
    octant = megakernel.sample_wave(
        ws, cfg.replace(octant_bounce_walks=True), uv, act, cam, 0, 0, 4)
    torch.testing.assert_close(octant[0], base[0], rtol=0, atol=0)
    assert int(octant[1]) == int(base[1])


@pytest.mark.parametrize("knobs", [
    dict(split_bounce=2, rng="threefry"),
    dict(split_bounce=2, tiered="on", treelet_rows=8),
    dict(split_bounce=5),  # not below max_bounces
], ids=["hash_rng", "tiered", "past_budget"])
def test_split_off_path_takes_fused_k1(small_k1, knobs, monkeypatch):
    cfg, _arrays, cam, frag, uv, _img, _rays = small_k1
    cfg = cfg.replace(spp=1, **knobs)
    check_config(cfg)
    arrays = pack_scene(build_small_scene(SW, SH), cfg, "cpu")

    def refuse(*a):
        raise AssertionError("took the split")

    monkeypatch.setattr(megakernel, "sample_wave_split", refuse)
    img = render_rays(arrays, frag, uv, cam, cfg)
    assert img.shape == (SW * SH, 3) and torch.isfinite(img).all()


def test_split_wrappers_refuse_other_devices(small_k1):
    cfg, arrays, cam, _frag, uv, _img, _rays = small_k1
    cfg = cfg.replace(split_bounce=2)
    ws = world_geometry(arrays)
    act = torch.ones(uv.shape[0], dtype=torch.bool)
    with pytest.raises(ValueError, match="device meta"):
        megakernel.sample_wave_phase1(ws, cfg, uv.to("meta"), act, cam, 0, 0, 5)
    with pytest.raises(ValueError, match="device meta"):
        megakernel.continuation(ws, cfg, torch.zeros(13, 8, device="meta"),
                                0, 0, 5, 2, 5, emit=False)
    with pytest.raises(ValueError, match="split_bounce must be"):
        megakernel.sample_wave_split(ws, cfg.replace(split_bounce=5), uv, act,
                                     cam, 0, 0, 5)
