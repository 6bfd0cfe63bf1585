"""The port's tiered (treelet) view and its K8 walks against the JAX package:
the tiered refit tables, the plain K8 walks against the plain whole-tree
K2/K3 walks, the plain tiered K1 against the JAX tiered megakernel
(interpret mode) and the pack-time choice on the 503k-triangle field. The
cheap checks (the treelet pack, the stacks' depth checks) are in
test_torch_tiered_checks.py."""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_rays
from rayzen_tpu import config as jconfig
from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu.integrator import render_radiance_with_stats
from rayzen_tpu.mesh import Mesh as JMesh
from rayzen_tpu.scene import GameObject as JGameObject
from rayzen_tpu.scene import Scene as JScene
from rayzen_tpu.transforms import rotation as jrotation
from rayzen_tpu.transforms import translation as jtranslation
from rayzen_tpu_torch import config as tconfig
from rayzen_tpu_torch import convert
from rayzen_tpu_torch import demo as tdemo
from rayzen_tpu_torch import packing as tpack
from rayzen_tpu_torch.image_io import ssim
from rayzen_tpu_torch.mesh import Mesh as TMesh
from rayzen_tpu_torch.ops import megakernel, walk
from rayzen_tpu_torch.ops.camera_rays import pixel_grid
from rayzen_tpu_torch.scene import GameObject as TGameObject
from rayzen_tpu_torch.scene import Scene as TScene
from rayzen_tpu_torch.transforms import rotation as trotation
from rayzen_tpu_torch.transforms import translation as ttranslation
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 32, 24
TREELET_FIELDS = ("top_child_node", "top_child_ref", "top_child_count",
                  "tre_child_node", "tre_child_ref", "tre_child_count",
                  "tre_leaf_src")


def _jax_leaves(x):
    return {f.name: (getattr(x, f.name) if f.metadata.get("static")
                     else np.asarray(getattr(x, f.name)))
            for f in dataclasses.fields(x)}


def _packs(tiered, tmp_path):
    """The small scene packed by both packages (host side)."""
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    kw = dict(width=W, height=H, tiered=tiered, treelet_rows=8)
    ja = jpack.pack_scene_host(jdemo.build_small_scene(W, H),
                               jconfig.RenderConfig(**kw, cache_dir=str(tmp_path)))
    ta = tpack.pack_scene_host(tdemo.build_small_scene(W, H),
                               tconfig.RenderConfig(**kw))
    return ja, ta


@pytest.fixture(scope="module")
def tiered_world(tmp_path_factory):
    """The JAX pack and refit of the small scene with the treelet view, and
    the port's own refit of its own pack."""
    ja, ta = _packs("on", tmp_path_factory.mktemp("blas"))
    jw = jpack.world_geometry(jax.device_put(ja))
    tw = tpack.world_geometry(ta.to("cpu"))
    return ja, ta, jw, tw


def test_tiered_tables_match_jax(tiered_world):
    _ja, ta, jw, tw = tiered_world
    assert tw.tiered and jw.tiered
    w2 = tw.leaf_table.shape[1]
    np.testing.assert_allclose(tw.top_table.numpy(), np.asarray(jw.top_table),
                               rtol=0, atol=0)
    np.testing.assert_allclose(tw.tre_inner.numpy(),
                               np.asarray(jw.tre_inner)[..., :16], rtol=0, atol=0)
    np.testing.assert_allclose(tw.tre_leaf.numpy(),
                               np.asarray(jw.tre_leaf)[..., :w2], rtol=0, atol=0)
    assert tw.tre_inner.shape == (ta.tre_child_node.shape[0], 8, 16)
    # the depth bounds carried across from the JAX tables equal the pack's
    cw = convert.world_arrays_from_numpy(_jax_leaves(jw), "cpu")
    assert cw.tiered
    assert (cw.top_depth, cw.treelet_depth) == (ta.top_depth, ta.treelet_depth) != (0, 0)
    assert cw.tre_inner.shape == tw.tre_inner.shape
    assert cw.tre_leaf.shape == tw.tre_leaf.shape


def _rays(kind):
    if kind == "primary":
        cam = tdemo.build_small_scene(W, H).camera.device_params()
        _, uv = pixel_grid(W, H, "cpu")
        z = torch.zeros_like(uv[:, 0])
        ray = megakernel._raygen_tiles(uv[:, 0], uv[:, 1], z, z,
                                       megakernel._pack_camera(cam, "cpu"))
        return torch.stack(ray[:3], 1), torch.stack(ray[3:], 1)
    o, d = random_rays(512, seed=3, spread=2.5)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("kind", ["primary", "random"])
def test_k8_plain_matches_whole_tree(tiered_world, kind):
    tw = tiered_world[3]
    o, d = _rays(kind)
    act = torch.ones(o.shape[0], dtype=torch.bool)
    whole = walk.closest_hit_bvh2(tw, o, d, act)
    tiered = walk.closest_hit_tiered(tw, o, d, act)
    assert whole.found.any() and not whole.found.all()
    assert (tiered.tri != whole.tri).sum() == 0
    torch.testing.assert_close(tiered.t, whole.t, rtol=0, atol=0)
    torch.testing.assert_close(tiered.menc, whole.menc, rtol=0, atol=0)
    # shadow rays from the hits toward a light, and along the rays with
    # random bounds through the transparent cube
    ldir = torch.nn.functional.normalize(torch.tensor([0.3, 0.9, 0.1]), dim=0)
    ldir = ldir.expand_as(o).contiguous()
    md = torch.from_numpy(np.random.RandomState(9).uniform(0.5, 8.0, o.shape[0])
                          .astype(np.float32))
    for so, sd, sm, sa in ((whole.point + ldir * 1e-3, ldir, 50.0, whole.found),
                           (o, d, md, act)):
        wv, wr = walk.shadow_walk_bvh2(tw, so, sd, sm, sa)
        tv, tr = walk.shadow_walk_tiered(tw, so, sd, sm, sa)
        assert (wv < 1).any() and int(tr) == int(wr)
        torch.testing.assert_close(tv, wv, rtol=0, atol=1e-6)


@pytest.fixture(scope="module", params=["threefry", "reference"])
def tiered_renders(request, tmp_path_factory):
    """(JAX image, JAX rays, port image, port rays): the JAX tiered megakernel
    (interpret mode) and the port's plain tiered K1 on the JAX tables."""
    scene = jdemo.build_small_scene(W, H)
    jcfg = jconfig.RenderConfig(width=W, height=H, spp=1, max_bounces=3,
                                tiered="on", treelet_rows=8, kernels="pallas",
                                rng=request.param,
                                cache_dir=str(tmp_path_factory.mktemp("blas")))
    arrays = jpack.pack_scene(scene, jcfg)
    cam = {k: jnp.asarray(v) for k, v in scene.camera.device_params().items()}
    jimg, jrays = render_radiance_with_stats(arrays, cam, jcfg)

    tws = convert.world_arrays_from_numpy(
        _jax_leaves(jpack.world_geometry(arrays)), "cpu")
    assert tws.tiered
    tcfg = tconfig.RenderConfig(width=W, height=H, spp=1, max_bounces=3,
                                rng=request.param)
    _, uv = pixel_grid(W, H, "cpu")
    total, rays = megakernel.sample_wave(
        tws, tcfg, uv, torch.ones(uv.shape[0], dtype=torch.bool),
        scene.camera.device_params(), 0, 0, 3,
    )
    timg = torch.clamp(total, 0.0, 1.0).reshape(H, W, 3).numpy()
    return request.param, np.asarray(jimg), int(jrays), timg, int(rays)


def test_tiered_k1_plain_matches_jax_megakernel(tiered_renders):
    rng, jimg, jrays, timg, trays = tiered_renders
    if rng == "threefry":  # the bars of tests/test_torch_megakernel.py
        err = np.abs(timg - jimg).max(axis=-1)
        assert (err < 1e-4).mean() >= 0.998, f"max err {err.max()}"
    else:
        assert ssim(timg, jimg) >= 0.995
        assert np.abs(timg - jimg).mean() < 2e-3
    assert trays == jrays


def _field(Mesh, GameObject, Scene, rotation, translation, n=520):
    """The Suzanne field of scripts/bench_large.py:68-82 (geometry only)."""
    monkey = Mesh.load_from_obj(os.path.join(tdemo.ASSET_DIR, "monkey.obj"), 0)
    side = int(math.ceil(math.sqrt(n)))
    return Scene(game_objects=[
        GameObject(
            mesh=monkey,
            transform=translation((2.2 * (i % side - side / 2), 0.0,
                                   -2.2 * (i // side)))
            @ rotation(math.radians((i * 37.0) % 360.0), (0.0, 1.0, 0.0)),
            material_override=i % 3,
        )
        for i in range(n)
    ])


def test_field_packs_tiered_in_both_packages(tmp_path):
    jpack._blas_cache.clear()
    ja = jpack.pack_scene_host(
        _field(JMesh, JGameObject, JScene, jrotation, jtranslation),
        jconfig.RenderConfig(cache_dir=str(tmp_path)))
    ta = tpack.pack_scene_host(
        _field(TMesh, TGameObject, TScene, trotation, ttranslation),
        tconfig.RenderConfig())
    assert int(ta.wtri_src.shape[0]) == 503_360
    n_inner, n_leaf = ta.bvh2_child_node.shape[0], ta.bvh2_leaf_node.shape[0]
    assert (tpack.single_tree_table_bytes(n_inner, n_leaf, 8)
            > tpack.SINGLE_TREE_VMEM_BUDGET)
    assert ta.tre_child_node.shape == (1560, 64, 2)
    for name in TREELET_FIELDS:
        np.testing.assert_array_equal(getattr(ta, name),
                                      np.asarray(getattr(ja, name)), err_msg=name)
    assert 0 < ta.top_depth < walk.STACK_DEPTH
    assert 0 < ta.treelet_depth < walk.STACK_DEPTH
