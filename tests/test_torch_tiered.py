"""The port's tiered (treelet) view and its K8 walks against the JAX package:
the treelet pack bit for bit, the tiered refit tables, the plain K8 walks
against the plain whole-tree K2/K3 walks, the plain tiered K1 against the
JAX tiered megakernel (interpret mode), the pack-time choice on the
503k-triangle field, and the two stacks' depth checks."""

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


@pytest.mark.parametrize("tiered", ["on", "off"])
def test_treelet_pack_is_bitwise_jax(tiered, tmp_path):
    ja, ta = _packs(tiered, tmp_path)
    for name in TREELET_FIELDS:
        jv, tv = np.asarray(getattr(ja, name)), getattr(ta, name)
        assert tv.dtype == jv.dtype and tv.shape == jv.shape, name
        np.testing.assert_array_equal(tv, jv, err_msg=name)
    if tiered == "off":  # the 1-row dummies mark the view absent
        assert ta.tre_child_node.shape == (1, 1, 2)
        assert ta.top_child_count[0, 0] == 0
    else:
        assert ta.tre_child_node.shape[0] >= 2 and ta.tre_child_node.shape[1] == 8
        assert (ta.top_child_count == -2).any()


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


def _deep_treelet_world(n_rows, treelet_depth=None, ladder=False):
    """A tiered view whose one treelet is n_rows inner rows deep, above an
    opaque triangle at z = 5. A chain (left child that leaf, right child the
    next row) keeps the walk's stack at one entry; a ladder (both children
    the next row) grows it by one per row. ``treelet_depth``: the depth
    bound the walks are given (default: the one computed from the tables)."""
    top = np.zeros((1, 16), np.float32)
    top[0, 0:3], top[0, 3:6] = -1e9, 1e9  # left child: treelet 0
    top[0, 6:9], top[0, 9:12] = 3.4e38, -3.4e38  # right: inverted padding
    top[0, 12:16] = [0, 0, -2, 0]
    tre = np.zeros((1, n_rows, 16), np.float32)
    tre[0, :, 0:3] = tre[0, :, 6:9] = -1e9
    tre[0, :, 3:6] = tre[0, :, 9:12] = 1e9
    tre[0, :, 13], tre[0, :, 15] = np.arange(1, n_rows + 1), -1
    if ladder:
        tre[0, :, 12], tre[0, :, 14] = np.arange(1, n_rows + 1), -1
    else:
        tre[0, :, 12], tre[0, :, 14] = 0, 1
    tre[0, -1, 12:16] = [0, 0, 1, 1]
    leaf = np.zeros((1, 1, 16), np.float32)  # leaf_k 1: tri transp first count mat
    leaf[0, 0, 0:9] = [-100, -100, 5, 200, 0, 0, 100, 200, 0]
    leaf[0, 0, 11], leaf[0, 0, 12] = 1.0, 1.0
    top_depth, depth = tpack.tiered_depths(
        top[:, 12:14].astype(np.int32), top[:, 14:16].astype(np.int32),
        tre[..., 12:14].astype(np.int32), tre[..., 14:16].astype(np.int32))
    assert depth == n_rows and top_depth == 1
    z = torch.zeros(1, 3)
    return tpack.WorldArrays(
        tri_v0=z, tri_e1=z, tri_e2=z, tri_mat=torch.zeros(1, dtype=torch.int32),
        tri_inst=torch.zeros(1, dtype=torch.int32), tri_nsign=torch.ones(1),
        inner_table=torch.from_numpy(tre[0]), leaf_table=torch.from_numpy(leaf[0]),
        materials=torch.zeros(1, 8), lights=torch.zeros(0, 8), leaf_k=1,
        top_table=torch.from_numpy(top), tre_inner=torch.from_numpy(tre),
        tre_leaf=torch.from_numpy(leaf), tiered=True, top_depth=top_depth,
        treelet_depth=depth if treelet_depth is None else treelet_depth,
    )


def _z_rays(n=16):
    d = torch.zeros(n, 3)
    d[:, 2] = 1.0
    return torch.zeros(n, 3), d, torch.ones(n, dtype=torch.bool)


def test_treelet_deeper_than_stack_is_refused():
    ws = _deep_treelet_world(walk.STACK_DEPTH)  # depth 64 needs 65 entries
    o, d, a = _z_rays()
    with pytest.raises(ValueError, match="treelet depth 64 needs 65 stack"):
        walk.closest_walk_tiered(ws, o, d, a)
    with pytest.raises(ValueError, match="stack"):
        walk.shadow_walk_tiered(ws, o, d, 50.0, a)
    with pytest.raises(ValueError, match="stack"):
        megakernel.sample_wave_reference(
            ws, tconfig.RenderConfig(width=4, height=4), torch.zeros(16, 2), a,
            tdemo.build_small_scene(4, 4).camera.device_params(), 0, 0, 1)


@pytest.mark.parametrize("ladder", [True, False])
def test_treelet_stack_overflow_poisons_unknown_depth(ladder):
    """With the depth bound unknown (0) the walks run: an 80-row ladder
    overflows the treelet walk's stack and NaN-poisons the result; an 80-row
    chain fits and stays clean."""
    ws = _deep_treelet_world(80, treelet_depth=0, ladder=ladder)
    o, d, a = _z_rays()
    t, tri, _cross, menc = walk.closest_walk_tiered(ws, o, d, a)
    vis, _ = walk.shadow_walk_tiered(ws, o, d, 50.0, a)
    if ladder:
        assert torch.isnan(t).all() and torch.isnan(menc).all()
        assert torch.isnan(vis).all()
    else:
        assert (t == 5.0).all() and (tri == 0).all() and (vis == 0.0).all()


def test_tiered_walks_need_the_treelet_view(tmp_path):
    _ja, ta = _packs("off", tmp_path)
    ws = tpack.world_geometry(ta.to("cpu"))
    assert not ws.tiered
    with pytest.raises(ValueError, match="treelet view"):
        walk.closest_walk_tiered(ws, *_z_rays())
