"""Port packing vs the JAX package: pack_scene_host tables, the world_geometry
refit and the convert.py round trip, on the same scenes."""

import dataclasses

import numpy as np
import pytest
import torch

from rayzen_tpu import config as jconfig
from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu import transforms as jtf
from rayzen_tpu.scene import GameObject as JGameObject
from rayzen_tpu_torch import config as tconfig
from rayzen_tpu_torch import convert
from rayzen_tpu_torch import demo as tdemo
from rayzen_tpu_torch import packing as tpack
from rayzen_tpu_torch import transforms as ttf
from rayzen_tpu_torch.scene import GameObject as TGameObject
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 64, 48


def _scenes(kind):
    """The same scene built by both packages."""
    if kind == "demo":
        return jdemo.build_demo_scene(W, H), tdemo.build_demo_scene(W, H)
    js, ts = jdemo.build_small_scene(W, H), tdemo.build_small_scene(W, H)
    if kind == "mirror":  # a negative-determinant instance of the ball mesh
        for s, tf, go in ((js, jtf, JGameObject), (ts, ttf, TGameObject)):
            m = tf.translate(tf.scale(tf.identity(), (-1.0, 1.0, 1.0)), (0.5, 1.0, -1.5))
            s.game_objects.append(go(s.game_objects[1].mesh, m, "mirrored"))
    return js, ts


def _configs(tmp_path):
    # the JAX pack caches BLAS builds on disk (keep that inside tmp_path) and
    # in a memo keyed by id(mesh), which a mesh of an earlier test's scene
    # can hand down to a new one: start each test from an empty memo
    jpack._blas_cache.clear()
    return (jconfig.RenderConfig(width=W, height=H, cache_dir=str(tmp_path)),
            tconfig.RenderConfig(width=W, height=H))


@pytest.mark.parametrize("kind", ["small", "demo", "mirror"])
def test_pack_scene_host_matches_jax(kind, tmp_path):
    js, ts = _scenes(kind)
    jcfg, tcfg = _configs(tmp_path)
    ja = jpack.pack_scene_host(js, jcfg)
    ta = tpack.pack_scene_host(ts, tcfg)
    for name in tpack._SCENE_ARRAY_FIELDS:
        jv, tv = np.asarray(getattr(ja, name)), getattr(ta, name)
        assert tv.dtype == jv.dtype and tv.shape == jv.shape, name
        if name == "inv_transforms":  # computed, not copied
            np.testing.assert_allclose(tv, jv, rtol=1e-6, err_msg=name)
        else:  # integer tables and copied float leaves: bitwise
            np.testing.assert_array_equal(tv, jv, err_msg=name)
    assert ta.tree_depth == ja.tree_depth
    assert [dataclasses.astuple(m) for m in ta.instance_meta] == [
        dataclasses.astuple(m) for m in ja.instance_meta
    ]


def _leaf_columns(leaf_k, width):
    """(float columns, int-coded columns) of a leaf_table row."""
    K = leaf_k
    floats = list(range(0, 10 * K))  # K triangles x 9, K transparencies
    ints = [c for c in range(width) if c not in floats]  # first, count, mats, pad
    return floats, ints


@pytest.mark.parametrize("kind", ["demo", "mirror"])
def test_world_geometry_matches_jax(kind, tmp_path):
    js, ts = _scenes(kind)
    jcfg, tcfg = _configs(tmp_path)
    jw = jpack.world_geometry(jpack.pack_scene(js, jcfg))
    tw = tpack.world_geometry(tpack.pack_scene(ts, tcfg, "cpu"))
    t = lambda x: x.numpy()  # noqa: E731

    ji, ti = np.asarray(jw.inner_table), t(tw.inner_table)
    assert ti.shape == ji.shape == (ji.shape[0], 16)
    np.testing.assert_array_equal(ti[:, 12:], ji[:, 12:])  # refs, counts
    np.testing.assert_allclose(ti[:, :12], ji[:, :12], rtol=1e-6, atol=0)

    jl, tl = np.asarray(jw.leaf_table), t(tw.leaf_table)
    assert tl.shape == jl.shape and tw.leaf_k == jw.leaf_k == 8
    assert tl.shape[1] == 96  # 11 * 8 + 2 = 90 columns, padded to 96
    floats, ints = _leaf_columns(tw.leaf_k, tl.shape[1])
    np.testing.assert_array_equal(tl[:, ints], jl[:, ints])
    np.testing.assert_allclose(tl[:, floats], jl[:, floats], rtol=1e-6, atol=0)

    for name in ("tri_v0", "tri_e1", "tri_e2"):
        np.testing.assert_allclose(
            t(getattr(tw, name)), np.asarray(getattr(jw, name)), rtol=1e-6,
            atol=0, err_msg=name,
        )
    for name in ("tri_mat", "tri_inst", "tri_nsign", "materials", "lights"):
        np.testing.assert_array_equal(
            t(getattr(tw, name)), np.asarray(getattr(jw, name)), err_msg=name
        )
    assert tw.tree_depth == jw.tree_depth
    if kind == "mirror":
        nsign = t(tw.tri_nsign)
        assert (nsign == -1.0).any() and (nsign == 1.0).any()
        # the mirrored instance's materials are encoded with a negative sign
        assert (tl[:, 10 * 8 + 2:10 * 8 + 2 + 8] < 0).any()


def test_records_match_jax(tmp_path):
    """The miss-link records (K7's and the portable walks' table): bounds
    and triangles to rtol 1e-6 as the other refit tables, the float-encoded
    meta, transparency and material columns and the padding bitwise."""
    for kind in ("small", "demo"):
        js, ts = _scenes(kind)
        jcfg, tcfg = _configs(tmp_path)
        jr = np.asarray(jpack.world_geometry(jpack.pack_scene(js, jcfg)).records)
        tr = tpack.world_geometry(tpack.pack_scene(ts, tcfg, "cpu")).records.numpy()
        K = 8
        assert tr.dtype == jr.dtype == np.float32
        assert tr.shape == jr.shape and tr.shape[1] == 104, kind  # 97 padded
        if kind == "demo":
            assert tr.shape[0] == 1691
        floats = list(range(0, 6)) + list(range(9, 9 + 9 * K))
        exact = [c for c in range(tr.shape[1]) if c not in floats]
        np.testing.assert_array_equal(tr[:, exact], jr[:, exact], err_msg=kind)
        np.testing.assert_allclose(tr[:, floats], jr[:, floats], rtol=1e-6,
                                   atol=0, err_msg=kind)
        assert (tr[:, 7] == -1).any() and (tr[:, 7] >= 1).any()  # inner, leaf


def _jax_leaves(x):
    return {f.name: (getattr(x, f.name) if f.metadata.get("static")
                     else np.asarray(getattr(x, f.name)))
            for f in dataclasses.fields(x)}


def test_convert_round_trip(tmp_path):
    js, _ = _scenes("demo")
    jcfg, _ = _configs(tmp_path)
    ja = jpack.pack_scene_host(js, jcfg)
    jw = jpack.world_geometry(jpack.pack_scene(js, jcfg))

    jd = _jax_leaves(ja)
    sa = convert.scene_arrays_from_numpy(jd, "cpu")
    assert isinstance(sa.tri_v0, torch.Tensor)
    back = convert.to_numpy(sa)
    for name in tpack._SCENE_ARRAY_FIELDS:
        np.testing.assert_array_equal(back[name], jd[name], err_msg=name)
        assert back[name].dtype == jd[name].dtype, name
    assert back["tree_depth"] == ja.tree_depth
    assert len(back["instance_meta"]) == len(ja.instance_meta)

    wd = _jax_leaves(jw)
    wa = convert.world_arrays_from_numpy(wd, "cpu")
    back = convert.to_numpy(wa)
    # the treelet tables come across without JAX's 128-lane padding, and the
    # tiered and wide walks' depth bounds and K7's device tables, which JAX
    # does not keep, are computed (tests/test_torch_misslink_layout.py holds
    # K7's tables to the records)
    w2 = wd["leaf_table"].shape[1]
    expect = {**wd, "tre_inner": wd["tre_inner"][..., :16],
              "tre_leaf": wd["tre_leaf"][..., :w2], "top_depth": wa.top_depth,
              "treelet_depth": wa.treelet_depth, "wide_depth": wa.wide_depth,
              "wide_stack": wa.wide_stack, "ml_nodes": wa.ml_nodes.numpy(),
              "ml_tris": wa.ml_tris.numpy()}
    assert not wa.tiered and wa.top_depth == 1
    assert (wa.wide_depth, wa.wide_stack) == (sa.wide_depth, sa.wide_stack)
    for f in dataclasses.fields(tpack.WorldArrays):
        np.testing.assert_array_equal(back[f.name], expect[f.name], err_msg=f.name)
    # the converted JAX tables equal the port's own refit of the same scene
    tw = tpack.world_geometry(sa)
    np.testing.assert_allclose(tw.inner_table.numpy(), wd["inner_table"], rtol=1e-6)
    np.testing.assert_allclose(tw.leaf_table.numpy(), wd["leaf_table"], rtol=1e-6)
