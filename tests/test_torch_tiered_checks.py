"""The port's tiered (treelet) view, cheap checks against the JAX package:
the treelet pack bit for bit, with the view and without it, and the one
stack of the K8 walks (top-tree and treelet entries together, 2 x
STACK_DEPTH): a view that needs one entry more than it holds is refused, a
view that needs all of it is walked, one of unknown depth that overflows
NaN-poisons the result, and the walks refuse a scene packed without the
view."""

import numpy as np
import pytest
import torch

from test_torch_tiered import TREELET_FIELDS, _packs
from rayzen_tpu_torch import config as tconfig
from rayzen_tpu_torch import demo as tdemo
from rayzen_tpu_torch import packing as tpack
from rayzen_tpu_torch.ops import megakernel, walk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


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


def _deep_treelet_world(n_rows, treelet_depth=None, ladder=False, comb=False):
    """A tiered view whose one treelet is n_rows inner rows deep, above an
    opaque triangle at z = 5. A chain (left child that leaf, right child the
    next row) keeps the walk's stack at one entry; a ladder (both children
    the next row) grows it by one per row; a comb (left child the next row,
    right child a row whose boxes nothing hits) too, in linear time, and
    both top children are the treelet, so the right one's root waits below
    it: the walk needs top depth + treelet depth entries exactly.
    ``treelet_depth``: the depth bound the walks are given (default: the one
    computed from the tables)."""
    top = np.zeros((1, 16), np.float32)
    top[0, 0:3], top[0, 3:6] = -1e9, 1e9  # left child: treelet 0
    top[0, 6:9], top[0, 9:12] = 3.4e38, -3.4e38  # right: inverted padding
    top[0, 12:16] = [0, 0, -2, 0]
    tre = np.zeros((1, n_rows + comb, 16), np.float32)
    tre[0, :, 0:3] = tre[0, :, 6:9] = -1e9
    tre[0, :, 3:6] = tre[0, :, 9:12] = 1e9
    tre[0, :, 13], tre[0, :, 15] = np.arange(1, n_rows + 1 + comb), -1
    if ladder:
        tre[0, :, 12], tre[0, :, 14] = np.arange(1, n_rows + 1 + comb), -1
    else:
        tre[0, :, 12], tre[0, :, 14] = 0, 1
    if comb:  # the right children: row n_rows, whose boxes are inverted
        top[0, 6:9], top[0, 9:12], top[0, 15] = -1e9, 1e9, -2
        tre[0, :, 12], tre[0, :, 13], tre[0, :, 14] = (
            np.arange(1, n_rows + 2), n_rows, -1)
        tre[0, n_rows, 0:3] = tre[0, n_rows, 6:9] = 3.4e38
        tre[0, n_rows, 3:6] = tre[0, n_rows, 9:12] = -3.4e38
        tre[0, n_rows, 12:16] = [0, 0, 0, 0]
    tre[0, n_rows - 1, 12:16] = [0, 0, 1, 1]
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
    # top depth 1 + treelet depth 128 needs 129 entries of the 128
    ws = _deep_treelet_world(2 * walk.STACK_DEPTH)
    o, d, a = _z_rays()
    with pytest.raises(ValueError, match="treelet depth 128 need 129 stack"):
        walk.closest_walk_tiered(ws, o, d, a)
    with pytest.raises(ValueError, match="stack"):
        walk.shadow_walk_tiered(ws, o, d, 50.0, a)
    with pytest.raises(ValueError, match="stack"):
        megakernel.sample_wave_reference(
            ws, tconfig.RenderConfig(width=4, height=4), torch.zeros(16, 2), a,
            tdemo.build_small_scene(4, 4).camera.device_params(), 0, 0, 1)


@pytest.mark.parametrize("ladder", [True, False])
def test_treelet_stack_overflow_poisons_unknown_depth(ladder):
    """With the depth bound unknown (0) the walks run: a 144-row ladder
    overflows the walks' stack and NaN-poisons the result; a 144-row chain
    fits and stays clean."""
    ws = _deep_treelet_world(2 * walk.STACK_DEPTH + 16, treelet_depth=0,
                             ladder=ladder)
    o, d, a = _z_rays()
    t, tri, _cross, menc = walk.closest_walk_tiered(ws, o, d, a)
    vis, _ = walk.shadow_walk_tiered(ws, o, d, 50.0, a)
    if ladder:
        assert torch.isnan(t).all() and torch.isnan(menc).all()
        assert torch.isnan(vis).all()
    else:
        assert (t == 5.0).all() and (tri == 0).all() and (vis == 0.0).all()


def test_tiered_stack_need_at_its_bound():
    """The one stack at its bound: a comb treelet of 127 rows under a top
    node whose both children are it needs 1 + 127 = 128 entries, all the
    stack holds, and is walked clean (closest and shadow); at 128 rows it
    needs one more and is refused; with that depth unknown the walks run and
    NaN-poison every ray."""
    cap = 2 * walk.STACK_DEPTH
    o, d, a = _z_rays()
    fits = _deep_treelet_world(cap - 1, comb=True)
    assert walk.tiered_stack_need(fits.top_depth, fits.treelet_depth) == cap
    t, tri, _cross, menc = walk.closest_walk_tiered(fits, o, d, a)
    vis, _ = walk.shadow_walk_tiered(fits, o, d, 50.0, a)
    assert (t == 5.0).all() and (tri == 0).all() and (vis == 0.0).all()
    over = _deep_treelet_world(cap, comb=True)
    with pytest.raises(ValueError, match=f"need {cap + 1} stack entries"):
        walk.closest_walk_tiered(over, o, d, a)
    unknown = _deep_treelet_world(cap, treelet_depth=0, comb=True)
    t, tri, _cross, menc = walk.closest_walk_tiered(unknown, o, d, a)
    vis, _ = walk.shadow_walk_tiered(unknown, o, d, 50.0, a)
    assert torch.isnan(t).all() and torch.isnan(menc).all()
    assert torch.isnan(vis).all()


def test_tiered_walks_need_the_treelet_view(tmp_path):
    _ja, ta = _packs("off", tmp_path)
    ws = tpack.world_geometry(ta.to("cpu"))
    assert not ws.tiered
    with pytest.raises(ValueError, match="treelet view"):
        walk.closest_walk_tiered(ws, *_z_rays())
