"""The stack guard of the port's K2/K3 walks: on the ladder and chain trees
of test_pallas.TestMultiPopOverflowPoison a walk whose stack would
overflow NaN-poisons its result without writing past the stack, a fitting
walk stays clean, and a tree known to be too deep is refused."""

import numpy as np
import pytest
import torch

from rayzen_tpu_torch.ops import walk
from rayzen_tpu_torch.packing import WorldArrays
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


class TestStackOverflowPoison:
    """The ladder and chain trees of test_pallas.TestMultiPopOverflowPoison:
    a walk whose stack would overflow must not write past it and must
    NaN-poison its result; a fitting walk stays clean."""

    def _leaf_table(self):
        row = np.zeros(16, np.float32)  # leaf_k 1: tri(9) transp first count mat
        row[0:9] = [-100, -100, 5, 200, 0, 0, 100, 200, 0]
        row[11] = 1.0  # count
        row[12] = 1.0  # material 0, encoded
        return torch.from_numpy(row[None, :])

    def _tree(self, n, chain=False):
        t = np.zeros((n, 16), np.float32)
        t[:, 0:3] = t[:, 6:9] = -1e9
        t[:, 3:6] = t[:, 9:12] = 1e9
        for i in range(n - 1):
            t[i, 12], t[i, 14] = (0, 1) if chain else (i + 1, -1)
            t[i, 13], t[i, 15] = i + 1, -1
        t[n - 1, 12:16] = [0, 0, 1, 1]
        z = torch.zeros(1, 3)
        return WorldArrays(
            tri_v0=z, tri_e1=z, tri_e2=z,
            tri_mat=torch.zeros(1, dtype=torch.int32),
            tri_inst=torch.zeros(1, dtype=torch.int32),
            tri_nsign=torch.ones(1), inner_table=torch.from_numpy(t),
            leaf_table=self._leaf_table(), materials=torch.zeros(1, 8),
            lights=torch.zeros(0, 8), leaf_k=1, tree_depth=0,
        )

    def _rays(self, n=64):
        o = torch.zeros(n, 3)
        d = torch.zeros(n, 3)
        d[:, 2] = 1.0
        return o, d, torch.ones(n, dtype=torch.bool)

    def test_closest_overflow_poisons_nan(self):
        t, _tri, _cross, menc = walk.closest_walk(self._tree(300), *self._rays())
        assert torch.isnan(t).all() and torch.isnan(menc).all()

    def test_closest_fitting_walk_stays_clean(self):
        t, tri, _cross, menc = walk.closest_walk(self._tree(40, chain=True), *self._rays())
        assert (t == 5.0).all() and (tri == 0).all() and (menc == 1.0).all()

    def test_shadow_overflow_poisons_nan(self):
        o, d, a = self._rays()
        vis, _ = walk.shadow_walk_bvh2(self._tree(300), o, d, 50.0, a)
        assert torch.isnan(vis).all()

    def test_shadow_fitting_walk_stays_clean(self):
        o, d, a = self._rays()
        vis, _ = walk.shadow_walk_bvh2(self._tree(40, chain=True), o, d, 50.0, a)
        assert (vis == 0.0).all()  # opaque blocker at z=5 within maxd=50

    def test_known_deep_tree_is_refused(self):
        ws = self._tree(40, chain=True)
        ws.tree_depth = walk.STACK_DEPTH
        with pytest.raises(ValueError, match="stack"):
            walk.closest_walk(ws, *self._rays())
