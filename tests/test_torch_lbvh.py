"""The port's LBVH build (accel/lbvh.py, torch on the CPU) against the JAX
package's jitted build_lbvh: every output bit for bit (order, left_first,
count, miss, bounds, the child pairs and the device-computed max_depth),
on random boxes and on the adversarial sets of tests/test_lbvh.py (a
chain of power-of-two coordinates, duplicate centroids, both mixed),
where the depth is also held to a host walk of the tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayzen_tpu.accel.lbvh import build_lbvh as jax_build_lbvh
from rayzen_tpu_torch.accel.lbvh import build_lbvh
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ADVERSARIAL = {
    "chain": [(2.0 ** k, 0.0, 0.0) for k in range(1, 11)],
    "duplicates": [(1.0, 1.0, 1.0)] * 200,
    "mixed": [(2.0 ** k, 0.0, 0.0) for k in range(1, 11)] + [(1.0, 1.0, 1.0)] * 64,
}


def assert_same_tree(bmin, bmax):
    """Both builds of the boxes, every output equal in value and dtype;
    returns the port's."""
    ref = jax.jit(jax_build_lbvh)(jnp.asarray(bmin), jnp.asarray(bmax))
    got = build_lbvh(torch.from_numpy(bmin), torch.from_numpy(bmax))
    assert set(got) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        g = got[k].numpy()
        assert g.dtype == v.dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    return got


def host_depth(out, n):
    left, right = out["left_child"].numpy(), out["right_child"].numpy()
    depth, stack = 0, [(0, 0)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        if node < n - 1:
            stack += [(int(left[node]), d + 1), (int(right[node]), d + 1)]
    return depth


@pytest.mark.parametrize("n", [2, 3, 17, 1000])
def test_random_boxes_match_jax(n):
    rng = np.random.RandomState(n)
    bmin = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0.01, 1.0, (n, 3)).astype(np.float32)
    got = assert_same_tree(bmin, bmax)
    assert sorted(got["order"].tolist()) == list(range(n))
    assert (got["miss"] > -2).all()  # every link resolved


@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_adversarial_sets_match_jax(name):
    c = np.asarray(ADVERSARIAL[name], np.float32)
    got = assert_same_tree(c - 0.01, c + 0.01)
    depth = int(got["max_depth"])
    assert depth == host_depth(got, len(c))
    assert depth <= 64
