"""The split-bounce wavefront (K4) of the port against the JAX package: the
compaction permutation bit for bit. The split and octant paths' renders are
in test_torch_split_jax.py (against the JAX package), test_torch_split_k1.py
(the plain split against the plain K1) and test_torch_split_paths.py (the
continuation state and which configs take the split)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayzen_tpu.ops import megakernel as jmk
from rayzen_tpu_torch.ops import megakernel
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


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
    td, to, live = megakernel._compaction_permutation(
        torch.from_numpy(alive), *map(torch.from_numpy, d), mode,
        origins=tuple(map(torch.from_numpy, o)))
    for t, j in ((td, jd), (to, jo)):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (to.sort().values == torch.arange(n, dtype=torch.int32)).all()
    assert int(live) == int(alive.sum())
    assert alive[to[: int(live)].numpy()].all()  # the live rays first
