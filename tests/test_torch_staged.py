"""The staged kernels= variants of the per-wave path against the JAX
package's renders of the same config: "pallas-ml" (the plain K7 walks
against JAX's miss-link kernels in interpret mode) and "pallas-bvh2" (the
plain K2/K3 walks against JAX's BVH2 packet kernels), with equal ray
counts; and the bounce-ray reorderings (compact_rays, bounce_rebin), which
leave the frame as it is. Demo scene, 32x24, 3 bounces."""

import numpy as np
import pytest
import torch

from test_torch_wave import assert_matches, port_render, renders  # noqa: F401
from rayzen_tpu_torch.ops import walk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("kernels", ["pallas-ml", "pallas-bvh2"])
def test_staged_variant_matches_jax(renders, kernels, monkeypatch):
    """The variant's walks run (counted through their plain versions) and
    its frame matches JAX's."""
    jax, scene, cfg = renders
    kind = {"pallas-ml": "misslink", "pallas-bvh2": "bvh2"}[kernels]
    calls = {"closest": 0, "shadow": 0}
    plain_c, plain_s = walk._PLAIN_CLOSEST[kind], walk._PLAIN_SHADOW[kind]

    def closest(*a):
        calls["closest"] += 1
        return plain_c(*a)

    def shadow(*a):
        calls["shadow"] += 1
        return plain_s(*a)

    monkeypatch.setitem(walk._PLAIN_CLOSEST, kind, closest)
    monkeypatch.setitem(walk._PLAIN_SHADOW, kind, shadow)
    assert_matches(port_render(scene, cfg.replace(kernels=kernels)), jax(kernels))
    # one closest walk per live bounce wave (3 here), one shadow walk per light
    assert calls == {"closest": cfg.max_bounces, "shadow": 2}


@pytest.mark.parametrize("knob", ["compact_rays", "bounce_rebin"])
def test_bounce_reorderings_keep_the_frame(renders, knob):
    """compact_rays and bounce_rebin only permute the bounce rays around a
    kernel walk: the frame and the ray count are the plain staged path's,
    bit for bit, at 2 spp."""
    _jax, scene, cfg = renders
    cfg = cfg.replace(kernels="pallas-ml", spp=2, rng="threefry")
    base = port_render(scene, cfg)
    img, rays = port_render(scene, cfg.replace(**{knob: True}))
    np.testing.assert_array_equal(img, base[0])
    assert rays == base[1] and torch.isfinite(torch.from_numpy(img)).all()
