"""Which configurations the port's entry points take: every kernels= value
and tracer the JAX package has, the split, octant, wide, frustum, tiered
and packet-only knobs. The renders of the slice end to end are in
test_torch_render_golden.py."""

import pytest

from rayzen_tpu_torch import RenderConfig
from rayzen_tpu_torch.integrator import check_config
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("knob,tracer", [
    (dict(kernels="pallas-frustum"), "bvh"), (dict(), "oracle"),
])
def test_unimplemented_knobs_raise(knob, tracer):
    with pytest.raises(NotImplementedError):
        check_config(RenderConfig(**knob), tracer)


@pytest.mark.parametrize("knob,tracer", [
    (dict(split_bounce=2), "bvh"), (dict(octant_bounce_walks=True), "bvh"),
    (dict(split_bounce=2, split_rebin="octcell", split_every=True,
          octant_bounce_walks=True), "bvh"),
    (dict(wide_nodes=True), "bvh"), (dict(frustum_primary=True), "bvh"),
    (dict(walk_pop=2), "bvh"), (dict(sample_fuse=2), "bvh"),
    (dict(kernels="auto"), "bvh"), (dict(kernels="pallas"), "bvh"),
    (dict(kernels="pallas-ml"), "bvh"), (dict(kernels="pallas-bvh2"), "bvh"),
    (dict(kernels="pallas-nomega"), "bvh"), (dict(kernels="xla"), "bvh"),
    (dict(), "brute"),
])
def test_check_config_accepts_split_octant_wide_and_frustum(knob, tracer):
    check_config(RenderConfig(**knob), tracer)


@pytest.mark.parametrize("tiered", ["on", "auto", "off"])
def test_check_config_accepts_tiered(tiered):
    check_config(RenderConfig(tiered=tiered))


def test_packet_only_knobs_are_accepted():
    check_config(RenderConfig(packet_tile=32, dense_leaves=True, dual_pop=True))
