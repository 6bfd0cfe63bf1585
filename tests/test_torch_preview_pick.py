"""The preview frame and picking against the JAX package: render_preview
(primary visibility through traverse_world, the editor shading) on the demo
scene at 48x32, and pick / pick_chunks (one brute-force ray over the world
soup) at hits and misses: the same instance and triangle, t within 1e-6
relative, a miss a miss."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rayzen_tpu import bigscene as jbig
from rayzen_tpu import config as jconfig
from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu import picking as jpicking
from rayzen_tpu.preview import render_preview as jpreview
from rayzen_tpu_torch import RenderConfig, bigscene, demo, pack_scene, picking
from rayzen_tpu_torch.preview import render_preview
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 48, 32


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    jscene = jdemo.build_demo_scene(W, H)
    jcfg = jconfig.RenderConfig(width=W, height=H,
                                cache_dir=str(tmp_path_factory.mktemp("blas")))
    scene = demo.build_demo_scene(W, H)
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    return dict(jscene=jscene, jcfg=jcfg, jarrays=jpack.pack_scene(jscene, jcfg),
                jcam={k: jnp.asarray(v)
                      for k, v in jscene.camera.device_params().items()},
                scene=scene, cfg=cfg, arrays=pack_scene(scene, cfg, "cpu"),
                cam=scene.camera.device_params())


def test_preview_matches_jax(scenes):
    """max abs <= 1e-5, mean abs <= 1e-6 (XLA fuses some products into
    multiply-adds)."""
    jcfg = scenes["jcfg"]
    ref = np.asarray(jax.jit(lambda a, c: jpreview(a, c, jcfg))(
        scenes["jarrays"], scenes["jcam"]))
    img = render_preview(scenes["arrays"], scenes["cam"], scenes["cfg"]).numpy()
    assert img.shape == (H, W, 3)
    d = np.abs(img - ref)
    assert d.max() <= 1e-5 and d.mean() <= 1e-6, (d.max(), d.mean())
    assert (img != render_preview(scenes["arrays"], scenes["cam"],
                                  scenes["cfg"].replace(ambient=(0.3,) * 3)).numpy()).any()


def assert_same_pick(ours, ref):
    if ref is None:
        assert ours is None
        return
    assert ours is not None
    assert (ours["instance"], ours["triangle"]) == (ref["instance"], ref["triangle"])
    assert ours.get("chunk") == ref.get("chunk")
    assert abs(ours["t"] - ref["t"]) <= 1e-6 * abs(ref["t"])
    np.testing.assert_allclose(ours["point"], np.asarray(ref["point"]), rtol=1e-6,
                               atol=1e-6)


PIXELS = [(24, 16), (10, 12), (40, 8), (2, 30)]


def test_pick_matches_jax(scenes):
    res = (W, H)
    hits = 0
    for xy in PIXELS:
        ref = jpicking.pick(scenes["jarrays"], scenes["jcam"], xy, res)
        ours = picking.pick(scenes["arrays"], scenes["cam"], xy, res)
        assert_same_pick(ours, ref)
        hits += ref is not None
    assert 0 < hits < len(PIXELS)  # hits and a miss (the sky)


def test_pick_chunks_matches_jax(scenes):
    """Across 3 chunks of the demo scene, the closest hit and its chunk."""
    jarrays = [jpack.pack_scene(s, scenes["jcfg"])
               for s in jbig.partition_scene(scenes["jscene"], max_tris=2000)]
    arrays = [pack_scene(s, scenes["cfg"], "cpu")
              for s in bigscene.partition_scene(scenes["scene"], max_tris=2000)]
    assert len(arrays) == len(jarrays) == 3
    chunks = set()
    for xy in PIXELS:
        ref = jpicking.pick_chunks(jarrays, scenes["jcam"], xy, (W, H))
        ours = picking.pick_chunks(arrays, scenes["cam"], xy, (W, H))
        assert_same_pick(ours, ref)
        chunks.add(None if ref is None else ref["chunk"])
    assert len(chunks) >= 2
