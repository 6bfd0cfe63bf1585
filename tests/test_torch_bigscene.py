"""The chunked large-scene path (bigscene.py) against the JAX package:
split_mesh and partition_scene cut the same chunks with the same
origin_indices; merge_hits; render_radiance_chunked's frame (the plain
K2/K3 with the best t carried across chunks, and the portable walks, at 2
spp on progressive key 1) against JAX's chunked frame within the golden
bars, with equal ray counts; and the Renderer's chunked path.
JAX's side walks its chunks with its XLA walks (kernels="xla"), jitted as
its Renderer runs it: its BVH2 packet kernels find the same hits
(tests/test_bigscene.py) and take minutes in interpret mode. Demo scene, 32x24, 2 bounces, 3 chunks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayzen_tpu import bigscene as jbig
from rayzen_tpu import config as jconfig
from rayzen_tpu import demo as jdemo
from rayzen_tpu import packing as jpack
from rayzen_tpu.ops.traverse import Hit as JHit
from rayzen_tpu_torch import RenderConfig, bigscene, demo, pack_scene
from rayzen_tpu_torch.image_io import ssim
from rayzen_tpu_torch.ops.walk import Hit
from rayzen_tpu_torch.renderer import Renderer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H, MB = 32, 24, 2
CHUNK = 2000  # the demo's 4,852 world triangles -> 3 chunks


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    """Both packages' chunk scenes and packs of the demo scene, and
    jax(spp, key) -> JAX's chunked (image, rays) with its XLA walks,
    memoised."""
    jpack._blas_cache.clear()  # keyed by id(mesh): start from an empty memo
    jscene = jdemo.build_demo_scene(W, H)
    jcfg = jconfig.RenderConfig(width=W, height=H, spp=1, max_bounces=MB,
                                tiered="off", chunk_tris=CHUNK,
                                cache_dir=str(tmp_path_factory.mktemp("blas")))
    jchunks = jbig.partition_scene(jscene, max_tris=CHUNK)
    jarrays = [jpack.pack_scene(s, jcfg) for s in jchunks]
    jcam = {k: jnp.asarray(v) for k, v in jscene.camera.device_params().items()}
    memo = {}

    def ref(spp=1, key=0):
        if (spp, key) not in memo:
            jcfg_ = jcfg.replace(kernels="xla", spp=spp)
            img, rays = jax.jit(lambda a, c: jbig.render_radiance_chunked(
                a, c, jcfg_, rng_key=key, with_stats=True))(tuple(jarrays), jcam)
            memo[spp, key] = np.asarray(img), int(rays)
        return memo[spp, key]

    scene = demo.build_demo_scene(W, H)
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    chunks = bigscene.partition_scene(scene, max_tris=CHUNK)
    arrays = [pack_scene(s, cfg, "cpu") for s in chunks]
    return dict(jax=ref, jscene=jscene, jchunks=jchunks, scene=scene, cfg=cfg,
                chunks=chunks, arrays=arrays)


def _objects(chunk):
    return [(go.mesh.num_triangles, go.mesh.vertices.tobytes(),
             np.asarray(go.transform).tobytes(), go.material_override)
            for go in chunk.game_objects]


@pytest.mark.parametrize("max_tris", [CHUNK, 500])
def test_partition_matches_jax(chunked, max_tris):
    """The same chunks, in the same order, with the same instances (split
    Suzannes at 500) and origin_indices."""
    ours = bigscene.partition_scene(chunked["scene"], max_tris=max_tris)
    ref = jbig.partition_scene(chunked["jscene"], max_tris=max_tris)
    assert len(ours) == len(ref) >= 3
    for a, b in zip(ours, ref):
        assert _objects(a) == _objects(b)
        np.testing.assert_array_equal(a.origin_indices, b.origin_indices)
        assert a.num_triangles <= max_tris


def test_split_mesh_matches_jax(chunked):
    mesh = chunked["scene"].game_objects[1].mesh
    jmesh = chunked["jscene"].game_objects[1].mesh
    ours, ref = bigscene.split_mesh(mesh, 300), jbig.split_mesh(jmesh, 300)
    assert len(ours) == len(ref) == -(-mesh.num_triangles // 300)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.material_index, b.material_index)


def test_merge_hits_matches_jax():
    rng = np.random.RandomState(3)
    n = 64

    def hits():
        found = rng.rand(n) < 0.6
        t = np.where(found, rng.uniform(0.1, 9.0, n), 1e30).astype(np.float32)
        tri = np.where(found, rng.randint(0, 100, n), -1).astype(np.int32)
        return dict(t=t, point=rng.randn(n, 3).astype(np.float32), tri=tri,
                    inst=tri // 10, found=found,
                    normal=rng.randn(n, 3).astype(np.float32),
                    mat=np.where(found, tri % 3, -1).astype(np.int32))

    a, b = hits(), hits()
    ref = jbig.merge_hits(JHit(**{k: jnp.asarray(v) for k, v in a.items()}),
                          JHit(**{k: jnp.asarray(v) for k, v in b.items()}))

    def port(h):
        return Hit(**{k: torch.from_numpy(v) for k, v in h.items()},
                   cross=torch.zeros(n, 3), menc=torch.zeros(n))

    ours = bigscene.merge_hits(port(a), port(b))
    for k in a:
        np.testing.assert_array_equal(getattr(ours, k).numpy(),
                                      np.asarray(getattr(ref, k)))


@pytest.mark.parametrize("kernels", ["auto", "xla"])
def test_chunked_frame_matches_jax(chunked, kernels, spp=2, key=1):
    """The golden bars against JAX's chunked frame and equal ray counts
    (int64 here); the frame is that of JAX but for float32 rounding."""
    jimg, jrays = chunked["jax"](spp, key)
    img, rays = bigscene.render_radiance_chunked(
        chunked["arrays"], chunked["scene"].camera.device_params(),
        chunked["cfg"].replace(kernels=kernels, spp=spp), rng_key=key,
        with_stats=True)
    assert rays.dtype == torch.int64 and int(rays) == jrays
    img = img.numpy()
    d = np.abs(img - jimg)
    assert ssim(img, jimg) >= 0.995 and d.mean() < 2e-3, (ssim(img, jimg), d.mean())
    assert d.max() <= 1e-4, d.max()


def test_renderer_chunked_path(chunked):
    """The Renderer chunks the scene past chunk_tris with tiered="off", its
    frames are render_radiance_chunked's bit for bit, and update_transforms
    routes each chunk's transforms through its origin_indices."""
    cfg = chunked["cfg"].replace(auto_refresh_drift=0.0)
    scene = demo.build_demo_scene(W, H)
    r = Renderer(scene, cfg, use_cache=False, async_compile=False, device="cpu")
    assert r.arrays_list is not None and len(r.arrays_list) == 3
    r.render_frame()  # frame 0: the first-frame budget
    frame = r.render_frame()
    ref, _ = bigscene.render_radiance_chunked(
        r.arrays_list, scene.camera.device_params(), cfg, with_stats=True)
    np.testing.assert_array_equal(frame, ref.numpy())
    t = scene.transforms().copy()
    t[:, 1, 3] += 0.25
    r.update_transforms(t)
    for a, s in zip(r.arrays_list, r._chunk_scenes):
        np.testing.assert_array_equal(a.transforms.numpy(), t[s.origin_indices])
    assert not np.array_equal(r.render_frame(), frame)
