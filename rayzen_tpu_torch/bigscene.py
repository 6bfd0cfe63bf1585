"""Large scenes as chunked trees: a scene split into chunks, each with its
own unified world-space BVH, walked one after the other per wave.

Port of rayzen_tpu/bigscene.py. The JAX package chunks scenes whose tables
would not fit a TPU core's VMEM; the H100 holds any single tree, so the port
keeps this path for parity with ``chunk_tris`` configs and with the
Renderer's rule (``tiered="off"`` past the chunk budget).

Partitioning (host, numpy, copied): whole instances are packed greedily in
Morton order of their origins; a mesh too large for one chunk is split into
Morton-ordered triangle runs that share the owner's transform. Lights,
materials and the camera go into every chunk, and the chunks are sorted
near to far from the camera.

Rendering: the per-wave path (integrator.trace_wave) with chunked walks.
The closest walk is K2 (walk.closest_hit_bvh2) over each chunk in turn
with the best t so far as its ``t_init``, so a farther chunk prunes against
the hits found in nearer ones, the hits merged elementwise; the shadow walk
is K3 (walk.shadow_walk_bvh2) with the transmissions multiplied and the
rays already at or below the visibility floor left out of later chunks.
With ``kernels="xla"`` the portable walks (ops/traverse.py) take their
place. On CPU tensors K2/K3 run their plain versions. JAX's pixel swizzle
and packet devices have no per-thread meaning: the wave is the pixel grid,
as in integrator.render_rays, and samples are keyed as there
(``integrator._sample_index``). Ray counts are int64.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from . import logging_util as log
from .config import RenderConfig
from .mesh import Mesh
from .ops import camera_rays, walk
from .ops.traverse import shadow_walk, traverse_world
from .packing import SINGLE_TREE_VMEM_BUDGET, world_geometry
from .scene import GameObject, Scene

# Per-chunk world-triangle budget: JAX's, derived from its single-tree VMEM
# table budget at ~80 bytes of tables per world triangle and capped at the
# table size its probe validated (37.3 MB), so both packages cut a scene
# into the same chunks.
_PROBE_VALIDATED_TABLE_BYTES = int(37.3 * 2**20)
DEFAULT_CHUNK_TRIS = min(SINGLE_TREE_VMEM_BUDGET,
                         _PROBE_VALIDATED_TABLE_BYTES) // 80


def _morton3(cent: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for (T, 3) centroids (host, numpy)."""
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = np.clip(((cent - lo) / span) * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return (
        (spread(q[:, 0]) << np.uint64(2))
        | (spread(q[:, 1]) << np.uint64(1))
        | spread(q[:, 2])
    )


def split_mesh(mesh: Mesh, max_tris: int) -> List[Mesh]:
    """Split an oversized mesh into Morton-ordered triangle runs — each run is
    spatially compact, so per-run BVH quality stays close to the whole-mesh
    build."""
    t = mesh.num_triangles
    if t <= max_tris:
        return [mesh]
    order = np.argsort(_morton3(mesh.vertices.mean(axis=1)), kind="stable")
    parts = []
    for s in range(0, t, max_tris):
        idx = order[s : s + max_tris]
        parts.append(
            Mesh(
                vertices=mesh.vertices[idx],
                material_index=mesh.material_index[idx],
            )
        )
    return parts


def partition_scene(
    scene: Scene, max_tris: int = DEFAULT_CHUNK_TRIS
) -> List[Scene]:
    """Partition into chunk scenes of <= max_tris *world* (instanced)
    triangles each. Returns [scene] unchanged when it already fits. Each
    chunk scene has ``origin_indices``: the index in scene.game_objects of
    each of its instances (split-mesh parts repeat their owner's)."""
    total = sum(go.mesh.num_triangles for go in scene.game_objects)
    if total <= max_tris:
        return [scene]

    # explode oversized meshes once (shared across their instances); each
    # exploded object remembers which original scene.game_objects index it
    # came from so transform updates can be routed back (origin_indices below)
    split_cache: dict = {}
    exploded: List[GameObject] = []
    exploded_origin: List[int] = []
    for oi, go in enumerate(scene.game_objects):
        if go.mesh.num_triangles > max_tris:
            if id(go.mesh) not in split_cache:
                split_cache[id(go.mesh)] = split_mesh(go.mesh, max_tris)
            for part in split_cache[id(go.mesh)]:
                exploded.append(
                    GameObject(
                        mesh=part, transform=go.transform, name=go.name,
                        material_override=go.material_override,
                    )
                )
                exploded_origin.append(oi)
        else:
            exploded.append(go)
            exploded_origin.append(oi)

    # greedy bin-packing of instances in spatial (transform-origin Morton)
    # order so chunks stay spatially coherent
    origins = np.stack([np.asarray(go.transform)[:3, 3] for go in exploded])
    order = np.argsort(_morton3(origins), kind="stable")
    chunks: List[List[GameObject]] = [[]]
    chunk_origins: List[List[int]] = [[]]
    load = 0
    for i in order:
        go = exploded[int(i)]
        n = go.mesh.num_triangles
        if load and load + n > max_tris:
            chunks.append([])
            chunk_origins.append([])
            load = 0
        chunks[-1].append(go)
        chunk_origins[-1].append(exploded_origin[int(i)])
        load += n

    out = []
    for part, part_origins in zip(chunks, chunk_origins):
        s = Scene(camera=scene.camera, materials=scene.materials,
                  lights=scene.lights, game_objects=part)
        s.origin_indices = np.asarray(part_origins, dtype=np.int64)
        out.append(s)

    # near-to-far from the camera: the per-chunk walks carry the best hit so
    # far as a t bound (t_init), so walking likely-nearest chunks first lets
    # later chunks prune against an already-tight bound
    cam = np.asarray(scene.camera.position, np.float32)

    def cam_dist(s):
        origins = np.stack([np.asarray(g.transform)[:3, 3] for g in s.game_objects])
        return float(np.linalg.norm(origins.mean(axis=0) - cam))

    out.sort(key=cam_dist)
    log.info(
        f"Partitioned scene: {total} world triangles -> {len(out)} chunks "
        f"(<= {max_tris} each)"
    )
    return out


def merge_hits(a: walk.Hit, b: walk.Hit) -> walk.Hit:
    """Elementwise closest-hit merge of two per-chunk Hit records."""
    better = b.found & (b.t < a.t)
    merged = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "found":
            merged[f.name] = x | y
        else:
            sel = better[:, None] if y.dim() == 2 else better
            merged[f.name] = torch.where(sel, y, x)
    return walk.Hit(**merged)


def render_radiance_chunked(
    arrays_list,  # sequence of SceneArrays, one per chunk, on one device
    camera_params: dict,
    cfg: RenderConfig,
    max_bounces: Optional[int] = None,
    rng_key: int = 0,
    with_stats: bool = False,
):
    """Full frame (H, W, 3) in [0, 1], bottom-up rows, over chunked trees;
    with ``with_stats`` also the traced-ray count (0-d int64): every
    closest-hit query of a live ray and one shadow query per shadow ray, not
    per chunk."""
    from .integrator import _make_sampler, _sample_index, trace_wave

    max_bounces = max_bounces or cfg.max_bounces
    use_kernels = cfg.kernels != "xla"
    ws_list = [world_geometry(a) for a in arrays_list]
    frame = dict(width=cfg.width, height=cfg.height)

    def trace_fn(_ws, origin, direction, active):
        hit = None
        for ws in ws_list:
            if use_kernels:
                # the best t so far bounds the walk of the next chunk
                h = walk.closest_hit_bvh2(
                    ws, origin, direction, active,
                    t_init=None if hit is None else hit.t, **frame)
            else:
                h = traverse_world(ws, origin, direction, active)
            hit = h if hit is None else merge_hits(hit, h)
        return hit

    def shadow_fn(_ws, origin, direction, max_dist, active, **kw):
        min_vis = kw.get("min_visibility", cfg.shadow_min_visibility)
        vis_total, rays = None, None
        act = active
        for ws in ws_list:
            if use_kernels:
                vis, r = walk.shadow_walk_bvh2(ws, origin, direction, max_dist,
                                               act, **kw, **frame)
            else:
                vis, r = shadow_walk(ws, origin, direction, max_dist, act, **kw)
            vis_total = vis if vis_total is None else vis_total * vis
            # rays already extinguished skip the remaining chunk walks
            act = act & (vis_total > min_vis)
            rays = r if rays is None else rays  # one query per ray, not per chunk
        return vis_total, rays

    dev = ws_list[0].tri_v0.device
    frag, uv = camera_rays.pixel_grid(cfg.width, cfg.height, dev)
    sampler = _make_sampler(cfg, frag, uv, cfg.width, cfg.height, rng_key)
    total = torch.zeros((uv.shape[0], 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(cfg.spp):
        samp = _sample_index(cfg, s, rng_key)
        sampler.start_sample(samp)
        origin, direction = camera_rays.generate_rays(
            uv, sampler.camera_jitter(), camera_params["inv_proj"],
            camera_params["inv_view"], camera_params["position"])
        radiance, r = trace_wave(
            ws_list[0], origin, direction, camera_params["position"], cfg,
            sampler, samp, max_bounces, trace_fn=trace_fn, shadow_fn=shadow_fn)
        total, rays = total + radiance, rays + r
    color = torch.clamp(total / float(cfg.spp), 0.0, 1.0)
    img = color.reshape(cfg.height, cfg.width, 3)
    if with_stats:
        return img, rays
    return img
