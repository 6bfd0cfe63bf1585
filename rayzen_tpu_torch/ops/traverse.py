"""The portable walks of the per-wave path, the object-space BLAS walk, and
the brute-force oracles.

Port of rayzen_tpu/ops/traverse.py: ``traverse_world`` and ``shadow_walk``
are the stackless miss-link walks over WorldArrays.records (one row gather
per step feeds the box test and the inlined leaf triangles), run over the
whole wave in torch: every unfinished ray advances one node per step until
none is left. They are the same per-ray walk as K7's plain version
(ops/walk.py), with the JAX package's own endings: ``_resolve_hit`` reads
the hit's attributes from the world triangle arrays, and the shadow walk
takes a blocker's transparency from its material row. ``brute_force_world``
and ``shadow_brute`` intersect every world triangle (the ground truth the
reference never had); they are chunked over rays to bound memory. Ray counts
are int64. ``traverse_blas`` is the stackless walk over one instance's BLAS
in object space (SceneArrays.node_bounds / node_meta and the packed
triangles), and ``traverse_scene`` / ``brute_force_scene`` refit a
SceneArrays with ``world_geometry`` before walking it.
"""

from __future__ import annotations

import torch

from ..material import TRANSPARENCY
from ..packing import SceneArrays, WorldArrays, world_geometry
from . import walk
from .intersect import (
    T_FAR, cross3, face_normal, moller_trumbore, safe_inv, slab_test,
)
from .walk import Hit


def traverse_blas(arrays: SceneArrays, origin, direction, active,
                  node_offset: int, tri_offset: int, leaf_size: int = 4):
    """Stackless walk over one BLAS (rows node_offset.. of node_bounds /
    node_meta) for object-space rays (R, 3), directions normalized. At node
    cur a ray prunes the node unless its box is hit at tmin <= the ray's
    best t; a hit internal node (count -1) sends it to its left child, a hit
    leaf tests its first ``count`` of ``leaf_size`` contiguous triangles
    (from tri_offset + left_first) and, like a miss or the empty mesh's
    count-0 root, sends it to the node's miss link; -1 ends the walk. The
    unfinished rays advance one node per step until none is left. Returns
    (t_local (R,), T_FAR where nothing is hit; tri (R,) int32 global
    triangle index or -1)."""
    n, dev = origin.shape[0], origin.device
    inv_dir = safe_inv(direction)
    t_best = torch.full((n,), T_FAR, dtype=torch.float32, device=dev)
    tri_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    last = arrays.tri_v0.shape[0] - 1
    live = active.nonzero()[:, 0]
    cur = torch.zeros_like(live)
    while live.numel():
        bounds = arrays.node_bounds[node_offset + cur]
        left_first, count, miss = arrays.node_meta[node_offset + cur].long().unbind(1)
        o, d, tb = origin[live], direction[live], t_best[live]
        tmin, _, box_hit = slab_test(o, inv_dir[live], bounds[:, :3], bounds[:, 3:])
        box_ok = box_hit & (tmin <= tb)
        is_leaf = count >= 0
        rows = (box_ok & is_leaf).nonzero()[:, 0]
        if rows.numel():
            ids, o, d, tb = live[rows], o[rows], d[rows], tb[rows]
            tri = tri_best[ids]
            base, cnt = tri_offset + left_first[rows], count[rows]
            for k in range(leaf_size):
                tid = (base + k).clamp(max=last)
                t, h = moller_trumbore(o, d, arrays.tri_v0[tid], arrays.tri_e1[tid],
                                       arrays.tri_e2[tid])
                better = (k < cnt) & h & (t < tb)
                tb = torch.where(better, t, tb)
                tri = torch.where(better, tid.to(torch.int32), tri)
            t_best[ids], tri_best[ids] = tb, tri
        nxt = torch.where(box_ok & ~is_leaf, left_first, miss)
        live, cur = live[nxt >= 0], nxt[nxt >= 0]
    return t_best, tri_best


def _resolve_hit(ws: WorldArrays, origin, direction, t_best, tri_best) -> Hit:
    """A Hit from (t, winning triangle): point, instance, the oriented
    geometric normal and the material, gathered from the world arrays."""
    found = tri_best >= 0
    tid = tri_best.clamp(min=0).long()
    e1, e2, nsign = ws.tri_e1[tid], ws.tri_e2[tid], ws.tri_nsign[tid]
    mat = torch.where(found, ws.tri_mat[tid], -1).to(torch.int32)
    return Hit(
        t=t_best, point=origin + direction * t_best[:, None], tri=tri_best,
        inst=torch.where(found, ws.tri_inst[tid], -1).to(torch.int32),
        found=found, normal=face_normal(e1, e2) * nsign[:, None], mat=mat,
        cross=cross3(e1, e2),
        menc=torch.where(found, (mat.float() + 1.0) * nsign, 0.0),
    )


def traverse_world(ws: WorldArrays, origin, direction, active) -> Hit:
    """Closest hit over the unified world-space tree (traverseTLAS
    semantics, glsl:457-503, with the two levels stitched into one
    stackless walk)."""
    t, tri, _cross, _menc = walk.misslink_closest_walk_reference(
        ws, origin, direction, active)
    return _resolve_hit(ws, origin, direction, t, tri)


def shadow_walk(ws: WorldArrays, origin, direction, max_dist, active,
                min_visibility: float = 0.05, t_eps: float = 1e-3):
    """Transmission-accumulating occlusion walk (shadowVisibility, glsl:507-
    528) in one tree walk: visibility multiplies by the transparency of
    each surface hit within [t_eps, max_dist), 0 for opaque ones, and a ray
    stops once it is at or below min_visibility. Returns (vis (R,), rays ()
    int64: one occlusion query per active ray)."""
    walk.check_records(ws)
    K = ws.leaf_k
    last = ws.num_triangles - 1
    ks = torch.arange(K, device=origin.device)

    def factors(first, count):
        m = ws.materials[ws.tri_mat[(first[:, None] + ks).clamp(max=last)].long(),
                         TRANSPARENCY]
        return torch.where(m > 0.0, m, 0.0)

    vis, maxd, rays = walk._shadow_setup(origin, max_dist, active,
                                         min_visibility)
    walk._walk_misslink(
        walk._shadow_ops(vis, maxd, min_visibility, t_eps, records=True,
                         factors=factors),
        ws.records, K, walk._rays9(origin, direction), rays)
    return vis, active.sum(dtype=torch.int64)


def _ray_chunks(ws: WorldArrays, n: int):
    """Ray ranges whose (rays x triangles) products stay near 2^20 elements."""
    step = max(1, (1 << 20) // max(1, ws.num_triangles))
    return [slice(i, min(n, i + step)) for i in range(0, n, step)]


def _against_all(ws: WorldArrays, origin, direction):
    """(t (n, Tw), hit) of every ray against every world triangle."""
    return moller_trumbore(origin[:, None, :], direction[:, None, :],
                           ws.tri_v0[None], ws.tri_e1[None], ws.tri_e2[None])


def brute_force_world(ws: WorldArrays, origin, direction, active) -> Hit:
    """BVH-free oracle: the nearest of all world triangles (the first of
    equal nearest ones)."""
    t_best = torch.empty_like(origin[:, 0])
    k = torch.empty(origin.shape[0], dtype=torch.long, device=origin.device)
    for sl in _ray_chunks(ws, origin.shape[0]):
        t, _ = _against_all(ws, origin[sl], direction[sl])
        k[sl] = t.argmin(dim=1)
        t_best[sl] = t.gather(1, k[sl, None])[:, 0]
    found = active & (t_best < T_FAR)
    t_best = torch.where(found, t_best, T_FAR)
    tri = torch.where(found, k, -1).to(torch.int32)
    return _resolve_hit(ws, origin, direction, t_best, tri)


def shadow_brute(ws: WorldArrays, origin, direction, max_dist, active,
                 min_visibility: float = 0.05, t_eps: float = 1e-3):
    """BVH-free oracle for shadow_walk: the product of the transmission of
    every world triangle hit within range."""
    n = origin.shape[0]
    maxd = torch.broadcast_to(
        torch.as_tensor(max_dist, dtype=torch.float32, device=origin.device), (n,))
    transp = ws.materials[ws.tri_mat.long(), TRANSPARENCY][None]
    factor = torch.where(transp > 0.0, transp, 0.0)
    vis = torch.empty_like(maxd)
    for sl in _ray_chunks(ws, n):
        t, h = _against_all(ws, origin[sl], direction[sl])
        blocking = h & (t >= t_eps) & (t < maxd[sl, None])
        vis[sl] = torch.where(blocking, factor, 1.0).prod(dim=1)
    return torch.where(active, vis, 1.0), active.sum(dtype=torch.int64)


def material_rows(ws: WorldArrays, mat_idx):
    """(R, 8) material rows of per-ray material ids (a gather; the JAX
    package selects over the static list instead, for the TPU's layout)."""
    return ws.materials[mat_idx.long()]


def hit_shading_data(ws: WorldArrays, hit: Hit):
    """(world normal, material row, material id) of a resolved Hit; the
    normal is the oriented geometric one, not flipped toward the ray
    (glsl:411, :489-490)."""
    mat_idx = hit.mat.clamp(min=0)
    return hit.normal, material_rows(ws, mat_idx), mat_idx


def traverse_scene(arrays: SceneArrays, origin, direction, active) -> Hit:
    """Refit to world space, then walk. Hot paths call world_geometry once
    per frame and use traverse_world directly."""
    return traverse_world(world_geometry(arrays), origin, direction, active)


def brute_force_scene(arrays: SceneArrays, origin, direction, active) -> Hit:
    """brute_force_world over the refit world arrays."""
    return brute_force_world(world_geometry(arrays), origin, direction, active)
