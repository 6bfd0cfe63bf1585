"""Scene -> device tables: host packing (numpy) and the per-frame refit (torch).

Port of rayzen_tpu.packing. ``pack_scene_host`` is carried over near verbatim
and builds the same BVH2 arrays and, past ``SINGLE_TREE_VMEM_BUDGET``, the same
tiered treelet view as the JAX package (tests/test_torch_pack.py and
tests/test_torch_tiered.py hold them equal); ``world_geometry`` is the
per-frame refit written as torch tensor glue, producing the
``inner_table``/``leaf_table`` and ``top_table``/``tre_inner``/``tre_leaf``
column layouts the walks read (rayzen_tpu/packing.py:937-942, :1075-1086 and
:1092-1121, without the 128-lane padding that only Mosaic's DMA blocks need),
and the wide-node view: ``_collapse_bvh8`` (copied verbatim) collapses the
BVH2 into 8-wide nodes at pack time and ``world_geometry`` builds
``inner8_table``/``leaf8_table`` (:1057-1090), which the K5 walks read.

The tiered decision keeps the JAX rule, budget and default (36 MB) so both
packages walk the same view under the same config; on the H100 the treelet
view is walked by K8 (csrc/walk.cuh) inside the tiered K1.

``world_geometry`` also packs the miss-link ``records`` (:1014-1041), one
row per unified node, which the portable walks (ops/traverse.py) and K7's
plain version read, and beside them K7's device form of the same data
(``misslink_tables``: a 32-byte row per node, a 48-byte row per triangle).
Per-mesh BLAS builds have two cache tiers, as in JAX (:195-239): an
in-process memo and a disk tier of one file per mesh under
``cfg.cache_dir``, both keyed by the vertex content (JAX keys its memo by
``id(mesh)``, which a new mesh can inherit from a freed one). The port's
files live in their own subdirectory (``CACHE_SUBDIR``) with a format tag,
so neither package ever reads the other's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from . import logging_util as log
from .accel.builder import BLAS, build_tlas
# the native C++ BLAS builder, which runs the numpy one where it cannot load:
# both give the same arrays (rayzen_tpu/packing.py:227-228)
from .accel.native import build_blas, build_tlas as native_build_tlas
from .config import RenderConfig
from .light import pack_lights
from .material import pack_materials
from .scene import Scene


@dataclasses.dataclass(frozen=True, eq=True)
class InstanceMeta:
    """Static per-instance layout (BVHInstance, RayZen/include/BVH.h:14-21)."""

    node_offset: int  # offset into the concatenated BLAS node arrays
    tri_offset: int  # offset into the global triangle soup
    num_nodes: int
    num_triangles: int
    mesh_index: int  # which unique mesh this instance references


@dataclasses.dataclass
class SceneArrays:
    """Packed scene. ``pack_scene_host`` returns numpy leaves; ``.to(device)``
    returns the same dataclass with torch tensors on that device. Field
    meanings are those of rayzen_tpu.packing.SceneArrays."""

    tri_v0: np.ndarray  # (T, 3) f32, BVH-leaf order
    tri_e1: np.ndarray  # (T, 3) f32 (v1 - v0)
    tri_e2: np.ndarray  # (T, 3) f32 (v2 - v0)
    tri_mat: np.ndarray  # (T,) i32
    node_bounds: np.ndarray  # (N, 6) f32 [bmin | bmax], concatenated BLAS
    node_meta: np.ndarray  # (N, 3) i32 [left_first, count, miss]
    transforms: np.ndarray  # (I, 4, 4) f32
    inv_transforms: np.ndarray  # (I, 4, 4) f32
    root_bmin: np.ndarray  # (I, 3) f32 object-space BLAS root bounds
    root_bmax: np.ndarray  # (I, 3) f32
    inst_mat_override: np.ndarray  # (I,) i32, -1 keeps the mesh materials
    # unified world-space tree (TLAS + per-instance BLAS copies, stitched)
    uni_meta: np.ndarray  # (Nu, 3) i32 [left_or_first, count, miss]
    blas_src: np.ndarray  # (Nb,) i32 source row in node_bounds
    blas_inst: np.ndarray  # (Nb,) i32 owning instance
    tlas_mask: np.ndarray  # (Nt, I) bool instances under each TLAS node
    wtri_src: np.ndarray  # (Tw,) i32 source row in tri_*
    wtri_inst: np.ndarray  # (Tw,) i32 owning instance
    node_leaf_tri: np.ndarray  # (Nu, K) i32 world-tri ids inlined per leaf
    # BVH2 child-table view read by the ordered-stack walks
    bvh2_child_node: np.ndarray  # (Ni, 2) i32 unified node id, -1 = padding
    bvh2_child_ref: np.ndarray  # (Ni, 2) i32 inner index | leaf-table index
    bvh2_child_count: np.ndarray  # (Ni, 2) i32 -1 internal; >= 0 leaf count
    bvh2_leaf_node: np.ndarray  # (L,) i32 unified node id per leaf-table row
    # BVH8 wide-node view (_collapse_bvh8): per wide node 8 child slots, leaf
    # children first (refs leaf_start, leaf_start + 1, ... into the permuted
    # leaf rows), then internal ones (refs = wide node rows), then padding
    bvh8_child_node: np.ndarray  # (N8, 8) i32 unified node id, -1 = padding
    bvh8_child_ref: np.ndarray  # (N8, 8) i32 wide node | permuted leaf row
    bvh8_child_count: np.ndarray  # (N8, 8) i32 -1 internal; >= 0 leaf count, 0 pad
    bvh8_leaf_start: np.ndarray  # (N8,) i32 first permuted leaf row
    bvh8_leaf_n: np.ndarray  # (N8,) i32 leaf children (= slots 0..leaf_n-1)
    bvh8_leaf_perm: np.ndarray  # (L8,) i32 leaf-table row of each permuted row
    # tiered treelet view (_build_treelets), 1-row dummies when not built
    top_child_node: np.ndarray  # (Nt, 2) i32 unified node id per child
    top_child_ref: np.ndarray  # (Nt, 2) i32 top index | treelet id
    top_child_count: np.ndarray  # (Nt, 2) i32 -1 internal; -2 treelet
    tre_child_node: np.ndarray  # (Tt, SI, 2) i32 unified ids; -1 pad
    tre_child_ref: np.ndarray  # (Tt, SI, 2) i32 local inner row | local leaf slot
    tre_child_count: np.ndarray  # (Tt, SI, 2) i32 -1 internal; >= 0 leaf count
    tre_leaf_src: np.ndarray  # (Tt, SL) i32 global leaf-table row per slot (-1 pad)
    materials: np.ndarray  # (M, 8) f32
    lights: np.ndarray  # (L, 8) f32
    instance_meta: Tuple[InstanceMeta, ...] = ()
    # inner-node depth of the BVH2 tree; bounds the walks' stack (0 = unknown)
    tree_depth: int = 0
    # inner depths of the top tree and of the deepest treelet: they bound the
    # tiered walks' two stacks (0 = unknown)
    top_depth: int = 0
    treelet_depth: int = 0
    # levels of the wide tree, and the stack entries its walks can need
    # (wide_stack_bound; 0 = unknown)
    wide_depth: int = 0
    wide_stack: int = 0

    @property
    def num_instances(self) -> int:
        return len(self.instance_meta)

    @property
    def num_lights(self) -> int:
        return int(self.lights.shape[0])

    def with_transforms(self, transforms) -> "SceneArrays":
        """New instance transforms, geometry and trees untouched: the
        inverses are computed on the host (I x 4 x 4, in float64 as JAX
        does) and both go to the device the arrays are on (numpy arrays
        stay numpy); every other table is shared with ``self``."""
        if isinstance(transforms, torch.Tensor):
            transforms = transforms.detach().cpu().numpy()
        t = np.asarray(transforms, dtype=np.float32)
        inv = np.linalg.inv(t.astype(np.float64)).astype(np.float32)
        if isinstance(self.transforms, torch.Tensor):
            from .ops.camera_rays import upload

            dev = self.transforms.device
            t, inv = upload(t, dev), upload(inv, dev)
        return dataclasses.replace(self, transforms=t, inv_transforms=inv)

    def to(self, device) -> "SceneArrays":
        """The same arrays as torch tensors on ``device`` (dtypes kept), from
        numpy arrays or from tensors on any device (a tensor already there
        is shared, not copied)."""
        return dataclasses.replace(self, **{
            f: to_device(getattr(self, f), device) for f in _SCENE_ARRAY_FIELDS})


def to_device(x, device) -> torch.Tensor:
    """A numpy array or a tensor as a tensor on ``device`` (dtype kept; a
    tensor already there is shared, not copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x)).to(device)


# SceneArrays fields that hold arrays (all but the static layout)
_SCENE_STATIC_FIELDS = ("instance_meta", "tree_depth", "top_depth",
                        "treelet_depth", "wide_depth", "wide_stack")
_SCENE_ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(SceneArrays)
    if f.name not in _SCENE_STATIC_FIELDS
)

# Raw traversal-table bytes one tree may keep VMEM-resident before the pack
# switches to the tiered view (rayzen_tpu/packing.py:154-164: the largest
# single tree the JAX package ran on a TPU v5e, with margin). Kept with the
# same default and override so both packages build the same view.
SINGLE_TREE_VMEM_BUDGET = int(
    float(os.environ.get("RAYZEN_TREE_BUDGET_MB", "36")) * 1024 * 1024
)


def single_tree_table_bytes(n_inner: int, n_leaf_rows: int, leaf_size: int) -> int:
    """Raw inner+leaf table bytes for one tree."""
    leaf_w = ((11 * leaf_size + 2 + 7) // 8) * 8
    return 4 * (n_inner * 16 + n_leaf_rows * leaf_w)


def bvh2_depth(child_ref, child_count, roots=None) -> int:
    """Inner-node depth of the BVH2 tree (host, pack time): one level-BFS
    pass per level from the root (or from each of ``roots``). A single-pop
    walk's stack never holds more than depth + 1 entries."""
    ref = np.asarray(child_ref)
    cnt = np.asarray(child_count)
    if ref.shape[0] == 0:
        return 0
    frontier = (np.zeros((1,), np.int64) if roots is None
                else np.asarray(roots, np.int64))
    depth = 0
    while frontier.size and depth <= ref.shape[0]:
        depth += 1
        r = ref[frontier].ravel()
        c = cnt[frontier].ravel()
        # unique: rows that share a child (not made by the builder, but
        # possible in hand-made tables) must not double the frontier
        frontier = np.unique(r[c == -1].astype(np.int64))
    return depth


def tiered_depths(top_ref, top_count, tre_ref, tre_count) -> Tuple[int, int]:
    """(top-tree depth, deepest treelet's depth): bvh2_depth over the top
    tree, and over all treelets at once with each treelet's local refs offset
    by its first row in the flattened (Tt * SI, 2) tables."""
    tre_ref = np.asarray(tre_ref)
    tt, si = tre_ref.shape[:2]
    flat_ref = tre_ref + (np.arange(tt) * si)[:, None, None]
    top = bvh2_depth(top_ref, top_count)
    tre = bvh2_depth(flat_ref.reshape(-1, 2),
                     np.asarray(tre_count).reshape(-1, 2),
                     roots=np.arange(tt) * si)
    return top, tre


def wide_stack_bound(child_ref8, child_count8) -> Tuple[int, int]:
    """(levels of the wide tree, stack entries its walks can need), host,
    from the BVH8 child refs and counts. A pop pushes the node's hit internal
    children (at most 8) and the walk continues with one of them, leaving
    the others below it, so with ic(v) internal children the walk of v's
    subtree raises the stack by S(v) = ic(v) + max(0, max_c S(c) - 1) over
    v's internal children c; the walk needs max(1, S(root)) entries, all
    boxes hit being the worst case. Computed bottom-up over a level-BFS
    order from the root."""
    ref = np.asarray(child_ref8)
    internal = np.asarray(child_count8) < 0
    if ref.shape[0] == 0:
        return 0, 0
    levels, frontier = [], np.zeros((1,), np.int64)
    while frontier.size and len(levels) <= ref.shape[0]:
        levels.append(frontier)
        frontier = np.unique(ref[frontier][internal[frontier]].astype(np.int64))
    need = np.zeros((ref.shape[0],), np.int64)
    for nodes in reversed(levels):
        ic = internal[nodes].sum(axis=1)
        kids = np.where(internal[nodes], ref[nodes], 0)
        below = np.where(internal[nodes], need[kids], 0).max(axis=1)
        need[nodes] = np.where(ic > 0, ic + np.maximum(below - 1, 0), 0)
    return len(levels), max(1, int(need[0]))


_blas_cache: dict = {}

_BLAS_FIELDS = ("bounds_min", "bounds_max", "left_first", "count", "miss", "order")
# the port's files under cfg.cache_dir: a subdirectory of their own, which
# the JAX package (cache_dir/scene_*.npz, cache_dir/blas/) never reads, and a
# format tag in every file, checked on load
CACHE_SUBDIR = "rayzen_tpu_torch-v1"
BLAS_FORMAT = "rayzen_tpu_torch/blas/v1"


def host_array(x) -> np.ndarray:
    """A SceneArrays leaf (numpy, or a tensor on any device) as numpy; a
    device tensor is read back, which waits for the device."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_npz(path: str, data: dict) -> None:
    """np.savez to ``path`` through a file of this process, then renamed:
    concurrent writers never interleave and readers never see a part."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.npz"  # savez keeps an .npz suffix
    np.savez(tmp, **data)
    os.replace(tmp, path)


def _blas_disk_path(digest: str, cfg: RenderConfig) -> str:
    return os.path.join(cfg.cache_dir, CACHE_SUBDIR, "blas",
                        f"{digest[:20]}_{cfg.leaf_size}_{cfg.split_method}.npz")


def _load_blas(path: str) -> BLAS:
    with np.load(path) as z:
        if "format" not in z.files or str(z["format"]) != BLAS_FORMAT:
            raise ValueError(f"not a {BLAS_FORMAT} file")
        return BLAS(**{f: z[f] for f in _BLAS_FIELDS})


def _mesh_blas(mesh, cfg: RenderConfig) -> BLAS:
    """Per-mesh BLAS with two cache tiers (main.cpp:1128-1136 memoizes in
    process, :951-969 keeps per-mesh files): the in-process memo, then a
    file under cfg.cache_dir, both keyed by the vertex content. The disk
    tier is skipped under cfg.rebuild_bvh; a file that does not load
    rebuilds (and is rewritten)."""
    digest = hashlib.sha1(mesh.vertices.tobytes()).hexdigest()
    key = (digest, mesh.num_triangles, cfg.leaf_size, cfg.split_method)
    blas = _blas_cache.get(key)
    if blas is not None:
        return blas
    path = _blas_disk_path(digest, cfg) if mesh.num_triangles else None
    if path and not cfg.rebuild_bvh and os.path.exists(path):
        try:
            blas = _load_blas(path)
            _blas_cache[key] = blas
            return blas
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:  # corrupt: rebuild
            log.error(f"BLAS cache load failed ({e}); rebuilding")
    blas = build_blas(mesh.vertices, cfg.leaf_size, cfg.split_method)
    _blas_cache[key] = blas
    if path:
        try:
            save_npz(path, dict(format=np.asarray(BLAS_FORMAT),
                                **{f: getattr(blas, f) for f in _BLAS_FIELDS}))
        except OSError as e:
            log.error(f"BLAS cache write failed: {e}")
    return blas


def pack_scene(scene: Scene, cfg: RenderConfig | None, device) -> SceneArrays:
    """Pack on the host and move to ``device``."""
    return pack_scene_host(scene, cfg).to(device)


def pack_scene_host(
    scene: Scene, cfg: RenderConfig | None = None
) -> SceneArrays:
    """Pack entirely host-side; the returned SceneArrays has numpy leaves."""
    cfg = cfg or RenderConfig()
    unique_meshes = []
    mesh_slot = {}
    for go in scene.game_objects:
        if id(go.mesh) not in mesh_slot:
            mesh_slot[id(go.mesh)] = len(unique_meshes)
            unique_meshes.append(go.mesh)

    tri_v0, tri_e1, tri_e2, tri_mat = [], [], [], []
    bounds_list, meta_list = [], []
    mesh_layout = []  # (node_offset, tri_offset, n_nodes, n_tris) per unique mesh
    node_off = tri_off = 0
    for mesh in unique_meshes:
        blas = _mesh_blas(mesh, cfg)
        verts = mesh.vertices[blas.order]  # leaf order
        mats = mesh.material_index[blas.order]
        tri_v0.append(verts[:, 0])
        tri_e1.append(verts[:, 1] - verts[:, 0])
        tri_e2.append(verts[:, 2] - verts[:, 0])
        tri_mat.append(mats)
        bounds_list.append(
            np.concatenate([blas.bounds_min, blas.bounds_max], axis=1)
        )
        meta_list.append(
            np.stack([blas.left_first, blas.count, blas.miss], axis=1)
        )
        mesh_layout.append((node_off, tri_off, blas.num_nodes, blas.num_triangles))
        node_off += blas.num_nodes
        tri_off += blas.num_triangles

    instance_meta = []
    transforms = []
    root_bmin, root_bmax = [], []
    mat_override = []
    for go in scene.game_objects:
        slot = mesh_slot[id(go.mesh)]
        n_off, t_off, n_nodes, n_tris = mesh_layout[slot]
        instance_meta.append(InstanceMeta(n_off, t_off, n_nodes, n_tris, slot))
        transforms.append(go.transform)
        root_bmin.append(bounds_list[slot][0, :3])
        root_bmax.append(bounds_list[slot][0, 3:])
        mat_override.append(getattr(go, "material_override", -1))

    def cat(parts, empty_shape, dtype):
        if not parts or sum(p.shape[0] for p in parts) == 0:
            return np.zeros((1,) + empty_shape, dtype=dtype)
        return np.concatenate(parts).astype(dtype)

    tri_v0 = cat(tri_v0, (3,), np.float32)
    tri_e1 = cat(tri_e1, (3,), np.float32)
    tri_e2 = cat(tri_e2, (3,), np.float32)
    tri_mat = cat(tri_mat, (), np.int32)
    node_bounds = cat(bounds_list, (6,), np.float32)
    node_meta = cat(meta_list, (3,), np.int32)

    if transforms:
        transforms = np.stack(transforms).astype(np.float32)
        inv_transforms = np.linalg.inv(transforms.astype(np.float64)).astype(np.float32)
        root_bmin = np.stack(root_bmin).astype(np.float32)
        root_bmax = np.stack(root_bmax).astype(np.float32)
        mat_override = np.asarray(mat_override, dtype=np.int32)
    else:
        transforms = np.eye(4, dtype=np.float32)[None]
        inv_transforms = transforms.copy()
        root_bmin = np.full((1, 3), np.finfo(np.float32).max, dtype=np.float32)
        root_bmax = -root_bmin
        mat_override = np.full((1,), -1, dtype=np.int32)

    uni = _build_unified(
        instance_meta, node_meta, transforms, root_bmin, root_bmax,
        leaf_k=cfg.leaf_size,
    )
    tree_depth = bvh2_depth(uni["bvh2_child_ref"], uni["bvh2_child_count"])

    # tiered treelet view when the single tree exceeds the budget
    # (rayzen_tpu/packing.py:327-343)
    n_inner = uni["bvh2_child_node"].shape[0]
    n_leaf_rows = uni["bvh2_leaf_node"].shape[0]
    tiered_on = cfg.tiered == "on" or (
        cfg.tiered == "auto"
        and single_tree_table_bytes(n_inner, n_leaf_rows, cfg.leaf_size)
        > SINGLE_TREE_VMEM_BUDGET
    )
    if tiered_on and cfg.leaf_size <= 11:  # leaf rows must fit 128 f32 lanes
        uni.update(
            _build_treelets(
                uni["bvh2_child_node"], uni["bvh2_child_ref"],
                uni["bvh2_child_count"], cfg.treelet_rows,
            )
        )
    else:
        uni.update(_empty_treelets())
    top_depth, treelet_depth = tiered_depths(
        uni["top_child_ref"], uni["top_child_count"],
        uni["tre_child_ref"], uni["tre_child_count"],
    )
    wide_depth, wide_stack = wide_stack_bound(uni["bvh8_child_ref"],
                                              uni["bvh8_child_count"])

    total_tris = sum(m.num_triangles for m in instance_meta)
    log.info(
        f"Packed scene: {len(unique_meshes)} unique meshes, "
        f"{len(instance_meta)} instances, {total_tris} instanced triangles, "
        f"{node_meta.shape[0]} BVH nodes, {uni['uni_meta'].shape[0]} unified nodes"
    )
    return SceneArrays(
        tri_v0=tri_v0,
        tri_e1=tri_e1,
        tri_e2=tri_e2,
        tri_mat=tri_mat,
        node_bounds=node_bounds,
        node_meta=node_meta,
        transforms=transforms,
        inv_transforms=inv_transforms,
        root_bmin=root_bmin,
        root_bmax=root_bmax,
        inst_mat_override=mat_override,
        materials=pack_materials(scene.materials),
        lights=pack_lights(scene.lights),
        instance_meta=tuple(instance_meta),
        tree_depth=tree_depth,
        top_depth=top_depth,
        treelet_depth=treelet_depth,
        wide_depth=wide_depth,
        wide_stack=wide_stack,
        **uni,
    )


def _build_unified(
    instance_meta, node_meta, transforms, root_bmin, root_bmax, leaf_k: int = 4
):
    """Stitch TLAS + per-instance BLAS copies into one threaded tree (host,
    numpy): TLAS leaves point at their instance's BLAS root and BLAS escape
    links are remapped to the owning TLAS leaf's miss link. The TLAS topology
    is built once from the initial instance AABBs; per-frame motion only
    refits bounds (world_geometry)."""
    n_inst = len(instance_meta)
    nonempty = [i for i, m in enumerate(instance_meta) if m.num_triangles > 0]

    if not nonempty:
        out = dict(
            uni_meta=np.asarray([[0, 0, -1]], dtype=np.int32),
            blas_src=np.zeros((0,), dtype=np.int32),
            blas_inst=np.zeros((0,), dtype=np.int32),
            tlas_mask=np.zeros((1, max(n_inst, 1)), dtype=bool),
            wtri_src=np.zeros((1,), dtype=np.int32),
            wtri_inst=np.zeros((1,), dtype=np.int32),
            node_leaf_tri=np.zeros((1, leaf_k), dtype=np.int32),
        )
        out.update(_build_bvh2(out["uni_meta"], 1))
        return out

    # initial world AABBs (8 transformed corners of each BLAS root)
    init_wmin, init_wmax = [], []
    for i in nonempty:
        corners = np.stack(
            [
                [root_bmin[i][0] if x == 0 else root_bmax[i][0],
                 root_bmin[i][1] if y == 0 else root_bmax[i][1],
                 root_bmin[i][2] if z == 0 else root_bmax[i][2]]
                for x in (0, 1) for y in (0, 1) for z in (0, 1)
            ]
        ).astype(np.float32)
        w = corners @ transforms[i][:3, :3].T + transforms[i][:3, 3]
        init_wmin.append(w.min(axis=0))
        init_wmax.append(w.max(axis=0))
    tlas = build_tlas(np.stack(init_wmin), np.stack(init_wmax))
    n_tlas = tlas.num_nodes

    # layout: world-triangle and unified-BLAS-node offsets per nonempty instance
    wtri_off, blas_off = {}, {}
    cum_t, cum_n = 0, n_tlas
    for i in nonempty:
        wtri_off[i] = cum_t
        blas_off[i] = cum_n
        cum_t += instance_meta[i].num_triangles
        cum_n += instance_meta[i].num_nodes

    uni_meta = np.zeros((cum_n, 3), dtype=np.int32)
    blas_src = np.zeros((cum_n - n_tlas,), dtype=np.int32)
    blas_inst = np.zeros((cum_n - n_tlas,), dtype=np.int32)
    tlas_mask = np.zeros((n_tlas, n_inst), dtype=bool)
    leaf_miss = {}  # instance id -> miss link of its TLAS leaf

    # TLAS section: internal nodes pass through; leaves descend into BLAS roots
    for j in range(n_tlas):
        count = int(tlas.count[j])
        miss = int(tlas.miss[j])
        if count < 0:  # internal
            uni_meta[j] = (int(tlas.left_first[j]), -1, miss)
        else:  # leaf, exactly one instance (BVH.cpp:204)
            inst = nonempty[int(tlas.order[int(tlas.left_first[j])])]
            uni_meta[j] = (blas_off[inst], -1, miss)
            leaf_miss[inst] = miss

    # descendant-instance masks for the TLAS bound refit (iterative
    # post-order: children before parents, then union upward)
    desc = [None] * n_tlas
    stack = [(0, False)]
    while stack:
        node, expanded = stack.pop()
        if int(tlas.count[node]) >= 0:
            inst = nonempty[int(tlas.order[int(tlas.left_first[node])])]
            desc[node] = [inst]
        elif not expanded:
            left = int(tlas.left_first[node])
            stack.append((node, True))
            stack.append((left, False))
            stack.append((left + 1, False))
        else:
            left = int(tlas.left_first[node])
            desc[node] = desc[left] + desc[left + 1]
        if desc[node] is not None:
            for i in desc[node]:
                tlas_mask[node, i] = True

    # BLAS sections: remap child/first/miss links into unified space
    wtri_src, wtri_inst = [], []
    node_leaf_tri = np.zeros((cum_n, leaf_k), dtype=np.int32)
    for i in nonempty:
        m = instance_meta[i]
        off = blas_off[i]
        rows = node_meta[m.node_offset : m.node_offset + m.num_nodes]
        for k, (left_first, count, miss) in enumerate(rows):
            new_miss = leaf_miss[i] if miss == -1 else off + int(miss)
            if count < 0:  # internal
                uni_meta[off + k] = (off + int(left_first), -1, new_miss)
            else:  # leaf: first indexes the world-triangle array
                if int(count) > leaf_k:
                    raise ValueError(
                        f"BVH leaf with {int(count)} triangles exceeds the "
                        f"inlined leaf capacity {leaf_k} (cfg.leaf_size)"
                    )
                first = wtri_off[i] + int(left_first)
                uni_meta[off + k] = (first, int(count), new_miss)
                for c in range(min(int(count), leaf_k)):
                    node_leaf_tri[off + k, c] = first + c
            blas_src[off + k - n_tlas] = m.node_offset + k
            blas_inst[off + k - n_tlas] = i
        wtri_src.extend(range(m.tri_offset, m.tri_offset + m.num_triangles))
        wtri_inst.extend([i] * m.num_triangles)

    out = dict(
        uni_meta=uni_meta,
        blas_src=blas_src,
        blas_inst=blas_inst,
        tlas_mask=tlas_mask,
        wtri_src=np.asarray(wtri_src, dtype=np.int32),
        wtri_inst=np.asarray(wtri_inst, dtype=np.int32),
        node_leaf_tri=node_leaf_tri,
    )
    out.update(_build_bvh2(uni_meta, n_tlas))
    return out


def _build_bvh2(uni_meta: np.ndarray, n_tlas: int):
    """Explicit child-table (BVH2) view of the unified tree: each internal
    node carries both children's boxes, so a missed child never costs a
    step. Unary TLAS leaves are elided; a synthetic root is added when the
    whole tree is one leaf so the walks always start at an internal node."""

    def resolve(node):
        """Skip unary TLAS leaves: their meta is (blas_root, -1, miss) with
        blas_root >= n_tlas, while real TLAS internals point inside the TLAS
        section."""
        while node < n_tlas and uni_meta[node][1] < 0 and uni_meta[node][0] >= n_tlas:
            node = int(uni_meta[node][0])
        return node

    root = resolve(0)
    inner_child_node, inner_child_ref, inner_child_count = [], [], []
    leaf_node = []

    def add_leaf(node):
        leaf_node.append(node)
        return len(leaf_node) - 1

    if uni_meta[root][1] >= 0:
        # whole tree is one leaf: synthetic root with a padding right child
        li = add_leaf(root)
        inner_child_node.append((root, -1))
        inner_child_ref.append((li, 0))
        inner_child_count.append((int(uni_meta[root][1]), 0))
    else:
        # BFS; children of an internal node are (left, left+1) in both the
        # TLAS and BLAS sections (builder adjacency), then TLAS-leaf-elided
        index_of = {root: 0}
        queue = [root]
        inner_child_node = [None]
        inner_child_ref = [None]
        inner_child_count = [None]
        while queue:
            node = queue.pop(0)
            slot = index_of[node]
            left = int(uni_meta[node][0])
            kids_node, kids_ref, kids_count = [], [], []
            for child in (resolve(left), resolve(left + 1)):
                count = int(uni_meta[child][1])
                if count >= 0:
                    kids_ref.append(add_leaf(child))
                    kids_count.append(count)
                else:
                    if child not in index_of:
                        index_of[child] = len(inner_child_node)
                        inner_child_node.append(None)
                        inner_child_ref.append(None)
                        inner_child_count.append(None)
                        queue.append(child)
                    kids_ref.append(index_of[child])
                    kids_count.append(-1)
                kids_node.append(child)
            inner_child_node[slot] = tuple(kids_node)
            inner_child_ref[slot] = tuple(kids_ref)
            inner_child_count[slot] = tuple(kids_count)

    if not leaf_node:
        leaf_node.append(0)
    out = dict(
        bvh2_child_node=np.asarray(inner_child_node, dtype=np.int32),
        bvh2_child_ref=np.asarray(inner_child_ref, dtype=np.int32),
        bvh2_child_count=np.asarray(inner_child_count, dtype=np.int32),
        bvh2_leaf_node=np.asarray(leaf_node, dtype=np.int32),
    )
    out.update(
        _collapse_bvh8(
            out["bvh2_child_node"], out["bvh2_child_ref"], out["bvh2_child_count"]
        )
    )
    return out


def _build_treelets(child_node: np.ndarray, child_ref: np.ndarray,
                    child_count: np.ndarray, max_rows: int):
    """Cut the BVH2 child-table tree into treelets of at most ``max_rows``
    inner rows and ``max_rows`` leaf rows each, plus the remaining small top
    tree (see SceneArrays tiered-field docs).

    Top-tree children: count -1 = top internal (ref = top row), -2 = treelet
    (ref = treelet id). Treelet-local children: count -1 = local inner row,
    count >= 0 = leaf with ``ref`` = local leaf SLOT (the slot's global
    leaf-table row lives in tre_leaf_src)."""
    ni = child_node.shape[0]

    # subtree sizes per inner node (iterative reverse-BFS accumulation)
    order, seen, stack = [], set(), [0]
    while stack:
        n = stack.pop()
        if n in seen:
            continue
        seen.add(n)
        order.append(n)
        for c in range(2):
            if child_count[n, c] < 0:
                stack.append(int(child_ref[n, c]))
    inner_cnt = np.ones(ni, dtype=np.int64)
    leaf_cnt = np.zeros(ni, dtype=np.int64)
    for n in reversed(order):
        for c in range(2):
            if child_count[n, c] < 0:
                r = int(child_ref[n, c])
                inner_cnt[n] += inner_cnt[r]
                leaf_cnt[n] += leaf_cnt[r]
            elif child_node[n, c] >= 0:
                leaf_cnt[n] += 1

    def cuttable(idx):
        return inner_cnt[idx] <= max_rows and leaf_cnt[idx] <= max_rows

    treelets = []  # per treelet: (local child tables, leaf_src)

    def make_treelet(entry):
        """entry = ('inner', bvh2 idx) or ('leaf', leaf_ref, count, node_id).
        Returns the treelet id."""
        t_node, t_ref, t_cnt, leaf_src = [], [], [], []
        if entry[0] == "leaf":
            # synthetic root: one real leaf child + inert padding child
            _, lref, lcount, lnode = entry
            leaf_src.append(int(lref))
            t_node.append((int(lnode), -1))
            t_ref.append((0, 0))
            t_cnt.append((int(lcount), 0))
        else:
            root = entry[1]
            index_of = {root: 0}
            queue = [root]
            t_node, t_ref, t_cnt = [None], [None], [None]
            while queue:
                n = queue.pop(0)
                slot = index_of[n]
                kn, kr, kc = [], [], []
                for c in range(2):
                    cnt = int(child_count[n, c])
                    if cnt < 0:  # internal child -> local inner row
                        r = int(child_ref[n, c])
                        if r not in index_of:
                            index_of[r] = len(t_node)
                            t_node.append(None)
                            t_ref.append(None)
                            t_cnt.append(None)
                            queue.append(r)
                        kr.append(index_of[r])
                        kc.append(-1)
                    else:  # leaf child -> local leaf slot
                        kr.append(len(leaf_src))
                        leaf_src.append(int(child_ref[n, c]))
                        kc.append(cnt)
                    kn.append(int(child_node[n, c]))
                t_node[slot] = tuple(kn)
                t_ref[slot] = tuple(kr)
                t_cnt[slot] = tuple(kc)
        treelets.append((t_node, t_ref, t_cnt, leaf_src))
        return len(treelets) - 1

    # top tree: BFS over un-cut inner nodes; the root is always a top node
    # (a fully-cuttable tree gets a synthetic top root with one treelet child)
    top_node, top_ref, top_cnt = [], [], []
    if cuttable(0):
        tid = make_treelet(("inner", 0))
        top_node.append((0, -1))
        top_ref.append((tid, 0))
        top_cnt.append((-2, 0))
    else:
        index_of = {0: 0}
        queue = [0]
        top_node, top_ref, top_cnt = [None], [None], [None]
        while queue:
            n = queue.pop(0)
            slot = index_of[n]
            kn, kr, kc = [], [], []
            for c in range(2):
                cnt = int(child_count[n, c])
                if cnt < 0:
                    r = int(child_ref[n, c])
                    if cuttable(r):
                        kr.append(make_treelet(("inner", r)))
                        kc.append(-2)
                    else:
                        if r not in index_of:
                            index_of[r] = len(top_node)
                            top_node.append(None)
                            top_ref.append(None)
                            top_cnt.append(None)
                            queue.append(r)
                        kr.append(index_of[r])
                        kc.append(-1)
                elif child_node[n, c] >= 0:  # bare leaf above the cuts
                    kr.append(
                        make_treelet(
                            ("leaf", int(child_ref[n, c]), cnt,
                             int(child_node[n, c]))
                        )
                    )
                    kc.append(-2)
                else:  # padding child
                    kr.append(0)
                    kc.append(0)
                kn.append(int(child_node[n, c]))
            top_node[slot] = tuple(kn)
            top_ref[slot] = tuple(kr)
            top_cnt[slot] = tuple(kc)

    # pack treelets to fixed (Tt, max_rows, ...) blocks
    tt = len(treelets)
    tre_node = np.full((tt, max_rows, 2), -1, dtype=np.int32)
    tre_ref = np.zeros((tt, max_rows, 2), dtype=np.int32)
    tre_cnt = np.zeros((tt, max_rows, 2), dtype=np.int32)
    tre_leaf = np.full((tt, max_rows), -1, dtype=np.int32)
    for t, (t_node, t_ref, t_cnt, leaf_src) in enumerate(treelets):
        assert len(t_node) <= max_rows and len(leaf_src) <= max_rows
        for i in range(len(t_node)):
            tre_node[t, i] = t_node[i]
            tre_ref[t, i] = t_ref[i]
            tre_cnt[t, i] = t_cnt[i]
        tre_leaf[t, : len(leaf_src)] = leaf_src
    return dict(
        top_child_node=np.asarray(top_node, dtype=np.int32),
        top_child_ref=np.asarray(top_ref, dtype=np.int32),
        top_child_count=np.asarray(top_cnt, dtype=np.int32),
        tre_child_node=tre_node,
        tre_child_ref=tre_ref,
        tre_child_count=tre_cnt,
        tre_leaf_src=tre_leaf,
    )


def _empty_treelets():
    """1-row dummies marking "tiered view absent" (top_child_count[0,0]=0)."""
    return dict(
        top_child_node=np.full((1, 2), -1, dtype=np.int32),
        top_child_ref=np.zeros((1, 2), dtype=np.int32),
        top_child_count=np.zeros((1, 2), dtype=np.int32),
        tre_child_node=np.full((1, 1, 2), -1, dtype=np.int32),
        tre_child_ref=np.zeros((1, 1, 2), dtype=np.int32),
        tre_child_count=np.zeros((1, 1, 2), dtype=np.int32),
        tre_leaf_src=np.full((1, 1), -1, dtype=np.int32),
    )


def _collapse_bvh8(child_node: np.ndarray, child_ref: np.ndarray,
                   child_count: np.ndarray):
    """Collapse the BVH2 child table into 8-wide nodes.

    Classic BVH2 -> BVH8 collapse: each wide node starts from a binary node's
    two children and greedily expands the internal child with the largest
    leaf-subtree until 8 slots are filled (largest-first keeps the tree
    balanced, minimizing depth). Children that stay internal become new wide
    nodes. Padding slots carry node id -1 (inverted box on device — never
    hit).

    Dedicated wide-leaf layout (round-3): every BVH2 leaf is a child of
    exactly one wide node, so the leaf table can be PERMUTED so each wide
    node's leaf children occupy a contiguous row range [leaf_start,
    leaf_start + leaf_n). The wide walk then processes one node's leaf hits
    as a single dense row loop under the union of the hit leaf children's
    masks — no per-child leaf refs, no per-child conds (the round-2 BVH8
    loss mode). Emits bvh8_leaf_perm (original leaf row per permuted row)
    plus per-node start/count."""
    ni = child_node.shape[0]

    # leaf counts per inner node (iterative reverse-BFS accumulation)
    sizes = np.ones(ni, dtype=np.int64)
    order = []
    stack = [0]
    seen = set()
    while stack:
        n = stack.pop()
        if n in seen:
            continue
        seen.add(n)
        order.append(n)
        for c in range(2):
            if child_count[n, c] < 0:
                stack.append(int(child_ref[n, c]))
    for n in reversed(order):
        s = 0
        for c in range(2):
            if child_node[n, c] < 0:
                continue
            if child_count[n, c] < 0:
                s += sizes[int(child_ref[n, c])]
            else:
                s += 1
        sizes[n] = max(s, 1)

    w_node, w_ref, w_count = [], [], []
    leaf_start, leaf_n = [], []  # per wide node, into the permuted leaf table
    leaf_perm = []  # permuted row -> original leaf-table row
    index_of = {0: 0}
    w_node.append(None)
    w_ref.append(None)
    w_count.append(None)
    leaf_start.append(0)
    leaf_n.append(0)
    queue = [0]
    while queue:
        b2 = queue.pop(0)
        slot = index_of[b2]
        # entries: (unified_node_id, bvh2_ref_or_leaf_ref, count)
        entries = [
            (int(child_node[b2, c]), int(child_ref[b2, c]), int(child_count[b2, c]))
            for c in range(2)
            if child_node[b2, c] >= 0
        ]
        while len(entries) < 8:
            internal = [e for e in entries if e[2] < 0]
            if not internal:
                break
            # expand the internal entry with the largest subtree
            pick = max(internal, key=lambda e: sizes[e[1]])
            entries.remove(pick)
            for c in range(2):
                if child_node[pick[1], c] >= 0:
                    entries.append(
                        (int(child_node[pick[1], c]), int(child_ref[pick[1], c]),
                         int(child_count[pick[1], c]))
                    )
            if len(entries) > 8:  # over-expanded: revert and stop
                for c in range(2):
                    if child_node[pick[1], c] >= 0:
                        entries.pop()
                entries.append(pick)
                break
        # leaf children first (contiguous rows in the permuted leaf table),
        # then internal children
        nodes8, refs8, counts8 = [], [], []
        leaf_start[slot] = len(leaf_perm)
        for node_id, ref, count in entries:
            if count >= 0:  # leaf: claim the next permuted row
                refs8.append(len(leaf_perm))
                leaf_perm.append(ref)
                nodes8.append(node_id)
                counts8.append(count)
        leaf_n[slot] = len(leaf_perm) - leaf_start[slot]
        for node_id, ref, count in entries:
            if count < 0:  # stays internal: becomes a wide node
                if ref not in index_of:
                    index_of[ref] = len(w_node)
                    w_node.append(None)
                    w_ref.append(None)
                    w_count.append(None)
                    leaf_start.append(0)
                    leaf_n.append(0)
                    queue.append(ref)
                refs8.append(index_of[ref])
                nodes8.append(node_id)
                counts8.append(count)
        while len(nodes8) < 8:  # padding
            nodes8.append(-1)
            refs8.append(0)
            counts8.append(0)
        w_node[slot] = nodes8
        w_ref[slot] = refs8
        w_count[slot] = counts8

    if not leaf_perm:  # degenerate single-leaf tree: keep shapes nonempty
        leaf_perm = [0]
    return dict(
        bvh8_child_node=np.asarray(w_node, dtype=np.int32),
        bvh8_child_ref=np.asarray(w_ref, dtype=np.int32),
        bvh8_child_count=np.asarray(w_count, dtype=np.int32),
        bvh8_leaf_start=np.asarray(leaf_start, dtype=np.int32),
        bvh8_leaf_n=np.asarray(leaf_n, dtype=np.int32),
        bvh8_leaf_perm=np.asarray(leaf_perm, dtype=np.int32),
    )


@dataclasses.dataclass
class WorldArrays:
    """Per-frame world-space scene: what the walks and shading read.

    inner_table row: [lmin(3) lmax(3) rmin(3) rmax(3) lref rref lcnt rcnt]
    leaf_table row: [K tris x (v0 e1 e2) | K transparencies | first | count |
    K sign-encoded materials | pad to a multiple of 8]; refs and counts are
    float-encoded integers (exact below 2^24).

    Wide view: ``inner8_table`` row: [8 x (bmin(3) bmax(3)) | 8 refs | 8
    counts | leaf_start | leaf_n | pad to 72], padding slots with an
    inverted box and count 0; a node's leaf children are its slots
    0..leaf_n-1 and the ``leaf8_table`` rows leaf_start + slot, which are
    leaf_table rows permuted so that they are contiguous per wide node.

    Tiered view: ``top_table`` rows have the inner_table layout with child
    count -2 for a treelet (ref = treelet id); treelet ``t`` is the inner rows
    ``tre_inner[t]`` (treelet-local refs) and the leaf rows ``tre_leaf[t]``
    (copies of leaf_table rows, so ``first`` stays the global triangle id).
    ``tiered`` is set when the pack built the treelet view.

    Miss-link view: ``records`` row = [bmin(3) bmax(3) | left_first, count,
    miss (float-encoded, exact below 2^24) | K leaf triangles x (v0 e1 e2) |
    K transparencies | K sign-encoded materials | pad to a multiple of 8],
    one per unified node (TLAS and BLAS copies stitched, packing
    ._build_unified); internal nodes have count -1 and zero triangles.
    K7's device form of them (``misslink_tables``): ``ml_nodes`` row =
    [bmin(3) bmax(3) | left_first, (count + 1) << 24 | (miss + 1)], the last
    two int32 bit patterns stored in the float32 row; ``ml_tris`` row (per
    world triangle) = [v0(3) transparency | e1(3) encoded material | e2(3)
    0]. A leaf's triangles are rows left_first .. left_first + count - 1."""

    tri_v0: torch.Tensor  # (Tw, 3) f32 world space
    tri_e1: torch.Tensor  # (Tw, 3) f32
    tri_e2: torch.Tensor  # (Tw, 3) f32
    tri_mat: torch.Tensor  # (Tw,) i32 (instance override applied)
    tri_inst: torch.Tensor  # (Tw,) i32
    tri_nsign: torch.Tensor  # (Tw,) f32 +-1: orientation of the instance
    inner_table: torch.Tensor  # (Ni, 16) f32
    leaf_table: torch.Tensor  # (L, W2) f32
    materials: torch.Tensor  # (M, 8) f32
    lights: torch.Tensor  # (L, 8) f32
    leaf_k: int = 4
    tree_depth: int = 0  # BVH2 inner depth (0 = unknown)
    top_table: Optional[torch.Tensor] = None  # (Nt, 16) f32
    tre_inner: Optional[torch.Tensor] = None  # (Tt, SI, 16) f32
    tre_leaf: Optional[torch.Tensor] = None  # (Tt, SL, W2) f32
    tiered: bool = False
    top_depth: int = 0  # top-tree inner depth (0 = unknown)
    records: Optional[torch.Tensor] = None  # (Nu, W) f32, see above
    treelet_depth: int = 0  # deepest treelet's inner depth (0 = unknown)
    inner8_table: Optional[torch.Tensor] = None  # (N8, 72) f32
    leaf8_table: Optional[torch.Tensor] = None  # (L8, W2) f32
    wide_depth: int = 0  # levels of the wide tree (0 = unknown)
    wide_stack: int = 0  # stack entries the wide walks can need (0 = unknown)
    ml_nodes: Optional[torch.Tensor] = None  # (Nu, 8) f32, see above
    ml_tris: Optional[torch.Tensor] = None  # (Tw, 12) f32, see above

    @property
    def num_lights(self) -> int:
        return int(self.lights.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v0.shape[0])


# the 8 corners of a box as (min, max) selectors per axis
_CORNER_SEL = [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)]
_BIG = 3.4e38  # the "inf" of rayzen_tpu.packing.world_geometry


def _mat3_apply(m, v):
    """Batched m @ v for m (..., 3, 3) and v (..., 3), summed j = 0, 1, 2 in
    that order as separate multiplies and adds (no fused multiply-add)."""
    return (
        m[..., :, 0] * v[..., None, 0]
        + m[..., :, 1] * v[..., None, 1]
    ) + m[..., :, 2] * v[..., None, 2]


def _box_corners(bmin, bmax):
    # _CORNER_SEL made on the device (corner k = x * 4 + y * 2 + z): a host
    # tensor would be a copy that synchronises the stream every frame
    k = torch.arange(8, device=bmin.device)
    sel = torch.stack([(k >> 2) & 1, (k >> 1) & 1, k & 1], dim=1).float()
    return bmin[:, None, :] * (1.0 - sel)[None] + bmax[:, None, :] * sel[None]


def instance_world_aabbs(arrays: SceneArrays):
    """World AABB per instance: the 8 transformed corners of each BLAS root,
    rebounded (main.cpp:975-993)."""
    corners = _box_corners(arrays.root_bmin, arrays.root_bmax)  # (I, 8, 3)
    w = _mat3_apply(arrays.transforms[:, None, :3, :3], corners)
    w = w + arrays.transforms[:, None, :3, 3]
    return w.amin(dim=1), w.amax(dim=1)


def build_scene_tlas(arrays: SceneArrays):
    """A TLAS over the instances' current world AABBs (BVH::buildTLAS
    parity), built on the host by the native builder where it is built (the
    numpy one otherwise: the same arrays). The AABBs are computed on the
    arrays' device and read back."""
    wmin, wmax = instance_world_aabbs(arrays)
    return native_build_tlas(host_array(wmin), host_array(wmax))


def _det3_sign(m):
    """Sign of det(m[:, :3, :3]) computed in float64 (only the sign is used)."""
    a = m[:, :3, :3].double()
    det = (
        a[:, 0, 0] * (a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1])
        - a[:, 0, 1] * (a[:, 1, 0] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 0])
        + a[:, 0, 2] * (a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0])
    )
    return det


def misslink_tables(records, leaf_k: int, tri_v0, tri_e1, tri_e2, tri_mat,
                    tri_nsign, materials):
    """K7's device tables (WorldArrays.ml_nodes, .ml_tris), each row a whole
    number of 16-byte loads: per unified node its record's box and its
    left_first, count and miss as int32 bit patterns (count and miss packed
    in one word); per world triangle v0, e1 and e2 with its transparency (the
    instance's material override applied) and its sign-encoded material in
    the w words: the values the records inline for the leaf's triangles
    left_first + k (a leaf holds at most ``leaf_k``)."""
    if records.shape[0] >= 1 << 24 or leaf_k >= 255:
        raise ValueError("K7's node rows encode node ids < 2^24 and counts < 255")
    meta = records[:, 6:9].to(torch.int64)  # float-encoded, exact below 2^24
    left, count, miss = meta.unbind(1)
    word = ((count + 1) << 24) | (miss + 1)
    nodes = torch.cat([records[:, :6],
                       torch.stack([left, word], 1).to(torch.int32)
                       .view(torch.float32)], dim=1)
    transp = materials[tri_mat.long(), 6]  # TRANSPARENCY column
    menc = (tri_mat.float() + 1.0) * tri_nsign
    tris = torch.cat([tri_v0, transp[:, None], tri_e1, menc[:, None], tri_e2,
                      torch.zeros_like(transp)[:, None]], dim=1)
    return nodes.contiguous(), tris.contiguous()


def world_geometry(arrays: SceneArrays) -> WorldArrays:
    """Refit the unified BVH and transform the triangles to world space, on
    the device that holds ``arrays`` (rayzen_tpu/packing.py:976-1090)."""
    dev = arrays.transforms.device
    src = arrays.wtri_src.long()
    winst = arrays.wtri_inst.long()
    rot = arrays.transforms[winst][:, :3, :3]  # (Tw, 3, 3)
    trans = arrays.transforms[winst][:, :3, 3]
    v0 = _mat3_apply(rot, arrays.tri_v0[src]) + trans
    e1 = _mat3_apply(rot, arrays.tri_e1[src])
    e2 = _mat3_apply(rot, arrays.tri_e2[src])
    # orientation sign per instance (mirroring flips cross products)
    inst_det = _det3_sign(arrays.transforms)
    tri_nsign = torch.where(inst_det[winst] < 0.0, -1.0, 1.0).float()

    # BLAS node bounds -> conservative world AABBs (8 transformed corners)
    b = arrays.node_bounds[arrays.blas_src.long()]  # (Nb, 6)
    corners = _box_corners(b[:, :3], b[:, 3:])  # (Nb, 8, 3)
    binst = arrays.blas_inst.long()
    m_rot = arrays.transforms[binst][:, :3, :3]
    m_trans = arrays.transforms[binst][:, :3, 3]
    wc = _mat3_apply(m_rot[:, None], corners) + m_trans[:, None, :]
    blas_bounds = torch.cat([wc.amin(dim=1), wc.amax(dim=1)], dim=-1)

    # TLAS node bounds from descendant instance AABBs (static masks)
    wmin, wmax = instance_world_aabbs(arrays)  # (I, 3)
    mask = arrays.tlas_mask[..., None]  # (Nt, I, 1)
    tmin = torch.where(mask, wmin[None], _BIG).amin(dim=1)
    tmax = torch.where(mask, wmax[None], -_BIG).amax(dim=1)
    tlas_bounds = torch.cat([tmin, tmax], dim=-1)
    node_bounds = torch.cat([tlas_bounds, blas_bounds], dim=0)  # (Nu, 6)

    # leaf triangles inlined per unified node, with per-triangle
    # transparency (shadow walks) and sign-encoded material (closest walks)
    nlt = arrays.node_leaf_tri.long()
    n_nodes, leaf_k = nlt.shape
    tris9 = torch.cat([v0, e1, e2], dim=1)  # (Tw, 9)
    leaf_block = tris9[nlt].reshape(n_nodes, leaf_k * 9)
    ov = arrays.inst_mat_override[winst]
    tri_mat = torch.where(ov >= 0, ov, arrays.tri_mat[src])
    wtri_transp = arrays.materials[tri_mat.long(), 6]  # TRANSPARENCY column
    transp_block = wtri_transp[nlt]  # (Nu, K)
    wtri_mat_enc = (tri_mat.float() + 1.0) * tri_nsign
    mat_block = wtri_mat_enc[nlt]  # (Nu, K)

    # miss-link records: bounds | meta | leaf triangles | transparencies |
    # materials | pad; meta ints as float values, exact only below 2^24
    if n_nodes >= 1 << 24:
        raise ValueError(f"{n_nodes} unified nodes: records encode ids < 2^24")
    records = torch.cat(
        [node_bounds, arrays.uni_meta.float(), leaf_block, transp_block,
         mat_block], dim=1)
    records = torch.nn.functional.pad(records, (0, (-records.shape[1]) % 8))
    ml_nodes, ml_tris = misslink_tables(records, leaf_k, v0, e1, e2, tri_mat,
                                        tri_nsign, arrays.materials)

    # BVH2 inner table: both children's boxes + refs + counts; padding
    # children (node id -1) get an inverted box
    cn = arrays.bvh2_child_node.long()  # (Ni, 2)
    cb = node_bounds[cn.clamp(min=0)]  # (Ni, 2, 6)
    inverted = torch.cat([torch.full((3,), _BIG, device=dev),
                          torch.full((3,), -_BIG, device=dev)])
    cb = torch.where((cn >= 0)[..., None], cb, inverted)
    inner_table = torch.cat(
        [cb[:, 0, :], cb[:, 1, :], arrays.bvh2_child_ref.float(),
         arrays.bvh2_child_count.float()],
        dim=1,
    )  # (Ni, 16)

    # BVH8 wide-node table, padded from 66 to 72 columns (16-byte rows)
    cn8 = arrays.bvh8_child_node.long()  # (N8, 8)
    cb8 = torch.where((cn8 >= 0)[..., None], node_bounds[cn8.clamp(min=0)],
                      inverted)  # (N8, 8, 6)
    inner8_table = torch.cat(
        [cb8.reshape(cn8.shape[0], 48), arrays.bvh8_child_ref.float(),
         arrays.bvh8_child_count.float(),
         arrays.bvh8_leaf_start.float()[:, None],
         arrays.bvh8_leaf_n.float()[:, None]],
        dim=1,
    )  # (N8, 66)
    inner8_table = torch.nn.functional.pad(inner8_table, (0, 6))

    leaf_nodes = arrays.bvh2_leaf_node.long()  # (L,)
    uni_meta = arrays.uni_meta
    leaf_table = torch.cat(
        [
            leaf_block[leaf_nodes],
            transp_block[leaf_nodes],
            uni_meta[leaf_nodes, 0].float()[:, None],
            uni_meta[leaf_nodes, 1].float()[:, None],
            mat_block[leaf_nodes],
        ],
        dim=1,
    )
    pad = (-leaf_table.shape[1]) % 8
    if pad:
        leaf_table = torch.nn.functional.pad(leaf_table, (0, pad))
    # the wide walks' leaf rows: the same rows, contiguous per wide node
    leaf8_table = leaf_table[arrays.bvh8_leaf_perm.long()]

    # tiered tables: the top tree in inner_table layout, and per treelet its
    # inner rows and a gather of its leaf rows; presence is a shape property
    # (the dummies are (1, 1, 2)), as in the JAX package
    tiered = int(arrays.tre_child_node.shape[1]) > 1
    tcn = arrays.top_child_node.long()  # (Nt, 2)
    tbnd = torch.where((tcn >= 0)[..., None], node_bounds[tcn.clamp(min=0)],
                       inverted)
    top_table = torch.cat(
        [tbnd[:, 0, :], tbnd[:, 1, :], arrays.top_child_ref.float(),
         arrays.top_child_count.float()],
        dim=1,
    )  # (Nt, 16)
    tn = arrays.tre_child_node.long()  # (Tt, SI, 2)
    tb2 = torch.where((tn >= 0)[..., None], node_bounds[tn.clamp(min=0)],
                      inverted)
    tre_inner = torch.cat(
        [tb2[..., 0, :], tb2[..., 1, :], arrays.tre_child_ref.float(),
         arrays.tre_child_count.float()],
        dim=-1,
    )  # (Tt, SI, 16)
    tre_leaf = leaf_table[arrays.tre_leaf_src.long().clamp(min=0)]  # (Tt, SL, W2)

    return WorldArrays(
        tri_v0=v0,
        tri_e1=e1,
        tri_e2=e2,
        tri_mat=tri_mat,
        tri_inst=arrays.wtri_inst,
        tri_nsign=tri_nsign,
        inner_table=inner_table.contiguous(),
        leaf_table=leaf_table.contiguous(),
        inner8_table=inner8_table.contiguous(),
        leaf8_table=leaf8_table.contiguous(),
        materials=arrays.materials,
        lights=arrays.lights,
        leaf_k=int(leaf_k),
        tree_depth=int(arrays.tree_depth),
        top_table=top_table.contiguous(),
        tre_inner=tre_inner.contiguous(),
        tre_leaf=tre_leaf.contiguous(),
        tiered=tiered,
        top_depth=int(arrays.top_depth),
        treelet_depth=int(arrays.treelet_depth),
        wide_depth=int(arrays.wide_depth),
        wide_stack=int(arrays.wide_stack),
        records=records.contiguous(),
        ml_nodes=ml_nodes,
        ml_tris=ml_tris,
    )
