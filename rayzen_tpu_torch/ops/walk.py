"""BVH2 closest-hit (K2) and shadow-transmission (K3) walks, their tiered
form over the treelet view (K8), the wide-node walks (K5), the
packet-frustum walks (K6) and the stackless miss-link walks (K7).

Counterpart of rayzen_tpu/ops/pallas_traverse.py: ``closest_hit_bvh2`` /
``shadow_walk_bvh2`` replace ``pallas_closest_hit_bvh2`` (:1338) and
``pallas_shadow_walk_bvh2`` (:1350); ``closest_hit_frustum`` /
``shadow_walk_frustum`` replace ``pallas_closest_hit_frustum`` (:1361) and
``pallas_shadow_walk_frustum`` (:1370); ``closest_hit_tiered`` /
``shadow_walk_tiered`` launch ``tiered_walk_closest`` (:796) /
``tiered_walk_shadow`` (:879) and ``closest_hit_bvh8`` / ``shadow_walk_bvh8``
launch ``bvh8_walk_closest`` (:617) / ``bvh8_walk_shadow`` (:728), which the
JAX package runs only inside its sample kernel; ``closest_hit_misslink`` /
``shadow_walk_misslink`` replace ``pallas_closest_hit`` (:1381) and
``pallas_shadow_walk`` (:1405). For CUDA tensors each
wrapper launches its kernel (csrc/walk_kernels.cu); for CPU tensors it runs
the plain PyTorch version below. The plain versions run on any device, so
the kernels can be held against them on the card. Every kernel but K6's
walks only the live rays of its wave (and a whole frame's rays in K1's warp
tiles, when the wrapper is given the frame's width and height); each ray's
walk is its own, so the order in which a kernel takes them changes no
result. K6 takes the same map, and its packets are its warps.

The BVH2 forms walk each ray's own depth-first, left-first path through the
tables with t pruning, exactly as csrc/walk.cuh does; see there why that
reproduces the Pallas packet walk's hits. The plain versions carry one stack
per ray and advance all unfinished rays one node per step; the tiered ones
hold top-tree and treelet entries on that one stack, as the kernel does,
and walk the flattened treelet tables with each ray's refs offset by its
treelet's first row, so rays at either level share one loop. The wide
walk does the same over the 8-wide nodes (csrc/walk.cuh says in which
order). The frustum walk is a packet walk, as csrc/frustum.cuh: one stack
per packet (the kernel's warp), all packets advancing one node per step. The miss-link walk needs no stack: a
ray's state is its node, and all unfinished rays advance one node per step.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from .. import ext
from ..packing import WorldArrays
from .intersect import T_FAR, cross3, moller_trumbore_raw, safe_inv, slab_test

STACK_DEPTH = ext.STACK_DEPTH  # the plain versions use the kernels' stack

@dataclasses.dataclass
class Work:
    """Instrumentation: pass one as ``work=`` to a plain walk (or a plain
    sample) and it counts the data-dependent work of the same walks in the
    kernels: the BVH2 inner (and top-tree) node visits of a ray, one per
    popped node; the wide-node visits of a ray (K5: 8 child boxes each);
    the frustum node visits of a packet (K6: two interval box tests each,
    done once per packet); the miss-link node visits of a ray (K7: one box
    test each), and the most of them that one ray makes (``ml_chain``: the
    length of the longest chain of dependent node loads of a K7 walk); and
    the triangle tests, one per triangle of each leaf a ray walks (min(count,
    K), as the kernels loop)."""

    nodes: int = 0
    nodes8: int = 0
    packet_nodes: int = 0
    ml_nodes: int = 0
    ml_chain: int = 0  # a maximum over the walks, not a sum
    tris: int | torch.Tensor = 0  # summed on the walk's device

    def counts(self) -> dict:
        return {"nodes": int(self.nodes), "nodes8": int(self.nodes8),
                "packet_nodes": int(self.packet_nodes),
                "ml_nodes": int(self.ml_nodes), "ml_chain": int(self.ml_chain),
                "tris": int(self.tris)}


@dataclasses.dataclass
class Hit:
    """Closest-hit record (rayzen_tpu.ops.traverse.Hit plus the raw walk
    outputs)."""

    t: torch.Tensor  # (R,) world distance, T_FAR if none
    point: torch.Tensor  # (R, 3)
    tri: torch.Tensor  # (R,) i32 world triangle, -1 if none
    inst: torch.Tensor  # (R,) i32 instance, -1 if none
    found: torch.Tensor  # (R,) bool
    normal: torch.Tensor  # (R, 3) unit geometric normal, orientation-corrected
    mat: torch.Tensor  # (R,) i32 material, -1 if none
    cross: torch.Tensor  # (R, 3) unnormalized cross(e1, e2) of the hit
    menc: torch.Tensor  # (R,) (mat + 1) * orientation, 0 if none


def _check_stack(what: str, depth: int) -> None:
    """A single-pop walk needs depth + 1 stack slots (0 = unknown depth: the
    walks then NaN-poison a result whose stack would overflow)."""
    if depth and depth + 1 > STACK_DEPTH:
        raise ValueError(
            f"{what} depth {depth} needs {depth + 1} stack entries; the "
            f"walks hold {STACK_DEPTH}"
        )


def check_depth(ws: WorldArrays) -> None:
    """The whole-tree walks' (K2/K3) stack bound."""
    _check_stack("BVH", ws.tree_depth)


# The tiered walks hold both levels' entries on one stack of 2 * STACK_DEPTH
# (csrc/walk.cuh kTieredStack). An entry is a top node (< TREELET_NODE), a
# node of the ray's current treelet (TREELET_NODE + its local row) or a
# treelet's root (~tid).
TREELET_NODE = 1 << 30


def tiered_stack_need(top_depth: int, treelet_depth: int) -> int:
    """The most entries the one stack of the tiered walks (K8) holds, with
    the top tree ``top_depth`` levels deep and the deepest treelet
    ``treelet_depth`` (packing.tiered_depths; 0 = unknown, and so is the
    need). A top node of level l pops with at most l - 1 entries below it
    (one pending sibling per level above it), pushes its two children
    (internal nodes or treelet roots) and pops the left one; a treelet's
    walk from its root then holds at most treelet_depth entries above the
    l left below. So the need is top_depth + treelet_depth; a walk of the
    top tree alone holds at most top_depth."""
    if not (top_depth and treelet_depth):
        return 0
    return top_depth + treelet_depth


def check_tiered(ws: WorldArrays) -> None:
    """The tiered walks (K8) need the treelet view, and their one stack
    (2 * STACK_DEPTH entries) tiered_stack_need (0 = unknown: the walks then
    NaN-poison a result whose stack would overflow)."""
    if not ws.tiered:
        raise ValueError(
            "the scene has no treelet view: pack it with tiered='on', or "
            "'auto' past packing.SINGLE_TREE_VMEM_BUDGET"
        )
    need = tiered_stack_need(ws.top_depth, ws.treelet_depth)
    if need > 2 * STACK_DEPTH:
        raise ValueError(
            f"top-tree depth {ws.top_depth} and treelet depth "
            f"{ws.treelet_depth} need {need} stack entries; the tiered walks "
            f"hold {2 * STACK_DEPTH}"
        )


def check_wide(ws: WorldArrays) -> None:
    """The wide walks (K5) push up to 8 children per pop: they need
    ws.wide_stack slots (packing.wide_stack_bound; 0 = unknown: the walks
    then NaN-poison a result whose stack would overflow)."""
    if ws.inner8_table is None or ws.leaf8_table is None:
        raise ValueError("the scene has no wide tables (inner8_table, leaf8_table)")
    if ws.wide_stack > STACK_DEPTH:
        raise ValueError(
            f"the wide tree ({ws.wide_depth} levels) needs {ws.wide_stack} "
            f"stack entries; the walks hold {STACK_DEPTH}"
        )


def check_walks(ws: WorldArrays, wide: bool = False) -> None:
    """The depth check of the view the kernels walk (see plain_walks)."""
    if ws.tiered:
        check_tiered(ws)
    elif wide:
        check_wide(ws)
    else:
        check_depth(ws)


# ---- plain PyTorch versions ---------------------------------------------


def _rays9(origin, direction):
    """(n, 9) [o | d | 1/d] rows, gathered per step by the plain walks."""
    return torch.cat([origin, direction, safe_inv(direction)], dim=1)


def _slab(r, b):
    """pallas_traverse._slab for rays r (n, 9) against boxes b (n, 6):
    (tmin, hit)."""
    tmin, _tmax, hit = slab_test(r[:, 0:3], r[:, 6:9], b[:, 0:3], b[:, 3:6])
    return tmin, hit


def _moller_trumbore(r, tri):
    """pallas_traverse._mt_broadcast for rays r (n, 1, 9) against leaf
    triangles tri (n, K, 9) = [v0 e1 e2]; returns t, hit (n, K)."""
    return moller_trumbore_raw(r[..., 0:3], r[..., 3:6], tri[..., 0:3],
                               tri[..., 3:6], tri[..., 6:9])


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where a row keeps its leaf: the K triangles (9 floats each) from
    column ``tris``, then K transparencies; the first triangle id and the
    count in columns ``first`` and ``count``; K encoded materials from
    column ``mats``."""

    tris: int
    first: int
    count: int
    mats: int

    @staticmethod
    def leaf_table(K: int) -> "_Layout":
        return _Layout(0, 10 * K, 10 * K + 1, 10 * K + 2)

    @staticmethod
    def records(K: int) -> "_Layout":
        return _Layout(9, 6, 7, 9 + 10 * K)


def _leaf_rows(leaf, K, leaf_idx, lay: _Layout):
    """(rows, triangles (n, K, 9), first, count) of the leaf rows."""
    rows = leaf[leaf_idx]
    tris = rows[:, lay.tris: lay.tris + 9 * K].reshape(-1, K, 9)
    return (rows, tris, rows[:, lay.first].to(torch.int32),
            rows[:, lay.count].to(torch.int32))


def _leaf_closest(leaf, K, leaf_idx, r, sel, state, lay: _Layout):
    """bvh2_walk_closest.leaf_proc (and the miss-link kernel's leaf) for the
    rays ``sel`` (r = their rows)."""
    t_best, tri_best, cross, menc = state
    rows, tris, first, count = _leaf_rows(leaf, K, leaf_idx, lay)
    t, h = _moller_trumbore(r[:, None, :], tris)
    cr = cross3(tris[..., 3:6], tris[..., 6:9])  # (n, K, 3)
    tb, tr, cx, me = t_best[sel], tri_best[sel], cross[sel], menc[sel]
    for k in range(K):
        better = h[:, k] & (t[:, k] < tb) & (count > k)
        tb = torch.where(better, t[:, k], tb)
        tr = torch.where(better, first + k, tr)
        cx = torch.where(better[:, None], cr[:, k], cx)
        me = torch.where(better, rows[:, lay.mats + k], me)
    t_best[sel], tri_best[sel], cross[sel], menc[sel] = tb, tr, cx, me


def _leaf_shadow(leaf, K, leaf_idx, r, maxd, t_eps, vis, lay: _Layout,
                 factors=None):
    """bvh2_walk_shadow.leaf_proc; returns the updated vis of those rays.
    The factor of a blocker is its row's transparency, or ``factors(first,
    count)`` (n, K) where given."""
    rows, tris, first, count = _leaf_rows(leaf, K, leaf_idx, lay)
    t, h = _moller_trumbore(r[:, None, :], tris)
    f = (rows[:, lay.tris + 9 * K: lay.tris + 10 * K] if factors is None
         else factors(first, count))
    for k in range(K):
        blocking = h[:, k] & (t[:, k] >= t_eps) & (t[:, k] < maxd) & (count > k)
        vis = torch.where(blocking, vis * f[:, k], vis)
    return vis


def _push(stack, sp, ids, sp_l, row, hitl, hitr):
    """Push hit internal children (count -1), left on top, onto the stacks
    of the rays ``ids`` (``sp_l``: their stack pointers before the push).
    Returns the overflow mask (those rays push nothing)."""
    lref, rref = row[:, 12].long(), row[:, 13].long()
    push_l = hitl & (row[:, 14] == -1)
    push_r = hitr & (row[:, 15] == -1)
    npush = push_l.long() + push_r.long()
    ovf = sp_l + npush > STACK_DEPTH
    both = push_l & push_r
    first = torch.where(both, rref, torch.where(push_l, lref, rref))
    w1 = ~ovf & (npush >= 1)
    stack[ids[w1], sp_l[w1]] = first[w1]
    w2 = ~ovf & both
    stack[ids[w2], sp_l[w2] + 1] = lref[w2]
    sp[ids] = sp_l + torch.where(ovf, 0, npush)
    return ovf


def _stacks(n, rays, dev):
    """(stack, sp) for n rays, indexed by ray id: the rays ``rays`` hold the
    root row 0, the others nothing."""
    sp = torch.zeros((n,), dtype=torch.long, device=dev)
    sp[rays] = 1
    return torch.zeros((n, STACK_DEPTH), dtype=torch.long, device=dev), sp


def _boxes(r, row, bound):
    """Both children's box tests of the rows, bounded by ``bound``."""
    tminl, boxl = _slab(r, row[:, 0:6])
    tminr, boxr = _slab(r, row[:, 6:12])
    return boxl & (tminl <= bound), boxr & (tminr <= bound)


@dataclasses.dataclass
class _Walk:
    """What a walk keeps per ray and does at a leaf (all indexed by ray id):
    ``bound(ids)`` prunes the box tests, ``leaves(leaf, K, li, r, ids)`` runs
    leaf rows ``li``, ``stop(ids)`` ends a ray early, ``poison(ids)`` marks a
    stack overflow; ``work`` counts the steps, if given."""

    bound: Callable
    leaves: Callable
    stop: Callable
    poison: Callable
    work: Work | None = None


def _closest_ops(state, work=None, records: bool = False) -> _Walk:
    """The closest-hit walk on state = (t_best, tri, cross, menc), whose
    leaves are leaf-table rows (or, with ``records``, record rows)."""
    t_best, _tri, _cross, menc = state
    lay = _Layout.records if records else _Layout.leaf_table

    def leaves(leaf, K, li, r, ids):
        _leaf_closest(leaf, K, li, r, ids, state, lay(K))

    def poison(ids):
        t_best[ids] = float("nan")
        menc[ids] = float("nan")

    return _Walk(lambda ids: t_best[ids], leaves,
                 lambda ids: torch.zeros_like(ids, dtype=torch.bool), poison,
                 work)


def _shadow_ops(vis, maxd, min_visibility, t_eps, work=None,
                records: bool = False, factors=None) -> _Walk:
    """The transmission walk multiplying into ``vis``; a ray stops once its
    vis drops to min_visibility. Leaves as in _closest_ops; ``factors``
    see _leaf_shadow."""
    lay = _Layout.records if records else _Layout.leaf_table

    def leaves(leaf, K, li, r, ids):
        vis[ids] = _leaf_shadow(leaf, K, li, r, maxd[ids], t_eps, vis[ids],
                                lay(K), factors)

    def poison(ids):
        vis[ids] = float("nan")

    return _Walk(lambda ids: maxd[ids], leaves,
                 lambda ids: ~(vis[ids] > min_visibility), poison, work)


def _step(w: _Walk, inner, leaf, K, r_all, ids, stack, sp):
    """One node for each ray of ``ids``: pop it, test both children's boxes,
    run the hit leaf children (left first), push the hit internal children
    (left on top). Returns the rays that stop: by ``w.stop`` (before
    pushing) or by a stack overflow (poisoned)."""
    sp_l = sp[ids] - 1
    row = inner[stack[ids, sp_l]]
    r = r_all[ids]
    hitl, hitr = _boxes(r, row, w.bound(ids))
    if w.work is not None:
        w.work.nodes += ids.numel()
    _leaf_children(w, leaf, K, r, ids, row, hitl, hitr)
    stop = w.stop(ids)
    ovf = _push(stack, sp, ids, sp_l, row, hitl & ~stop, hitr & ~stop)
    if ovf.any():  # never write past the stack: poison and stop
        w.poison(ids[ovf])
    return stop | ovf


def _leaf_children(w: _Walk, leaf, K, r, ids, row, hitl, hitr, lbase=None):
    """Run the hit leaf children of the rows (left, then right) for the rays
    ``ids`` (r = their rows); ``lbase`` offsets the leaf refs (a treelet's
    first leaf row in the flattened tiered tables)."""
    for hit, ref, cnt in ((hitl, row[:, 12], row[:, 14]),
                          (hitr, row[:, 13], row[:, 15])):
        m = hit & (cnt >= 0)
        if m.any():
            li = ref[m].long()
            if lbase is not None:
                li = li + lbase[m]
            if w.work is not None:
                w.work.tris = w.work.tris + leaf[li, 10 * K + 1].clamp(
                    max=K).sum(dtype=torch.int64)
            w.leaves(leaf, K, li, r[m], ids[m])


def _walk(w: _Walk, inner, leaf, K, r_all, rays, step=_step):
    """Whole-tree walk (K2/K3, or with step=_step8 K5) of the ray ids
    ``rays``. One stack per ray; all unfinished rays advance one node per
    step."""
    stack, sp = _stacks(r_all.shape[0], rays, r_all.device)
    live = rays
    while live.numel():
        stop = step(w, inner, leaf, K, r_all, live, stack, sp)
        live = live[~stop & (sp[live] > 0)]


# the descending 19-comparator network over 8 keys that orders a wide
# node's pushes (pallas_traverse.py:681-683; csrc/walk.cuh sort8)
SORT8 = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
         (1, 2), (5, 6), (0, 4), (3, 7), (1, 5), (2, 6), (1, 4), (3, 6),
         (2, 4), (3, 5), (3, 4))


def _wide_children(r, row, bound):
    """The 8 child slots of wide rows ``row`` (n, 72) for rays r (n, 9):
    (tmin, hit, leaf, internal), each (n, 8). Slot ch is a leaf child when
    ch < leaf_n, internal when its count is -1, padding otherwise; padding
    (whose inverted box the slab test would pass) is never hit."""
    n = row.shape[0]
    boxes = row[:, :48].reshape(n * 8, 6)
    rr = r[:, None, :].expand(n, 8, r.shape[1]).reshape(n * 8, -1)
    tmin, box = _slab(rr, boxes)
    tmin, box = tmin.reshape(n, 8), box.reshape(n, 8)
    slot = torch.arange(8, device=row.device)
    leaf = slot[None, :] < row[:, 65, None]
    internal = row[:, 56:64] < 0
    hit = box & (tmin <= bound[:, None]) & (leaf | internal)
    return tmin, hit, leaf, internal


def _sort8(keys, refs, push):
    """SORT8 on the columns of (n, 8) keys, carrying refs and push: larger
    key first, swapping only where keys[i] < keys[j]."""
    keys, refs, push = keys.clone(), refs.clone(), push.clone()
    for i, j in SORT8:
        sw = keys[:, i] < keys[:, j]
        for a in (keys, refs, push):
            ai, aj = a[:, i].clone(), a[:, j]
            a[:, i] = torch.where(sw, aj, ai)
            a[:, j] = torch.where(sw, ai, aj)
    return refs, push


def _make_step8(ordered: bool):
    """One wide node for each ray of ``ids``: pop it, test its 8 child
    boxes against the bound of the node's start, run the hit leaf children
    in slot order (leaf8 row leaf_start + slot), then push the hit internal
    children: ``ordered`` (closest) sorted by the ray's own entry distance
    so that the nearest is on top, else in slot order (the last on top).
    Returns the rays that stop (w.stop after the leaves, or an overflow)."""

    def step8(w: _Walk, inner8, leaf8, K, r_all, ids, stack, sp):
        sp_l = sp[ids] - 1
        row = inner8[stack[ids, sp_l]]
        r = r_all[ids]
        tmin, hit, leaf, internal = _wide_children(r, row, w.bound(ids))
        if w.work is not None:
            w.work.nodes8 += ids.numel()
        lstart = row[:, 64].long()
        for ch in range(8):
            m = hit[:, ch] & leaf[:, ch]
            if m.any():
                li = lstart[m] + ch
                if w.work is not None:
                    w.work.tris = w.work.tris + leaf8[li, 10 * K + 1].clamp(
                        max=K).sum(dtype=torch.int64)
                w.leaves(leaf8, K, li, r[m], ids[m])
        stop = w.stop(ids)
        push = hit & internal & ~stop[:, None]
        refs = row[:, 48:56].long()
        if ordered:
            keys = torch.where(push, tmin, float("-inf"))
            refs, push = _sort8(keys, refs, push)
        npush = push.sum(1)
        ovf = sp_l + npush > STACK_DEPTH
        pos = sp_l[:, None] + push.long().cumsum(1) - 1
        wr = push & ~ovf[:, None]
        stack[ids[:, None].expand_as(pos)[wr], pos[wr]] = refs[wr]
        sp[ids] = sp_l + torch.where(ovf, 0, npush)
        if ovf.any():  # never write past the stack: poison and stop
            w.poison(ids[ovf])
        return stop | ovf

    return step8


_step8_closest, _step8_shadow = _make_step8(True), _make_step8(False)


def _walk_tiered(w: _Walk, ws: WorldArrays, r_all, rays):
    """K8's walk of the ray ids ``rays`` as one vectorised loop over both
    levels, as csrc/walk.cuh walk_tiered: one stack of 2 * STACK_DEPTH
    tagged entries per ray (a top node, a node of the ray's current treelet, a
    treelet's root), one node per step for every unfinished ray. A top pop
    tests both boxes against the bound of the moment and pushes the hit
    internal children (left on top), then the hit right treelet's root,
    then the left one's; a treelet pop is the K2 step on the flattened
    treelet tables, offset by the ray's treelet."""
    n, dev = r_all.shape[0], r_all.device
    inner, leaf, si, sl = _treelet_rows(ws)
    cap = 2 * STACK_DEPTH
    stack = torch.zeros((n, cap), dtype=torch.long, device=dev)  # top root 0
    sp = torch.zeros((n,), dtype=torch.long, device=dev)
    sp[rays] = 1
    tid = torch.zeros_like(sp)  # the treelet of each ray's local entries
    live = rays
    while live.numel():
        sp_l = sp[live] - 1
        e = stack[live, sp_l]
        root = e < 0
        tre = root | (e >= TREELET_NODE)
        tid[live[root]] = ~e[root]
        t_of = tid[live]
        local = torch.where(root, 0, torch.where(tre, e - TREELET_NODE, e))
        row = torch.empty((live.numel(), 16), dtype=ws.top_table.dtype,
                          device=dev)
        row[~tre] = ws.top_table[local[~tre]]
        row[tre] = inner[t_of[tre] * si + local[tre]]
        r = r_all[live]
        hitl, hitr = _boxes(r, row, w.bound(live))
        if w.work is not None:
            w.work.nodes += live.numel()
        _leaf_children(w, leaf, ws.leaf_k, r[tre], live[tre], row[tre],
                       hitl[tre], hitr[tre], t_of[tre] * sl)
        stop = w.stop(live)
        # the pushes, bottom to top: right internal, left internal, right
        # treelet root, left treelet root
        lref, rref = row[:, 12].long(), row[:, 13].long()
        lcnt, rcnt = row[:, 14], row[:, 15]
        tag = torch.where(tre, TREELET_NODE, 0)
        push = torch.stack([hitr & (rcnt == -1), hitl & (lcnt == -1),
                            hitr & (rcnt == -2), hitl & (lcnt == -2)], 1)
        push &= ~stop[:, None]
        vals = torch.stack([rref + tag, lref + tag, ~rref, ~lref], 1)
        npush = push.sum(1)
        ovf = sp_l + npush > cap
        pos = sp_l[:, None] + push.long().cumsum(1) - 1
        wr = push & ~ovf[:, None]
        stack[live[:, None].expand_as(pos)[wr], pos[wr]] = vals[wr]
        sp[live] = sp_l + torch.where(ovf, 0, npush)
        if ovf.any():  # never write past the stack: poison and stop
            w.poison(live[ovf])
        live = live[~stop & ~ovf & (sp[live] > 0)]


def _closest_state(n, dev, t_init):
    """(t_best, tri, cross, menc) before any hit."""
    t_best = (
        torch.full((n,), T_FAR, dtype=torch.float32, device=dev)
        if t_init is None else t_init.to(torch.float32).clone()
    )
    return (t_best, torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros((n, 3), dtype=torch.float32, device=dev),
            torch.zeros((n,), dtype=torch.float32, device=dev))


def _max_dist(max_dist, n, dev):
    return torch.broadcast_to(
        torch.as_tensor(max_dist, dtype=torch.float32, device=dev), (n,)
    )


def closest_walk_reference(ws: WorldArrays, origin, direction, active,
                           t_init=None, work: Work | None = None):
    """Plain closest-hit walk (K2). Returns (t, tri, cross (R, 3), menc)."""
    check_depth(ws)
    state = _closest_state(origin.shape[0], origin.device, t_init)
    _walk(_closest_ops(state, work), ws.inner_table, ws.leaf_table, ws.leaf_k,
          _rays9(origin, direction), active.nonzero()[:, 0])
    return state


def _shadow_setup(origin, max_dist, active, min_visibility):
    """(vis, maxd, the ray ids that walk) of a transmission walk."""
    n, dev = origin.shape[0], origin.device
    vis = torch.ones((n,), dtype=torch.float32, device=dev)
    rays = (active & (vis > min_visibility)).nonzero()[:, 0]
    return vis, _max_dist(max_dist, n, dev), rays


def shadow_walk_reference(ws: WorldArrays, origin, direction, max_dist,
                          active, min_visibility: float = 0.05,
                          t_eps: float = 1e-3, work: Work | None = None):
    """Plain transmission walk (K3). Returns vis (R,), 1 for inactive rays."""
    check_depth(ws)
    vis, maxd, rays = _shadow_setup(origin, max_dist, active, min_visibility)
    _walk(_shadow_ops(vis, maxd, min_visibility, t_eps, work), ws.inner_table,
          ws.leaf_table, ws.leaf_k, _rays9(origin, direction), rays)
    return vis


def wide_closest_walk_reference(ws: WorldArrays, origin, direction, active,
                               work: Work | None = None):
    """Plain K5 closest-hit walk over the wide tables (inner8_table,
    leaf8_table). Returns (t, tri, cross (R, 3), menc)."""
    check_wide(ws)
    state = _closest_state(origin.shape[0], origin.device, None)
    _walk(_closest_ops(state, work), ws.inner8_table, ws.leaf8_table,
          ws.leaf_k, _rays9(origin, direction), active.nonzero()[:, 0],
          step=_step8_closest)
    return state


def wide_shadow_walk_reference(ws: WorldArrays, origin, direction, max_dist,
                               active, min_visibility: float = 0.05,
                               t_eps: float = 1e-3, work: Work | None = None):
    """Plain K5 transmission walk. Returns vis (R,), 1 for inactive rays."""
    check_wide(ws)
    vis, maxd, rays = _shadow_setup(origin, max_dist, active, min_visibility)
    _walk(_shadow_ops(vis, maxd, min_visibility, t_eps, work),
          ws.inner8_table, ws.leaf8_table, ws.leaf_k,
          _rays9(origin, direction), rays, step=_step8_shadow)
    return vis


# ---- K6: the packet-frustum walks (pallas_traverse.py:948-1190) ----------

PACKET = 32  # rays per frustum packet: one warp


def _frame_packets(origin, packet_ids, width, height):
    """The packets of a K6 plain walk: ``packet_ids`` if given, else on a
    whole width x height frame the kernel's, the warps of the live-ray
    launches' map (K1's 8 x 4 warp tiles, megakernel.pixel_warps), else
    None (ray id // packet)."""
    from .megakernel import pixel_warps  # (megakernel imports this module)

    n = origin.shape[0]
    if packet_ids is None and width and width * height == n:
        return pixel_warps(n, width, height, origin.device)
    return packet_ids


def _interval_inv(dlo, dhi):
    """pallas_traverse._interval_inv: [1/d] for d in [dlo, dhi]; an
    interval spanning 0 gives (-1e30, 1e30)."""
    pos, neg = dlo > 0.0, dhi < 0.0
    lo = torch.where(pos, 1.0 / dhi, torch.where(neg, 1.0 / dlo, -1e30))
    hi = torch.where(pos, 1.0 / dlo, torch.where(neg, 1.0 / dhi, 1e30))
    return lo, hi


def _interval_mul(alo, ahi, blo, bhi):
    """pallas_traverse._interval_mul, with fmin/fmax (NaN-ignoring, as the
    kernel's fminf/fmaxf)."""
    p1, p2, p3, p4 = alo * blo, alo * bhi, ahi * blo, ahi * bhi
    return (torch.fmin(torch.fmin(p1, p2), torch.fmin(p3, p4)),
            torch.fmax(torch.fmax(p1, p2), torch.fmax(p3, p4)))


def _frustum_box_test(fr, b, t_bound):
    """pallas_traverse._frustum_box_test (with _frustum_slab_axis) for
    packets with frustums fr = (olo, ohi, ilo, ihi), each (n, 3), against
    boxes b (n, 6): (possible (n,), entry_lo (n,))."""
    olo, ohi, ilo, ihi = fr
    entry = torch.full_like(b[:, 0], -3.4e38)
    exit_ = torch.full_like(b[:, 0], 3.4e38)
    for ax in range(3):
        t0lo, t0hi = _interval_mul(b[:, ax] - ohi[:, ax], b[:, ax] - olo[:, ax],
                                   ilo[:, ax], ihi[:, ax])
        t1lo, t1hi = _interval_mul(b[:, 3 + ax] - ohi[:, ax],
                                   b[:, 3 + ax] - olo[:, ax],
                                   ilo[:, ax], ihi[:, ax])
        entry = torch.fmax(entry, torch.fmin(t0lo, t1lo))
        exit_ = torch.fmin(exit_, torch.fmax(t0hi, t1hi))
    return (exit_ >= torch.fmax(entry, torch.zeros_like(entry))) & (entry <= t_bound), entry


def _packets(active, packet: int, packet_ids=None):
    """The packets of the active rays: (members (P, M) ray ids, -1 padded;
    valid (P, M)). A packet is the active rays with one packet id: by
    default ``ray id // packet``; ``packet_ids`` (R,) gives it per ray."""
    ids = active.nonzero()[:, 0]
    key = ids // packet if packet_ids is None else packet_ids[ids]
    key, order = torch.sort(key, stable=True)
    ids = ids[order]
    _, counts = torch.unique_consecutive(key, return_counts=True)
    n_p = counts.numel()
    m = int(counts.max()) if n_p else 0
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(ids.numel(), device=ids.device) - start.repeat_interleave(counts)
    members = torch.full((n_p, m), -1, dtype=torch.long, device=ids.device)
    members[torch.arange(n_p, device=ids.device).repeat_interleave(counts), pos] = ids
    return members, members >= 0


def _packet_frustum(origin, direction, members, valid):
    """pallas_traverse._packet_frustum over each packet's active rays:
    (olo, ohi, ilo, ihi), each (P, 3)."""
    big = torch.tensor(float("inf"), device=origin.device)
    at = members.clamp(min=0)
    o, d = origin[at], direction[at]  # (P, M, 3)
    v = valid[..., None]
    lo = lambda x: torch.where(v, x, big).amin(1)  # noqa: E731
    hi = lambda x: torch.where(v, x, -big).amax(1)  # noqa: E731
    ilo, ihi = _interval_inv(lo(d), hi(d))
    return lo(o), hi(o), ilo, ihi


def _packet_max(x, members, valid, fill):
    """Per packet, the max of x (R,) over its active rays."""
    return torch.where(valid, x[members.clamp(min=0)], fill).amax(1)


def _frustum_walk(ws: WorldArrays, origin, direction, active, packet,
                  packet_ids, leaves, refresh, work):
    """The K6 packet walk over the BVH2 tables: per packet one stack, one
    bound (``refresh`` gives its new value after leaf work, or None to
    stop the packet), interval box tests against the packet's frustum, the
    hit leaf children (left, then right) tested for every active ray of
    the packet without a box test of its own (``leaves(li, rays)``), and
    the hit internal children pushed: closest (``refresh.closest``) the
    nearer entry on top, shadow the left on top. Returns the overflowed
    packets' rays (poisoned by the caller)."""
    members, valid = _packets(active, packet, packet_ids)
    n_p, dev = members.shape[0], origin.device
    fr = _packet_frustum(origin, direction, members, valid)
    stack = torch.zeros((n_p, STACK_DEPTH), dtype=torch.long, device=dev)
    sp = torch.ones((n_p,), dtype=torch.long, device=dev)
    bound = refresh.start(members, valid)
    live = torch.arange(n_p, device=dev)
    ovf_rays = []
    while live.numel():
        sp_l = sp[live] - 1
        row = ws.inner_table[stack[live, sp_l]]
        f = tuple(x[live] for x in fr)
        ok_l, tl = _frustum_box_test(f, row[:, 0:6], bound[live])
        ok_r, tr = _frustum_box_test(f, row[:, 6:12], bound[live])
        if work is not None:
            work.packet_nodes += live.numel()
        l_leaf, r_leaf = row[:, 14] >= 0.0, row[:, 15] >= 0.0
        hl, hr = ok_l & l_leaf, ok_r & r_leaf
        for h, ref in ((hl, row[:, 12]), (hr, row[:, 13])):
            if h.any():
                mem, val = members[live[h]], valid[live[h]]
                li = ref[h].long()[:, None].expand_as(mem)[val]
                if work is not None:
                    work.tris = work.tris + ws.leaf_table[li, 10 * ws.leaf_k + 1].clamp(
                        max=ws.leaf_k).sum(dtype=torch.int64)
                leaves(li, mem[val])
        any_leaf = hl | hr
        stop = torch.zeros_like(any_leaf)
        if any_leaf.any():
            pk = live[any_leaf]
            nb, dead = refresh(pk, members[pk], valid[pk], bound[pk])
            bound[pk] = nb
            stop[any_leaf] = dead
        lref, rref = row[:, 12].long(), row[:, 13].long()
        push_l, push_r = ok_l & ~l_leaf & ~stop, ok_r & ~r_leaf & ~stop
        both = push_l & push_r
        if refresh.closest:  # nearer entry on top (tl <= tr: left)
            near_left = tl <= tr
            top = torch.where(near_left, lref, rref)
            below = torch.where(near_left, rref, lref)
        else:  # left on top
            top, below = lref, rref
        first = torch.where(both, below, torch.where(push_l, lref, rref))
        npush = push_l.long() + push_r.long()
        ovf = sp_l + npush > STACK_DEPTH
        w1 = ~ovf & (npush >= 1)
        stack[live[w1], sp_l[w1]] = first[w1]
        w2 = ~ovf & both
        stack[live[w2], sp_l[w2] + 1] = top[w2]
        sp[live] = sp_l + torch.where(ovf, 0, npush)
        if ovf.any():  # never write past the stack: poison and stop
            ovf_rays.append(members[live[ovf]][valid[live[ovf]]])
        live = live[~stop & ~ovf & (sp[live] > 0)]
    return torch.cat(ovf_rays) if ovf_rays else members[:0, 0]


class _ClosestBound:
    """The closest walk's packet bound: T_FAR, then after leaf work the max
    t_best of the packet's active rays."""

    closest = True

    def __init__(self, t_best):
        self.t_best = t_best

    def start(self, members, valid):
        return torch.full((members.shape[0],), T_FAR, dtype=torch.float32,
                          device=members.device)

    def __call__(self, pk, mem, val, bound):
        return (_packet_max(self.t_best, mem, val, float("-inf")),
                torch.zeros_like(pk, dtype=torch.bool))


class _ShadowBound:
    """The shadow walk's packet state: the box bound is the packet's max
    max_dist; after leaf work the packet stops once the max visibility of
    its active rays is at or below min_visibility."""

    closest = False

    def __init__(self, vis, maxd, min_visibility):
        self.vis, self.maxd, self.min_vis = vis, maxd, min_visibility

    def start(self, members, valid):
        return _packet_max(self.maxd, members, valid, 0.0)

    def __call__(self, pk, mem, val, bound):
        return bound, ~(_packet_max(self.vis, mem, val, 0.0) > self.min_vis)


def frustum_closest_walk_reference(ws: WorldArrays, origin, direction, active,
                                   packet: int = PACKET, packet_ids=None,
                                   work: Work | None = None, width: int = 0,
                                   height: int = 0):
    """Plain K6 closest-hit walk: packets of ``packet`` consecutive ray ids
    (or of equal ``packet_ids``, or, on a whole ``width`` x ``height``
    frame, the kernel's warp tiles: _frame_packets), each walked once with
    interval tests against its active rays' frustum and the bound max
    t_best. Returns (t, tri, cross (R, 3), menc)."""
    check_depth(ws)
    packet_ids = _frame_packets(origin, packet_ids, width, height)
    state = _closest_state(origin.shape[0], origin.device, None)
    ops = _closest_ops(state)
    r = _rays9(origin, direction)
    ovf = _frustum_walk(
        ws, origin, direction, active, packet, packet_ids,
        lambda li, rays: ops.leaves(ws.leaf_table, ws.leaf_k, li, r[rays], rays),
        _ClosestBound(state[0]), work)
    ops.poison(ovf)
    return state


def frustum_shadow_walk_reference(ws: WorldArrays, origin, direction,
                                  max_dist, active,
                                  min_visibility: float = 0.05,
                                  t_eps: float = 1e-3, packet: int = PACKET,
                                  packet_ids=None, work: Work | None = None,
                                  width: int = 0, height: int = 0):
    """Plain K6 transmission walk per packet (see
    frustum_closest_walk_reference): a packet stops once the visibility of
    all its active rays is at or below min_visibility, so a ray that is
    already there may keep losing visibility until then. Returns vis (R,),
    1 for inactive rays."""
    check_depth(ws)
    packet_ids = _frame_packets(origin, packet_ids, width, height)
    n, dev = origin.shape[0], origin.device
    vis = torch.ones((n,), dtype=torch.float32, device=dev)
    maxd = _max_dist(max_dist, n, dev)
    ops = _shadow_ops(vis, maxd, min_visibility, t_eps)
    r = _rays9(origin, direction)
    ovf = _frustum_walk(
        ws, origin, direction, active, packet, packet_ids,
        lambda li, rays: ops.leaves(ws.leaf_table, ws.leaf_k, li, r[rays], rays),
        _ShadowBound(vis, maxd, min_visibility), work)
    ops.poison(ovf)
    return vis


# ---- K7: the miss-link walks (pallas_traverse.py:128-240) ------------------


def _walk_misslink(w: _Walk, records, K, r_all, rays):
    """The stackless walk over ``records`` of the ray ids ``rays``: at node
    cur a ray tests the node's own box against its bound; a hit leaf runs
    its inlined triangles, a hit internal node sends the ray to its left
    child (left_first), anything else to the node's miss link; -1 ends the
    walk, and so does ``w.stop`` after a leaf. All unfinished rays advance
    one node per step."""
    live = rays
    cur = torch.zeros_like(rays)
    steps = 0
    while live.numel():
        steps += 1
        row = records[cur]
        r = r_all[live]
        tmin, box = _slab(r, row[:, 0:6])
        hit = box & (tmin <= w.bound(live))
        left, count, miss = (row[:, c].long() for c in (6, 7, 8))
        leaf = hit & (count >= 0)
        if w.work is not None:
            w.work.ml_nodes += live.numel()
        if leaf.any():
            if w.work is not None:
                w.work.tris = w.work.tris + count[leaf].clamp(max=K).sum()
            w.leaves(records, K, cur[leaf], r[leaf], live[leaf])
        nxt = torch.where(hit & (count < 0), left, miss)
        keep = (nxt >= 0) & ~w.stop(live)
        live, cur = live[keep], nxt[keep]
    if w.work is not None:
        w.work.ml_chain = max(w.work.ml_chain, steps)


def check_records(ws: WorldArrays) -> None:
    """The miss-link walks need the records view (packing.world_geometry)."""
    if ws.records is None:
        raise ValueError("the scene has no miss-link records")


def misslink_closest_walk_reference(ws: WorldArrays, origin, direction,
                                    active, work: Work | None = None):
    """Plain K7 closest-hit walk over ``records``. Returns (t, tri, cross
    (R, 3), menc), the leaf's triangle data read from its record row."""
    check_records(ws)
    state = _closest_state(origin.shape[0], origin.device, None)
    _walk_misslink(_closest_ops(state, work, records=True), ws.records,
                   ws.leaf_k, _rays9(origin, direction), active.nonzero()[:, 0])
    return state


def misslink_shadow_walk_reference(ws: WorldArrays, origin, direction,
                                   max_dist, active,
                                   min_visibility: float = 0.05,
                                   t_eps: float = 1e-3,
                                   work: Work | None = None):
    """Plain K7 transmission walk: blockers multiply in the transparency
    column of their record row (the instance's material override applied).
    Returns vis (R,), 1 for inactive rays."""
    check_records(ws)
    vis, maxd, rays = _shadow_setup(origin, max_dist, active, min_visibility)
    _walk_misslink(_shadow_ops(vis, maxd, min_visibility, t_eps, work,
                               records=True), ws.records, ws.leaf_k,
                   _rays9(origin, direction), rays)
    return vis


def _treelet_rows(ws):
    """The treelet tables flattened to (Tt * SI, 16) / (Tt * SL, W2), and the
    row strides SI, SL of one treelet."""
    si, sl = ws.tre_inner.shape[1], ws.tre_leaf.shape[1]
    return (ws.tre_inner.reshape(-1, 16),
            ws.tre_leaf.reshape(-1, ws.tre_leaf.shape[2]), si, sl)


def tiered_closest_walk_reference(ws: WorldArrays, origin, direction, active,
                                  work: Work | None = None):
    """Plain K8 closest-hit walk over the treelet view: the top tree walk,
    with each treelet child a ray's box test hits walked by the K2 walk on
    that treelet's rows. Returns (t, tri, cross (R, 3), menc)."""
    check_tiered(ws)
    state = _closest_state(origin.shape[0], origin.device, None)
    _walk_tiered(_closest_ops(state, work), ws, _rays9(origin, direction),
                 active.nonzero()[:, 0])
    return state


def tiered_shadow_walk_reference(ws: WorldArrays, origin, direction,
                                 max_dist, active,
                                 min_visibility: float = 0.05,
                                 t_eps: float = 1e-3,
                                 work: Work | None = None):
    """Plain K8 transmission walk over the treelet view: the treelets' K3
    walks multiply into the carried visibility, left treelet first. Returns
    vis (R,), 1 for inactive rays."""
    check_tiered(ws)
    vis, maxd, rays = _shadow_setup(origin, max_dist, active, min_visibility)
    _walk_tiered(_shadow_ops(vis, maxd, min_visibility, t_eps, work), ws,
                 _rays9(origin, direction), rays)
    return vis


def plain_walks(ws: WorldArrays, wide: bool = False):
    """(closest, shadow) plain walks of the view the kernels walk: K8's over
    the treelet view when ``ws.tiered``, else K5's over the wide tables when
    ``wide``, else K2/K3's over the whole tree."""
    if ws.tiered:
        return tiered_closest_walk_reference, tiered_shadow_walk_reference
    if wide:
        return wide_closest_walk_reference, wide_shadow_walk_reference
    return closest_walk_reference, shadow_walk_reference


# ---- kernel launches -------------------------------------------------------

# the tables a kernel walks ("view"): "bvh2" (K2/K3, and K6 over the same
# rows), "tiered" (K8), "bvh8" (K5) or "misslink" (K7)
def _table_tensors(ws: WorldArrays, view: str):
    return {"bvh2": (ws.inner_table, ws.leaf_table),
            "tiered": (ws.top_table, ws.tre_inner, ws.tre_leaf),
            "bvh8": (ws.inner8_table, ws.leaf8_table),
            "misslink": (ws.ml_nodes, ws.ml_tris)}[view]


def check_cuda_inputs(ws: WorldArrays, *tensors, view: str = "bvh2"):
    """Validate what a kernel launch reads: the depth bound, one CUDA device,
    contiguous, the table layouts the kernels index (None entries are
    skipped). ``view``: the tables the launch walks."""
    {"bvh2": check_depth, "tiered": check_tiered, "bvh8": check_wide,
     "misslink": check_records}[view](ws)
    tables = _table_tensors(ws, view)
    for t in tables + tensors:
        if t is None:
            continue
        if not t.is_cuda or t.device != tables[0].device:
            raise ValueError("kernel inputs must all lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if view == "misslink":
        nodes, tris = ws.ml_nodes, ws.ml_tris
        if (nodes.dtype != torch.float32 or tris.dtype != torch.float32
                or nodes.dim() != 2 or nodes.shape[1] != 8 or tris.dim() != 2
                or tris.shape[1] != 12):
            raise ValueError("K7's tables must be (Nu, 8) and (Tw, 12) float32")
        return
    *inner, leaf = tables
    width = 72 if view == "bvh8" else 16
    for t in inner:
        if t.dtype != torch.float32 or t.shape[-1] != width:
            raise ValueError(f"{view} inner tables must have {width} float32 columns")
    if leaf.dtype != torch.float32 or leaf.shape[-1] < 11 * ws.leaf_k + 2:
        raise ValueError(f"leaf tables must have >= {11 * ws.leaf_k + 2} float32 columns")
    if view == "tiered" and not (ws.top_table.dim() == 2 and ws.tre_inner.dim() == 3
                                 and ws.tre_leaf.dim() == 3
                                 and ws.tre_inner.shape[0] == ws.tre_leaf.shape[0]):
        raise ValueError("tiered tables must be (Nt, 16), (Tt, SI, 16), (Tt, SL, W2)")
    if view != "tiered" and (inner[0].dim() != 2 or leaf.dim() != 2):
        raise ValueError("inner tables must be (N, W) and leaf tables (L, W2)")


def table_args(ws: WorldArrays, view: str) -> tuple:
    """The table arguments of a C entry point: (inner, leaf, leaf_w, leaf_k)
    for "bvh2" and "bvh8", (top, tre_inner, tre_leaf, si, sl, leaf_w,
    leaf_k) for "tiered", (nodes, tris, leaf_k) for "misslink"."""
    ptrs = tuple(t.data_ptr() for t in _table_tensors(ws, view))
    if view == "misslink":
        return ptrs + (ws.leaf_k,)
    if view == "tiered":
        return ptrs + (ws.tre_inner.shape[1], ws.tre_leaf.shape[1],
                       ws.tre_leaf.shape[2], ws.leaf_k)
    return ptrs + (ws.leaf_table.shape[1], ws.leaf_k)


def _ray_operands(origin, direction, active):
    o = origin.to(torch.float32).contiguous()
    d = direction.to(torch.float32).contiguous()
    a = active.to(torch.uint8).contiguous()
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError("origin and direction must be (R, 3)")
    if a.shape != (o.shape[0],):
        raise ValueError("active must be (R,)")
    return o, d, a


# walk -> (tables, closest entry point, its launch count, shadow entry
# point, its launch count); "frustum" is K6 over the BVH2 tables
_KERNELS = {
    "bvh2": ("bvh2", "rz_closest_bvh2", "closest_hit_bvh2",
             "rz_shadow_bvh2", "shadow_walk_bvh2"),
    "tiered": ("tiered", "rz_closest_tiered", "closest_hit_tiered",
               "rz_shadow_tiered", "shadow_walk_tiered"),
    "bvh8": ("bvh8", "rz_closest_bvh8", "closest_hit_bvh8",
             "rz_shadow_bvh8", "shadow_walk_bvh8"),
    "frustum": ("bvh2", "rz_closest_frustum", "closest_hit_frustum",
                "rz_shadow_frustum", "shadow_walk_frustum"),
    "misslink": ("misslink", "rz_closest_misslink", "closest_hit_misslink",
                 "rz_shadow_misslink", "shadow_walk_misslink"),
}


def _closest_cuda(ws, origin, direction, active, t_init, kind, frame=(),
                  count=False):
    """Launch a closest walk; K2 ("bvh2"), K6 ("frustum") and K7
    ("misslink") take the frame (width, height) their wave covers, K8 and
    K5 none; ``count``: the counting form."""
    view, entry, name, _, _ = _KERNELS[kind]
    entry, name = (entry + "_count", name + "_count") if count else (entry, name)
    o, d, a = _ray_operands(origin, direction, active)
    n = o.shape[0]
    ti = None if t_init is None else t_init.to(torch.float32).contiguous()
    check_cuda_inputs(ws, o, d, a, ti, view=view)
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    tri = torch.empty((n,), dtype=torch.int32, device=o.device)
    cross = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    menc = torch.empty((n,), dtype=torch.float32, device=o.device)
    rays = (o.data_ptr(), d.data_ptr(), a.data_ptr())
    # only K2 takes a t_init (as only the JAX BVH2 walk does)
    ti_arg = (None if ti is None else ti.data_ptr(),) if kind == "bvh2" else ()
    err = getattr(ext.lib(), entry)(
        *table_args(ws, view), *rays, *ti_arg, n, *frame, t.data_ptr(),
        tri.data_ptr(), cross.data_ptr(), menc.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream)
    ext.check(err, name)
    ext.LAUNCHES[name] += n > 0  # the entry point skips n == 0
    return t, tri, cross, menc


def _shadow_cuda(ws, origin, direction, max_dist, active, min_visibility,
                 t_eps, kind, frame=(), count=False):
    view, _, _, entry, name = _KERNELS[kind]
    entry, name = (entry + "_count", name + "_count") if count else (entry, name)
    o, d, a = _ray_operands(origin, direction, active)
    n = o.shape[0]
    md = _max_dist(max_dist, n, o.device).contiguous()
    check_cuda_inputs(ws, o, d, a, md, view=view)
    vis = torch.empty((n,), dtype=torch.float32, device=o.device)
    err = getattr(ext.lib(), entry)(
        *table_args(ws, view), o.data_ptr(), d.data_ptr(), md.data_ptr(),
        a.data_ptr(), n, *frame, float(min_visibility), float(t_eps),
        vis.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream,
    )
    ext.check(err, name)
    ext.LAUNCHES[name] += n > 0
    return vis


# the plain walks of the CPU path
_PLAIN_CLOSEST = {
    "bvh2": lambda ws, o, d, a, ti: closest_walk_reference(ws, o, d, a, ti),
    "tiered": lambda ws, o, d, a, ti: tiered_closest_walk_reference(ws, o, d, a),
    "bvh8": lambda ws, o, d, a, ti: wide_closest_walk_reference(ws, o, d, a),
    "frustum": lambda ws, o, d, a, ti, width=0, height=0: (
        frustum_closest_walk_reference(ws, o, d, a, width=width, height=height)),
    "misslink": lambda ws, o, d, a, ti: misslink_closest_walk_reference(ws, o, d, a),
}
_PLAIN_SHADOW = {
    "bvh2": shadow_walk_reference, "tiered": tiered_shadow_walk_reference,
    "bvh8": wide_shadow_walk_reference,
    "frustum": lambda ws, o, d, md, a, mv, te, width=0, height=0: (
        frustum_shadow_walk_reference(ws, o, d, md, a, mv, te, width=width,
                                      height=height)),
    "misslink": misslink_shadow_walk_reference,
}
_NAMES = {"bvh2": ("K2", "K3"), "tiered": ("K8", "K8"), "bvh8": ("K5", "K5"),
          "frustum": ("K6", "K6"), "misslink": ("K7", "K7")}


def _plain_frame(kind, frame):
    """The frame a plain walk takes after its arguments: K6's packets cover
    it (the others' results do not depend on the map)."""
    return tuple(frame) if kind == "frustum" else ()


def _closest(ws, origin, direction, active, t_init, kind, frame=()):
    if origin.is_cuda:
        return _closest_cuda(ws, origin, direction, active, t_init, kind, frame)
    if origin.device.type != "cpu":
        raise ValueError(f"no {_NAMES[kind][0]} for device {origin.device}")
    return _PLAIN_CLOSEST[kind](ws, origin, direction, active, t_init,
                                *_plain_frame(kind, frame))


def closest_walk(ws: WorldArrays, origin, direction, active, t_init=None,
                 width: int = 0, height: int = 0):
    """Raw closest-hit walk (t, tri, cross, menc): K2 on CUDA tensors (the
    live rays only, in the warp tiles of the width x height frame when the
    wave is a whole one), the plain version on CPU tensors."""
    return _closest(ws, origin, direction, active, t_init, "bvh2",
                    (width, height))


def closest_walk_tiered(ws: WorldArrays, origin, direction, active):
    """Raw closest-hit walk over the treelet view: K8 on CUDA tensors, the
    plain version on CPU tensors."""
    return _closest(ws, origin, direction, active, None, "tiered")


def closest_walk_bvh8(ws: WorldArrays, origin, direction, active):
    """Raw closest-hit walk over the wide tables: K5 on CUDA tensors, the
    plain version on CPU tensors."""
    return _closest(ws, origin, direction, active, None, "bvh8")


def closest_walk_frustum(ws: WorldArrays, origin, direction, active,
                         width: int = 0, height: int = 0):
    """Raw packet-frustum closest-hit walk, a packet per warp of the
    live-ray map (K1's warp tiles of the width x height frame when the wave
    is a whole one, else 32 consecutive ray ids): K6 on CUDA tensors, the
    plain version on CPU tensors."""
    return _closest(ws, origin, direction, active, None, "frustum",
                    (width, height))


def closest_walk_misslink(ws: WorldArrays, origin, direction, active,
                          width: int = 0, height: int = 0):
    """Raw stackless miss-link closest-hit walk: K7 on CUDA tensors (the
    live rays only, in the warp tiles of the width x height frame when the
    wave is a whole one), the plain version on CPU tensors."""
    return _closest(ws, origin, direction, active, None, "misslink",
                    (width, height))


def decode_hit(ws: WorldArrays, origin, direction, t, tri, cross, menc) -> Hit:
    """pallas_traverse._decode_hit: normalize the cross product, apply the
    sign-encoded orientation, decode the material id."""
    sign = torch.where(menc < 0.0, -1.0, 1.0)
    cx, cy, cz = cross.unbind(1)
    norm = torch.sqrt(torch.clamp_min(cx * cx + cy * cy + cz * cz, 1e-40))
    normal = cross / norm[:, None] * sign[:, None]
    found = tri >= 0
    mat = torch.where(found, menc.abs().to(torch.int32) - 1, -1).to(torch.int32)
    inst = torch.where(
        found, ws.tri_inst[tri.clamp(min=0).long()], -1
    ).to(torch.int32)
    return Hit(
        t=t, point=origin + direction * t[:, None], tri=tri, inst=inst,
        found=found, normal=normal, mat=mat, cross=cross, menc=menc,
    )


def closest_hit_bvh2(ws: WorldArrays, origin, direction, active,
                     t_init=None, width: int = 0, height: int = 0) -> Hit:
    """Closest hit per ray (pallas_closest_hit_bvh2). ``t_init``: optional
    (R,) upper bound on t; hits at or beyond it are ignored. ``width`` x
    ``height``: the frame a whole-frame wave covers."""
    t, tri, cross, menc = closest_walk(ws, origin, direction, active, t_init,
                                       width, height)
    return decode_hit(ws, origin, direction, t, tri, cross, menc)


def closest_hit_tiered(ws: WorldArrays, origin, direction, active) -> Hit:
    """Closest hit per ray over the treelet view (K8,
    pallas_traverse.tiered_walk_closest); the same hits as closest_hit_bvh2
    on the whole tree."""
    t, tri, cross, menc = closest_walk_tiered(ws, origin, direction, active)
    return decode_hit(ws, origin, direction, t, tri, cross, menc)


def closest_hit_bvh8(ws: WorldArrays, origin, direction, active) -> Hit:
    """Closest hit per ray over the wide tables (K5,
    pallas_traverse.bvh8_walk_closest); the same t as closest_hit_bvh2."""
    t, tri, cross, menc = closest_walk_bvh8(ws, origin, direction, active)
    return decode_hit(ws, origin, direction, t, tri, cross, menc)


def closest_hit_frustum(ws: WorldArrays, origin, direction, active,
                        width: int = 0, height: int = 0) -> Hit:
    """Closest hit per ray by the packet-frustum walk (K6,
    pallas_closest_hit_frustum) over the packets of closest_walk_frustum."""
    t, tri, cross, menc = closest_walk_frustum(ws, origin, direction, active,
                                               width, height)
    return decode_hit(ws, origin, direction, t, tri, cross, menc)


def closest_hit_misslink(ws: WorldArrays, origin, direction, active,
                         width: int = 0, height: int = 0) -> Hit:
    """Closest hit per ray by the stackless miss-link walk (K7,
    pallas_closest_hit): the same triangle and t as closest_hit_bvh2.
    ``width`` x ``height``: the frame a whole-frame wave covers."""
    t, tri, cross, menc = closest_walk_misslink(ws, origin, direction, active,
                                                width, height)
    return decode_hit(ws, origin, direction, t, tri, cross, menc)


def _shadow(ws, origin, direction, max_dist, active, min_visibility, t_eps,
            kind, frame=()):
    if origin.is_cuda:
        vis = _shadow_cuda(ws, origin, direction, max_dist, active,
                           min_visibility, t_eps, kind, frame)
    elif origin.device.type == "cpu":
        vis = _PLAIN_SHADOW[kind](ws, origin, direction, max_dist, active,
                                  min_visibility, t_eps, *_plain_frame(kind, frame))
    else:
        raise ValueError(f"no {_NAMES[kind][1]} for device {origin.device}")
    return vis, active.sum(dtype=torch.int64)


def shadow_walk_bvh2(ws: WorldArrays, origin, direction, max_dist, active,
                     min_visibility: float = 0.05, t_eps: float = 1e-3,
                     width: int = 0, height: int = 0):
    """Transmission visibility per ray and the number of shadow rays cast
    (pallas_shadow_walk_bvh2): (vis (R,), rays () int64). Inactive rays
    report vis 1. K3 on CUDA tensors (closest_walk's schedule), the plain
    version on CPU tensors."""
    return _shadow(ws, origin, direction, max_dist, active, min_visibility,
                   t_eps, "bvh2", (width, height))


def shadow_walk_tiered(ws: WorldArrays, origin, direction, max_dist, active,
                       min_visibility: float = 0.05, t_eps: float = 1e-3):
    """shadow_walk_bvh2 over the treelet view (K8,
    pallas_traverse.tiered_walk_shadow)."""
    return _shadow(ws, origin, direction, max_dist, active, min_visibility,
                   t_eps, "tiered")


def shadow_walk_bvh8(ws: WorldArrays, origin, direction, max_dist, active,
                     min_visibility: float = 0.05, t_eps: float = 1e-3):
    """shadow_walk_bvh2 over the wide tables (K5,
    pallas_traverse.bvh8_walk_shadow)."""
    return _shadow(ws, origin, direction, max_dist, active, min_visibility,
                   t_eps, "bvh8")


def shadow_walk_frustum(ws: WorldArrays, origin, direction, max_dist, active,
                        min_visibility: float = 0.05, t_eps: float = 1e-3,
                        width: int = 0, height: int = 0):
    """Transmission visibility by the packet-frustum walk (K6,
    pallas_shadow_walk_frustum) over the packets of closest_walk_frustum. A
    packet stops once all its rays are at or below min_visibility, so a
    ray's vis is exact only where it ends above it."""
    return _shadow(ws, origin, direction, max_dist, active, min_visibility,
                   t_eps, "frustum", (width, height))


def shadow_walk_misslink(ws: WorldArrays, origin, direction, max_dist, active,
                         min_visibility: float = 0.05, t_eps: float = 1e-3,
                         width: int = 0, height: int = 0):
    """shadow_walk_bvh2 by the stackless miss-link walk (K7,
    pallas_shadow_walk), with the blockers' transparencies those of the
    records (closest_walk_misslink's schedule)."""
    return _shadow(ws, origin, direction, max_dist, active, min_visibility,
                   t_eps, "misslink", (width, height))


# ---- the live-ray walks' diagnostics: lane counts, budgets ----------------


def live_lane_counts(ws: WorldArrays, origin, direction, active, kind="misslink",
                     max_dist=None, min_visibility: float = 0.05,
                     t_eps: float = 1e-3, width: int = 0, height: int = 0,
                     t_init=None):
    """A diagnostic of K7 (``kind`` "misslink"), K2/K3 ("bvh2"), K8
    ("tiered", a linear wave: no frame) or K6 ("frustum") on CUDA tensors:
    the counting instantiation walks the wave (closest rays, or shadow rays
    when ``max_dist`` is given) and sums, over every step of every walk's
    node loop, the lanes of the warp that take the step (K6: the lanes with
    a ray in the packet) and 32. Returns (the walk's outputs, active
    lane-steps, warp-steps x 32)."""
    if not origin.is_cuda:
        raise ValueError("the counting walks run on CUDA tensors only")
    sums = (ctypes.c_ulonglong * 2)()
    torch.cuda.synchronize(origin.device)
    ext.check(ext.lib().rz_live_walk_lanes(sums, 1), "rz_live_walk_lanes")
    frame = () if kind == "tiered" else (width, height)
    if max_dist is None:
        out = _closest_cuda(ws, origin, direction, active, t_init, kind, frame,
                            count=True)
    else:
        out = _shadow_cuda(ws, origin, direction, max_dist, active,
                           min_visibility, t_eps, kind, frame, count=True)
    torch.cuda.synchronize(origin.device)
    ext.check(ext.lib().rz_live_walk_lanes(sums, 1), "rz_live_walk_lanes")
    return out, int(sums[0]), int(sums[1])


# the standalone walks' forms, by their rz_live_walk_budget id: the live-ray
# walks (K7, K2/K3, K8) and K6's packet walk over the same map
LIVE_FORMS = ("closest_misslink", "shadow_misslink", "closest_bvh2",
              "shadow_bvh2", "closest_tiered", "shadow_tiered",
              "closest_frustum", "shadow_frustum")


def live_budget(form: str) -> dict:
    """The compiled budget of a standalone walk (a name of LIVE_FORMS):
    threads per block, registers per thread, local memory per thread in
    bytes and resident warps per SM."""
    out = (ctypes.c_int * 4)()
    ext.check(ext.lib().rz_live_walk_budget(LIVE_FORMS.index(form), out),
              "rz_live_walk_budget")
    return dict(threads=out[0], regs=out[1], local_bytes=out[2],
                warps_per_sm=out[3])
