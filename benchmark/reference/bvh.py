"""The reference's own BVH and a plain walk that counts its work: the
yardstick of the K1 roofline (work/count.py). Nothing here comes from the
program: the tree is built from the world triangles of reference/tracer.py
by a full-sweep SAH over centroids (leaves of at most LEAF triangles, the
upstream builder's cap, BVH.cpp:115), and walked per ray, nearer child
first, with the closest hit's t pruning the boxes.

The operations a step costs, counted from the arithmetic below:
- a node visit (``_visit``) tests both children's boxes; per box the slab
  test is 3 subtractions and 3 multiplies per plane pair (12), 6 min/max
  for the near and far planes, 2 max and 2 min over the axes, 1 max
  against 0 and 1 compare for the hit, and 1 compare against the best t:
  25; OPS_PER_VISIT = 2 x 25 = 50.
- a triangle test (tracer._moller_trumbore) is: cross(d, e2) 9, det 5,
  |det| >= eps 2, reciprocal 1, s = o - v0 3, u 6, cross(s, e1) 9, v 6,
  t 6, the five bounds tests and u + v 6, and the compare against the best
  t 1: OPS_PER_TEST = 54.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import tracer

LEAF = 4
OPS_PER_VISIT = 50
OPS_PER_TEST = 54
NODE_BYTES = 32  # a node: its box (6 float32), child or first triangle, count
TRI_BYTES = 40  # a triangle: v0, e1, e2 (9 float32) and its material


@dataclasses.dataclass
class BVH:
    bmin: np.ndarray  # (N, 3)
    bmax: np.ndarray  # (N, 3)
    left: np.ndarray  # (N,) first child (the second is left + 1), or first slot
    count: np.ndarray  # (N,) triangles of a leaf, 0 for an inner node
    order: np.ndarray  # (T,) triangle of each slot

    @property
    def table_bytes(self) -> int:
        return self.bmin.shape[0] * NODE_BYTES + self.order.shape[0] * TRI_BYTES


def _area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def build(tri: np.ndarray) -> BVH:
    """SAH BVH over triangles (T, 9) [v0 e1 e2]."""
    v0 = tri[:, 0:3].astype(np.float64)
    pts = np.stack([v0, v0 + tri[:, 3:6], v0 + tri[:, 6:9]], 1)
    lo_t, hi_t = pts.min(1), pts.max(1)
    cen = 0.5 * (lo_t + hi_t)
    bmin, bmax, left, count = [], [], [], []
    order = []

    def new_node(prims):
        bmin.append(lo_t[prims].min(0))
        bmax.append(hi_t[prims].max(0))
        left.append(0)
        count.append(0)
        return len(bmin) - 1

    everything = np.arange(tri.shape[0])
    work = [(everything, new_node(everything))]
    while work:
        prims, node = work.pop()
        n = prims.shape[0]
        if n <= LEAF:
            left[node], count[node] = len(order), n
            order.extend(prims.tolist())
            continue
        ext = cen[prims].max(0) - cen[prims].min(0)
        axis = int(np.argmax(ext))
        srt = prims[np.argsort(cen[prims, axis], kind="stable")]
        lo, hi = lo_t[srt], hi_t[srt]
        pre = _area(np.minimum.accumulate(lo), np.maximum.accumulate(hi))
        suf = _area(np.minimum.accumulate(lo[::-1])[::-1],
                    np.maximum.accumulate(hi[::-1])[::-1])
        k = np.arange(1, n)
        cost = pre[:-1] * k + suf[1:] * (n - k)
        split = int(np.argmin(cost)) + 1
        a, b = srt[:split], srt[split:]
        ia, ib = new_node(a), new_node(b)
        left[node] = ia
        assert ib == ia + 1
        work.append((b, ib))
        work.append((a, ia))
    return BVH(np.asarray(bmin, np.float32), np.asarray(bmax, np.float32),
               np.asarray(left, np.int64), np.asarray(count, np.int64),
               np.asarray(order, np.int64))


class Work:
    """Node visits and triangle tests of the counting walks."""

    def __init__(self):
        self.visits = 0
        self.tests = 0


class Walker:
    """Closest-hit and transmission walks over a BVH of a tracer.World's
    triangles, with the same results as the brute force (tracer.closest,
    tracer.visibility), counting their work into ``work``."""

    def __init__(self, world: tracer.World, work: Work):
        cnt = world.count.cpu().numpy()
        valid = np.arange(world.tri.shape[1])[None, :] < cnt[:, None]
        inst, slot = np.nonzero(valid)
        tri = world.tri.float().cpu().numpy()[inst, slot]
        self.bvh = build(tri)
        dev = world.tri.device
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        order = self.bvh.order
        self.tri = t(tri[order]).to(world.tri.dtype)
        self.inst, self.slot = t(inst[order]), t(slot[order])
        self.transp = world.transp[self.inst, self.slot]
        self.bmin, self.bmax = t(self.bvh.bmin).to(world.tri.dtype), t(self.bvh.bmax).to(world.tri.dtype)
        self.left, self.count = t(self.bvh.left), t(self.bvh.count)
        self.work = work

    def _walk(self, o, d, leaf, bound, done=None):
        """Each ray's own depth-first walk, nearer child first; all live
        rays take one node a step. ``leaf(rays, slots (n, LEAF), valid)``
        handles hit leaves, ``bound(rays)`` prunes, ``done(rays)`` ends a
        ray's walk early."""
        n, dev = o.shape[0], o.device
        inv = tracer._safe_inv(d)
        stack = torch.zeros((n, 128), dtype=torch.int64, device=dev)
        sp = torch.ones(n, dtype=torch.int64, device=dev)
        live = torch.arange(n, device=dev)
        ar = torch.arange(LEAF, device=dev)
        while live.numel():
            sp[live] -= 1
            node = stack[live, sp[live]]
            leafy = self.count[node] > 0
            lr, ln = live[leafy], node[leafy]
            if lr.numel():
                slots = self.left[ln][:, None] + ar[None]
                valid = ar[None] < self.count[ln][:, None]
                self.work.tests += int(valid.sum())
                leaf(lr, slots.clamp(max=self.tri.shape[0] - 1), valid)
            ir, inode = live[~leafy], node[~leafy]
            if ir.numel():
                self.work.visits += ir.numel()
                c = self.left[inode]
                oo, ii = o[ir][:, None, :], inv[ir][:, None, :]
                ch = torch.stack([c, c + 1], 1)
                t0 = (self.bmin[ch] - oo) * ii
                t1 = (self.bmax[ch] - oo) * ii
                tmin = torch.minimum(t0, t1).amax(-1)
                tmax = torch.maximum(t0, t1).amin(-1)
                hit = (tmax >= torch.clamp_min(tmin, 0.0)) & (tmin <= bound(ir)[:, None])
                near_first = tmin[:, 0] <= tmin[:, 1]
                # push the farther hit child first, so the nearer pops first
                far = torch.where(near_first, ch[:, 1], ch[:, 0])
                near = torch.where(near_first, ch[:, 0], ch[:, 1])
                far_hit = torch.where(near_first, hit[:, 1], hit[:, 0])
                near_hit = torch.where(near_first, hit[:, 0], hit[:, 1])
                for m, x in ((far_hit, far), (near_hit, near)):
                    rr = ir[m]
                    stack[rr, sp[rr]] = x[m]
                    sp[rr] += 1
            keep = sp[live] > 0
            if done is not None:
                keep &= ~done(live)
            live = live[keep]

    def closest(self, o, d):
        n = o.shape[0]
        big = torch.finfo(o.dtype).max
        t_best = torch.full((n,), big, dtype=o.dtype, device=o.device)
        best = torch.zeros(n, dtype=torch.int64, device=o.device)

        def leaf(rays, slots, valid):
            t, hit = tracer._moller_trumbore(o[rays][:, None, :], d[rays][:, None, :],
                                             self.tri[slots])
            t = torch.where(hit & valid, t, torch.full_like(t, big))
            tm, k = t.min(1)
            better = tm < t_best[rays]
            t_best[rays[better]] = tm[better]
            best[rays[better]] = slots[better, k[better]]

        self._walk(o, d, leaf, lambda r: t_best[r])
        found = t_best < big
        return t_best, found, self.inst[best], self.slot[best]

    def visibility(self, o, d, max_dist, min_vis):
        vis = torch.ones(o.shape[0], dtype=o.dtype, device=o.device)

        def leaf(rays, slots, valid):
            t, hit = tracer._moller_trumbore(o[rays][:, None, :], d[rays][:, None, :],
                                             self.tri[slots])
            block = hit & valid & (t >= tracer.SHADOW_T_EPS) & (t < max_dist[rays][:, None])
            f = torch.where(block, self.transp[slots], torch.ones_like(t)).prod(1)
            vis[rays] = vis[rays] * f

        # a transmission walk ends once nothing more can light (the floor)
        self._walk(o, d, leaf, lambda r: max_dist[r], lambda r: ~(vis[r] > min_vis))
        return vis
