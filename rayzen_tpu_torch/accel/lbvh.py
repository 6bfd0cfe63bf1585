"""LBVH build on the device: a Morton radix tree in torch tensor ops.

Port of rayzen_tpu/accel/lbvh.py. Deforming meshes (a fixed triangle
count, vertices that move arbitrarily) invalidate the topology that the
per-frame refit (packing.world_geometry) keeps, so deform.py rebuilds the
tree every frame from world-space triangles, on the device that holds
them, with no host round trip:

1. 30-bit Morton codes of the primitive centroids (10 bits an axis,
   normalised to the scene box);
2. a stable argsort of the codes (equal codes keep index order);
3. Karras 2012 binary radix tree: each internal node's range and split by
   vectorised binary searches over common-prefix lengths;
4. miss links by pointer jumping and node bounds (bottom up) by
   fixed-point passes.

The JAX package ends each search and fixed point on ``jnp.any`` of a flag
(lax.while_loop). Here each of them runs a fixed number of passes taken
from the static primitive count, because reading a flag would wait for the
device on every pass. Every pass is masked and changes nothing once its
lanes have converged, so the arrays equal JAX's bit for bit:
- the gallop doubles ``lmax`` while the probe stays in range, so it stops
  below 2n: ``(2n).bit_length()`` passes;
- the end search halves ``t = lmax // 2 < n`` to 0, and the split search
  is done once ``ceil(l / 2^k) <= 1`` with ``l < n``: the same count (JAX
  runs 32 and up to 33 passes, the extra ones masked);
- the bounds settle one tree level a pass, in at most the depth of the
  tree, which is <= 64 by construction (Karras' delta strictly increases
  from root to leaf and is at most 30 code bits + 32 index bits) and
  <= n - 1: ``min(n - 1, 64) + 1`` passes; the miss links, which JAX
  settles the same way, follow a chain of right children at most that
  long, which ``min(n - 1, 64).bit_length()`` pointer jumps cover. A tree
  deeper than 63 levels would also overflow the walks' 64-entry stack,
  and deform.render_deforming poisons its frame.

Integers are int64 inside (torch's uint32 support is partial; the codes
are 30-bit) and int32 in the output, as in JAX. Node layout: internal
nodes 0..n-2, leaves n-1..2n-2 (leaf j is node n-1+j), one primitive a
leaf.
"""

from __future__ import annotations

import torch

_MAX_DEPTH = 64  # the Karras tree's structural depth bound (see above)


def expand_bits_10(v):
    """Spread the low 10 bits of v (int64) so that two zero bits separate
    each (the Morton interleave expansion)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(centroids, scene_min, scene_max):
    """30-bit Morton codes (int64) of (N, 3) float32 points within
    [scene_min, scene_max]."""
    extent = torch.clamp_min(scene_max - scene_min, 1e-12)
    unit = torch.clamp((centroids - scene_min) / extent, 0.0, 1.0)
    q = torch.clamp_max((unit * 1024.0).to(torch.int64), 1023)
    return ((expand_bits_10(q[:, 0]) << 2) | (expand_bits_10(q[:, 1]) << 1)
            | expand_bits_10(q[:, 2]))


def build_lbvh(prim_bmin, prim_bmax):
    """Build a radix-tree LBVH over (N, 3) float32 primitive boxes on their
    device (N >= 2). Returns a dict of tensors:
      order      (N,)  int32: sorted primitive order (leaf j holds order[j])
      left_first (2N-1,) int32: internal: left child node id; leaf: j
      count      (2N-1,) int32: internal -1, leaf 1
      miss       (2N-1,) int32: threaded escape links (-1 ends the walk)
      bounds_min, bounds_max (2N-1, 3) float32
      left_child, right_child (N-1,) int32: the internal nodes' children
      max_depth  () int32: the deepest leaf's level (root 0), on the device
    """
    n = int(prim_bmin.shape[0])
    if n < 2:
        raise ValueError("build_lbvh needs at least 2 primitives")
    dev = prim_bmin.device
    centroids = 0.5 * (prim_bmin + prim_bmax)
    codes = morton_codes(centroids, prim_bmin.amin(dim=0), prim_bmax.amax(dim=0))
    order = torch.argsort(codes, stable=True)
    sc = codes[order]

    i = torch.arange(n - 1, device=dev)  # internal node ids
    sci = sc[:-1]  # sc[i]
    # 2^0 .. 2^62: bucketize(y) = floor(log2 y) + 1 for y >= 1, 0 for y = 0
    pow2 = 1 << torch.arange(63, device=dev)  # made on the device: no copy

    def delta(j):
        """Common-prefix length of sorted codes i and j, ties broken by the
        index bits (Karras section 4); -1 for j out of range. The leading
        zeros of the 64-bit (code xor) << 32 | (index xor): clz32 of the
        codes' xor where they differ, else 32 + clz32(i ^ j)."""
        jc = j.clamp(0, n - 1)
        key = ((sci ^ sc.take(jc)) << 32) | (i ^ jc)
        d = 64 - torch.bucketize(key, pow2, right=True)
        return torch.where(j == jc, d, -1)

    d = torch.sign(delta(i + 1) - delta(i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i - d)
    passes = (2 * n).bit_length()

    # upper bound of the range length (galloping)
    lmax = torch.full_like(i, 2)
    grow = torch.ones_like(i, dtype=torch.bool)
    for _ in range(passes):
        nxt = torch.where(grow & (delta(i + lmax * d) > delta_min), lmax * 2, lmax)
        grow = nxt != lmax
        lmax = nxt

    # binary search of the other end j = i + l * d
    l = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(passes):
        l = torch.where((t > 0) & (delta(i + (l + t) * d) > delta_min), l + t, l)
        t = t // 2
    j = i + l * d
    delta_node = delta(j)

    # binary search of the split: s += t for t = ceil(l/2), ceil(l/4), ...
    # down to t == 1, wherever delta(i, i + (s + t) * d) > delta_node
    s = torch.zeros_like(i)
    done = torch.zeros_like(i, dtype=torch.bool)
    div = 2
    for _ in range(passes):
        t = -(-l // div)  # ceil
        s = torch.where(~done & (t > 0) & (delta(i + (s + t) * d) > delta_node),
                        s + t, s)
        done = done | (t <= 1)
        div *= 2
    gamma = i + s * d + torch.clamp_max(d, 0)

    # children: the leaf of sorted position p is node (n - 1) + p
    left = torch.where(torch.minimum(i, j) == gamma, (n - 1) + gamma, gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1, n + gamma, gamma + 1)

    total = 2 * n - 1
    zeros = torch.zeros(n, dtype=torch.int64, device=dev)
    left_child = torch.cat([left, zeros])
    right_child = torch.cat([right, zeros])
    is_internal = torch.arange(total, device=dev) < (n - 1)
    node = torch.arange(total, device=dev)

    # parent pointers, scattered from the children (each node has one parent)
    parent = torch.full((total,), -1, dtype=torch.int64, device=dev)
    parent[left] = i
    parent[right] = i

    # miss links: the root's is -1, a left child's its right sibling, a right
    # child's its parent's. JAX settles them one level a pass; the same
    # links by pointer jumping: a right child points at its parent, the
    # others at themselves with their link, and 2^k jumps cover any chain of
    # right children up to the depth bound
    p = parent.clamp(min=0)
    am_left = node == left_child[p]
    has_parent = parent >= 0
    link = torch.where(am_left | ~has_parent, node, parent)
    for _ in range(min(n - 1, _MAX_DEPTH).bit_length()):
        link = link[link]
    miss = torch.where(am_left, right_child[p], -1)[link]

    # bounds: leaves from the sorted primitives, internal nodes bottom up,
    # one tree level a pass; min and max in one (2n-1, 6) table of [bmin |
    # -bmax] (max(a, b) = -min(-a, -b) exactly)
    big = 3.4e38
    leaves = torch.cat([prim_bmin[order], -prim_bmax[order]], dim=1)
    b6 = torch.cat([torch.full((n - 1, 6), big, device=dev), leaves])
    for _ in range(min(n - 1, _MAX_DEPTH) + 1):
        b6 = torch.cat([torch.minimum(b6[left], b6[right]), leaves])
    bmin, bmax = b6[:, :3], -b6[:, 3:]

    left_first = torch.where(is_internal, left_child, node - (n - 1))
    count = torch.where(is_internal, -1, 1)

    # the deepest leaf's level by pointer doubling on the parent links
    # (log2(2n) dense passes); deform.py's stack guard reads it
    hop = p
    rank = has_parent.to(torch.int32)
    for _ in range(max(1, (total - 1).bit_length())):
        rank, hop = rank + rank[hop], hop[hop]

    i32 = torch.int32
    return dict(
        order=order.to(i32),
        left_first=left_first.to(i32),
        count=count.to(i32),
        miss=miss.to(i32),
        bounds_min=bmin,
        bounds_max=bmax,
        left_child=left.to(i32),
        right_child=right.to(i32),
        max_depth=rank.amax(),
    )


def lbvh_for_triangles(tri_verts):
    """(T, 3, 3) world-space triangles -> the build_lbvh dict over their
    boxes."""
    return build_lbvh(tri_verts.amin(dim=1), tri_verts.amax(dim=1))
