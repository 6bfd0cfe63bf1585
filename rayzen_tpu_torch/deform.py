"""Deforming geometry: the LBVH rebuilt on the device every frame, end to
end.

Port of rayzen_tpu/deform.py. Rigid motion needs only the refit of a static
topology (packing.world_geometry); deforming meshes (a fixed triangle
count, vertices that move arbitrarily: cloth, skinning, waves) invalidate
the topology itself. Here the whole frame stays on the device: world-space
triangles -> Morton/Karras radix tree (accel/lbvh.py) -> the walks' tables
-> path trace, with no host round trip and no synchronising call.

The tables are built in the layouts the port's walks read, one triangle a
leaf (``leaf_k = 1``): the BVH2 ``inner_table``/``leaf_table`` of K1 and the
standalone K2/K3, and the miss-link ``records`` of the portable walks
(kernels="xla"), which render_deforming builds only for that path. The
wide, tiered and K7 views are not built: deforming frames never walk them.

Stack guard: the port's walks hold ``ops.walk.STACK_DEPTH`` (64) entries
and pop one node at a time, so a tree of depth D needs D + 1. The LBVH's
depth is computed on the device (accel/lbvh.py) and is at most 62: Karras'
delta strictly increases down a path and takes at most 62 values (clz of
the xor of two distinct 30-bit codes in a 32-bit word, 2-31, else 32 +
clz of the two indices' xor, 32-63). So the guard, which poisons a frame
whose tree is too deep with NaN on the device, never fires on an LBVH; it
keeps a tree of unknown depth from being walked silently.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import logging_util as log
from .accel.lbvh import lbvh_for_triangles
from .config import RenderConfig
from .integrator import trace_samples
from .ops import camera_rays, megakernel, walk
from .packing import WorldArrays


def _as_tensor(x, dtype, device):
    """A numpy input goes to ``device``; a tensor stays on its own."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)


def world_from_deforming(
    tri_verts,  # (T, 3, 3) world-space vertices, moved every frame
    tri_mat,  # (T,) int32 material ids
    materials,  # (M, 8) float32
    lights,  # (L, 8) float32
    with_depth: bool = False,
    device="cuda",
    with_records: bool = True,
):
    """A WorldArrays of deforming world-space triangles over an LBVH built
    on their device, topology rebuilt on every call. Numpy inputs go to
    ``device``; tensors stay where they are.

    With ``with_depth`` it also returns the tree's depth (a 0-d int32 on
    the device) for the traversal-stack guard. Without ``with_records`` the
    miss-link ``records`` (read only by the portable walks) are left out
    (None)."""
    tri_verts = _as_tensor(tri_verts, torch.float32, device)
    dev = tri_verts.device
    tri_mat = _as_tensor(tri_mat, torch.int32, dev)
    materials = _as_tensor(materials, torch.float32, dev)
    lights = _as_tensor(lights, torch.float32, dev)
    n = int(tri_verts.shape[0])
    lb = lbvh_for_triangles(tri_verts)
    order = lb["order"].long()  # leaf j holds triangle order[j]

    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - v0
    e2 = tri_verts[:, 2] - v0
    tris9 = torch.cat([v0, e1, e2], dim=1)  # (T, 9)
    transp = materials[tri_mat.long(), 6]  # TRANSPARENCY column
    menc = tri_mat.float() + 1.0  # world vertices: orientation +1

    bounds = torch.cat([lb["bounds_min"], lb["bounds_max"]], dim=1)

    records = None
    if with_records:  # the miss-link walk: [bounds | meta | tri9 | transp | menc]
        node = torch.arange(2 * n - 1, device=dev)
        node_is_leaf = node >= (n - 1)
        leaf_tri = torch.where(node_is_leaf, order[(node - (n - 1)).clamp(0, n - 1)], 0)
        first = torch.where(node_is_leaf, leaf_tri, lb["left_first"].long())
        meta = torch.stack([first, lb["count"].long(), lb["miss"].long()],
                           dim=1).float()
        records = torch.cat([bounds, meta, tris9[leaf_tri], transp[leaf_tri][:, None],
                             menc[leaf_tri][:, None]], dim=1)
        records = torch.nn.functional.pad(records, (0, (-records.shape[1]) % 8))
        records = records.contiguous()

    # BVH2 child tables (K1, K2/K3), leaf_k = 1
    def child_cols(c):
        c = c.long()
        is_leaf = c >= (n - 1)
        ref = torch.where(is_leaf, c - (n - 1), c).float()
        cnt = torch.where(is_leaf, 1.0, -1.0)
        return bounds[c], ref[:, None], cnt[:, None]

    lb6, lref, lcnt = child_cols(lb["left_child"])
    rb6, rref, rcnt = child_cols(lb["right_child"])
    inner_table = torch.cat([lb6, rb6, lref, rref, lcnt, rcnt], dim=1)  # (n-1, 16)

    leaf_table = torch.cat(
        [tris9[order], transp[order][:, None],
         order.float()[:, None],  # first = the triangle's id
         torch.ones((n, 1), dtype=torch.float32, device=dev),  # count = 1
         menc[order][:, None]],
        dim=1,
    )
    leaf_table = torch.nn.functional.pad(leaf_table, (0, (-leaf_table.shape[1]) % 8))

    ws = WorldArrays(
        tri_v0=v0,
        tri_e1=e1,
        tri_e2=e2,
        tri_mat=tri_mat,
        tri_inst=torch.zeros((n,), dtype=torch.int32, device=dev),
        tri_nsign=torch.ones((n,), dtype=torch.float32, device=dev),
        inner_table=inner_table.contiguous(),
        leaf_table=leaf_table.contiguous(),
        materials=materials.contiguous(),
        lights=lights.contiguous(),
        leaf_k=1,
        tree_depth=0,  # on the device only: the walks guard their stacks
        records=records,
    )
    if with_depth:
        return ws, lb["max_depth"]
    return ws


def render_deforming(
    tri_verts,  # (T, 3, 3) world-space vertices
    tri_mat,  # (T,) int32
    materials,  # (M, 8)
    lights,  # (L, 8)
    camera_params: dict,
    cfg: RenderConfig,
    max_bounces: Optional[int] = None,
    rng_key: int = 0,
    with_stats: bool = False,
    device="cuda",
):
    """Path-trace deforming geometry: LBVH rebuild + render, on the device
    of ``tri_verts`` (numpy inputs go to ``device``). Returns the (H, W, 3)
    frame in [0, 1], bottom-up rows, and with ``with_stats`` the traced-ray
    count (0-d int64).

    kernels="xla" runs the per-wave path on the portable walks; any other
    value runs K1 (megakernel.sample_wave: the kernel on CUDA tensors, its
    plain version on CPU tensors), one launch for all ``cfg.spp`` samples,
    summed in JAX's order (per sample, then across samples in order: sample
    fusion is off, as in JAX's one-sample calls). Every pixel is drawn from
    the pixel grid in scanline order.

    A tree deeper than the walks' stack (depth + 1 > ops.walk.STACK_DEPTH,
    read at call time) makes the whole frame NaN, selected on the device.
    The diagnostic is logged (log.error) only for CPU tensors, where reading
    the depth costs nothing; on the card the NaN frame is the signal, since
    a log would need a host read, and ``world_from_deforming(...,
    with_depth=True)`` gives the depth to a caller that wants it."""
    max_bounces = max_bounces or cfg.max_bounces
    ws, tree_depth = world_from_deforming(tri_verts, tri_mat, materials, lights,
                                          with_depth=True, device=device,
                                          with_records=cfg.kernels == "xla")
    dev = ws.tri_v0.device
    frag, uv = camera_rays.pixel_grid(cfg.width, cfg.height, dev)
    stack = walk.STACK_DEPTH
    depth_ok = tree_depth + 1 <= stack
    if dev.type == "cpu" and not bool(depth_ok):
        log.error(f"rayzen_tpu_torch.deform: LBVH depth {int(tree_depth)} exceeds "
                  f"the {stack}-entry traversal stack; frame poisoned with NaN")

    if cfg.kernels != "xla":
        act = torch.ones((uv.shape[0],), dtype=torch.bool, device=dev)
        total, rays = megakernel.sample_wave(
            ws, cfg.replace(sample_fuse=1), uv, act, camera_params, 0, rng_key,
            max_bounces, n_samples=cfg.spp)
    else:
        total, rays = trace_samples(ws, frag, uv, camera_params, cfg, max_bounces,
                                    rng_key)
    color = torch.clamp(total / float(cfg.spp), 0.0, 1.0)
    color = torch.where(depth_ok, color, float("nan"))
    img = color.reshape(cfg.height, cfg.width, 3)
    if with_stats:
        return img, rays
    return img
