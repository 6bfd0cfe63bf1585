"""Batched intersection primitives over (..., 3) tensors.

Port of rayzen_tpu/ops/intersect.py: the slab test (intersectAABB,
fragment_shader.glsl:380-388) and Moller-Trumbore with det and t epsilons
1e-4 and the geometric face normal (hitTriangle, glsl:391-416). Every
product and sum is written out in the JAX package's order; the walks
(ops/walk.py) and the portable path (ops/traverse.py) share this one copy,
and csrc/common.cuh repeats it for the kernels.
"""

from __future__ import annotations

import torch

DET_EPS = 1e-4
T_EPS = 1e-4
T_FAR = 1e30


def dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross3(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(v, eps: float = 0.0):
    n = torch.sqrt(dot3(v, v))
    if eps:
        n = torch.clamp_min(n, eps)
    return v / n[..., None]


def safe_inv(d):
    """Huge-but-finite reciprocal: no 0 * inf NaNs in the slab test for
    axis-parallel rays (pallas_traverse._safe_inv, traverse._safe_inv_dir)."""
    return torch.where(d >= 0.0, 1.0, -1.0) / torch.clamp_min(d.abs(), 1e-30)


def slab_test(origin, inv_dir, bmin, bmax):
    """Ray-box slab test over (..., 3): (tmin, tmax, hit), hit = tmax >=
    max(tmin, 0). A 0 * inf NaN on an axis leaves that axis unconstrained,
    as in the JAX function; with safe_inv directions none arises."""
    inf = float("inf")
    t0 = torch.nan_to_num((bmin - origin) * inv_dir, nan=-inf, posinf=inf,
                          neginf=-inf)
    t1 = torch.nan_to_num((bmax - origin) * inv_dir, nan=inf, posinf=inf,
                          neginf=-inf)
    tsmall = torch.minimum(t0, t1)
    tbig = torch.maximum(t0, t1)
    tmin = torch.maximum(torch.maximum(tsmall[..., 0], tsmall[..., 1]),
                         tsmall[..., 2])
    tmax = torch.minimum(torch.minimum(tbig[..., 0], tbig[..., 1]), tbig[..., 2])
    return tmin, tmax, tmax >= torch.clamp_min(tmin, 0.0)


def moller_trumbore_raw(origin, direction, v0, e1, e2):
    """Moller-Trumbore over matching (..., 3) shapes: (t, hit) with t
    unmasked (the walks' form, pallas_traverse._mt_broadcast)."""
    h = cross3(direction, e2)
    a = dot3(e1, h)
    valid = a.abs() >= DET_EPS
    f = 1.0 / torch.where(valid, a, 1.0)
    s = origin - v0
    u = f * dot3(s, h)
    q = cross3(s, e1)
    v = f * dot3(direction, q)
    t = f * dot3(e2, q)
    hit = valid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_EPS)
    return t, hit


def moller_trumbore(origin, direction, v0, e1, e2):
    """(t, hit) with t = T_FAR where there is no hit (intersect.moller_trumbore).
    The normal, when needed, is face_normal(e1, e2): not flipped toward the
    ray (glsl:411)."""
    t, hit = moller_trumbore_raw(origin, direction, v0, e1, e2)
    return torch.where(hit, t, T_FAR), hit


def face_normal(e1, e2):
    return normalize(cross3(e1, e2), eps=1e-20)


class Ray:
    """Host-side ray (origin + direction) with point_at: API parity with the
    reference's CPU Ray (RayZen/include/Ray.h:6-18), which the render path
    does not use either (rays are (R, 3) tensors there). Float32 tensors on
    the device the inputs carry (the CPU for numbers and arrays)."""

    def __init__(self, origin, direction):
        self.origin = torch.as_tensor(origin, dtype=torch.float32)
        self.direction = torch.as_tensor(direction, dtype=torch.float32)

    def point_at(self, t):
        return self.origin + self.direction * t
