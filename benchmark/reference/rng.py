"""The upstream shader's sin-hash random numbers (fragment_shader.glsl
rand(), :188-190; per-sample seed :688; per-bounce tempseed :696), frozen
here for the plain reference.

The hash multiplies sin by 43758.5453, so one ulp of its argument moves a
draw by ~1e-3 and sends a path elsewhere: a reference that is to follow
the same paths has to reproduce the draws bit for bit. The draws are
defined as XLA's CPU arithmetic makes them (the renderer's golden images
were made so): libm's single-precision sinf, evaluated here exactly in
float64 and rounded once, and multiply-adds fused where XLA fuses them.
This is a frozen copy of that arithmetic; it imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np
import torch

_SIN_SIGN = (1.0, -1.0, -1.0, 1.0)
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")  # 2/pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")  # pi/2
_PI63 = float.fromhex("0x1.921FB54442D18p-62")  # pi * 2^-63
_COS_POLY = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN_POLY = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))
_INV_PIO4 = (  # 4/pi in 24-bit steps
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041,
)


def _poly(x, x2, n, neg_cos):
    s1, s2, s3 = _SIN_POLY
    x3 = x * x2
    sin = (x + x3 * s1) + (x3 * x2) * (s2 + x2 * s3)
    c0, c1, c2, c3, c4 = _COS_POLY
    sgn = torch.where(neg_cos, -1.0, 1.0).double()
    x4 = x2 * x2
    cos = ((sgn * c0 + x2 * (sgn * c1)) + x4 * (sgn * c2)) + (x4 * x2) * (
        sgn * c3 + x2 * (sgn * c4))
    return torch.where((n & 1) == 0, sin, cos)


def sinf(y):
    """libm's sinf of a float32 tensor, bit for bit."""
    x = y.double()
    bits = y.view(torch.int32).long() & 0xFFFFFFFF
    top = (bits >> 20) & 0x7FF
    sign_t = torch.tensor(_SIN_SIGN, dtype=torch.float64, device=y.device)
    small = top < (0x3F490FDB >> 20)
    out_small = torch.where(
        top < (0x39800000 >> 20), x,
        _poly(x, x * x, torch.zeros_like(bits), torch.zeros_like(small)))
    r = x * _HPI_INV
    n_mid = (r.trunc().long() + 0x800000) >> 24
    xr = (x - n_mid.double() * _HPI) * sign_t[n_mid & 3]
    out_mid = _poly(xr, xr * xr, n_mid, (n_mid & 2) != 0)
    tab = torch.tensor(_INV_PIO4, dtype=torch.int64, device=y.device)
    idx = (bits >> 26) & 15
    xi = ((bits & 0xFFFFFF) | 0x800000) << ((bits >> 23) & 7)
    res0 = (xi * tab[idx]) & 0xFFFFFFFF
    res1 = xi * tab[idx + 4]
    res2 = xi * tab[idx + 8]
    res0 = ((res2 >> 32) | (res0 << 32)) + res1
    n_big = ((res0 + (1 << 61)) >> 62) & 3
    xl = (res0 - (n_big << 62)).double() * _PI63
    q = n_big + (bits >> 31)
    xl = xl * sign_t[q & 3]
    out_big = _poly(xl, xl * xl, n_big, (q & 2) != 0)
    out = torch.where(small, out_small,
                      torch.where(top < (0x42F00000 >> 20), out_mid, out_big))
    return torch.where(top < 0x7F8, out, float("nan")).float()


def f32(x) -> float:
    return float(np.float32(x))


def fma(a, b, c):
    """float32 a * b + c rounded once."""
    b = b.double() if isinstance(b, torch.Tensor) else f32(b)
    c = c.double() if isinstance(c, torch.Tensor) else f32(c)
    return (a.double() * b + c).float()


def rand(x, y):
    """fract(sin(dot((x, y), (12.9898, 78.233))) * 43758.5453)."""
    s = sinf(fma(x, 12.9898, y * 78.233)) * 43758.5453
    return s - torch.floor(s)


def bounce_draws(s0, s1, samp_f, b: int):
    """(rand_val, hemi_u, hemi_v) of bounce b from the sample's seeds."""
    b_f = torch.tensor(float(b), dtype=torch.float32, device=s0.device)
    ts0 = fma(s0 * (b_f * b_f), 12793.46, b_f * 1423.34)
    ts1 = fma(s1 * (b_f * b_f), 12793.46, b_f * 1423.34)
    return rand(ts0 + samp_f, ts1 + b_f), rand(ts0, ts1), rand(ts0 + 1.0, ts1 + 1.0)
