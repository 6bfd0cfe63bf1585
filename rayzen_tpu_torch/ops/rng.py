"""Per-ray random numbers: the sin-hash and the lowbias32 hash, and the two
samplers of the per-wave path.

Port of rayzen_tpu/ops/rng.py. ``ReferenceSampler`` reproduces the
reference shader's sin-hash PRNG and its seeding flow (rand():
fragment_shader.glsl:188-190; per-sample seed :688; per-bounce tempseed
:696; scatter/RR draw :720, :766; hemisphere draws :193-194; camera jitter
:205); ``HashSampler`` is the counter-based lowbias32 hash keyed on (pixel,
sample, bounce, dim). The hash helpers below are the one copy the port
has: K1's plain version (ops/megakernel.py) and the samplers use them, and
csrc/common.cuh repeats them for the kernels.

The sin hash must reproduce XLA's CPU arithmetic bit for bit, because it
amplifies sin by 43758.5453: one ulp of difference moves a draw by ~1e-3
and sends the path elsewhere. So sin is libm's ``sinf`` algorithm
(``sinf_libm``), never ``torch.sin``, and the multiply-adds that feed it
are fused (``_fma``) where XLA's CPU backend fuses them (checked bitwise
against jitted JAX). The samplers hold uint32 values in int64 tensors.
"""

from __future__ import annotations

import numpy as np
import torch

# libm's single-precision sine (the glibc / Arm optimized-routines sinf): the
# function XLA's CPU backend calls for jnp.sin on float32, so the one that
# made tests/golden/*.npz. torch.sin differs from it on ~5% of the sin-hash's
# arguments (CUDA's sinf is another implementation again), so the sin hash
# evaluates this algorithm exactly: float64 argument reduction and
# polynomial, rounded once to float32.
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


def _sinf_poly(x, x2, n, neg_cos):
    """sin (n even) or cos (n odd) polynomial on the reduced argument."""
    s1, s2, s3 = _SIN_POLY
    x3 = x * x2
    sin = (x + x3 * s1) + (x3 * x2) * (s2 + x2 * s3)
    c0, c1, c2, c3, c4 = _COS_POLY
    sgn = torch.where(neg_cos, -1.0, 1.0).double()
    x4 = x2 * x2
    cos = ((sgn * c0 + x2 * (sgn * c1)) + x4 * (sgn * c2)) + (x4 * x2) * (
        sgn * c3 + x2 * (sgn * c4))
    return torch.where((n & 1) == 0, sin, cos)


def sinf_libm(y):
    """sin of a float32 tensor, bit-identical to libm's sinf (see above)."""
    x = y.double()
    bits = y.view(torch.int32).long() & 0xFFFFFFFF
    top = (bits >> 20) & 0x7FF
    sign_t = torch.tensor(_SIN_SIGN, dtype=torch.float64, device=y.device)
    # |y| < pi/4: no reduction; |y| < 2^-12: sin y = y
    small = top < (0x3F490FDB >> 20)
    out_small = torch.where(
        top < (0x39800000 >> 20), x,
        _sinf_poly(x, x * x, torch.zeros_like(bits), torch.zeros_like(small)),
    )
    # |y| < 120: one multiply-subtract reduction
    r = x * _HPI_INV
    n_mid = (r.trunc().long() + 0x800000) >> 24
    xr = x - n_mid.double() * _HPI
    xr = xr * sign_t[n_mid & 3]
    out_mid = _sinf_poly(xr, xr * xr, n_mid, (n_mid & 2) != 0)
    # larger: integer reduction against 4/pi (uint64 math in int64 bits)
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
    out_big = _sinf_poly(xl, xl * xl, n_big, (q & 2) != 0)
    out = torch.where(small, out_small,
                      torch.where(top < (0x42F00000 >> 20), out_mid, out_big))
    out = torch.where(top < 0x7F8, out, float("nan"))  # inf / nan -> nan
    return out.float()


def _f32(x) -> float:
    return float(np.float32(x))


def _fma(a, b, c):
    """float32 a * b + c with one rounding (a fused multiply-add): the exact
    float64 product plus c, rounded once to float32 (a second rounding
    changes the result only when the float64 sum lands on a float32 tie).
    ``b`` and ``c`` are tensors or Python floats (taken as float32)."""
    b = b.double() if isinstance(b, torch.Tensor) else _f32(b)
    c = c.double() if isinstance(c, torch.Tensor) else _f32(c)
    return (a.double() * b + c).float()


# XLA's CPU backend fuses the first product of ``a * b + c * d`` into a
# multiply-add (checked bitwise against jitted JAX on the CPU), and the sin
# hash turns one ulp of its argument into a different draw. So the
# multiply-adds that feed the sin hash are fused here (the dot product, the
# tempseed, and in the per-wave jitter the seed + 1), and only those; the
# rest of the arithmetic rounds every operation, which moves a colour by
# ulps, not by a whole path.


def _ref_rand(x, y):
    """fract(sin(dot(v, (12.9898, 78.233))) * 43758.5453) (glsl:188-190)."""
    s = sinf_libm(_fma(x, 12.9898, y * 78.233)) * 43758.5453
    return s - torch.floor(s)


def ref_rand(uv):
    """The sin hash over a (..., 2) float32 tensor (rand(), glsl:188-190),
    bit for bit XLA's CPU arithmetic on any device."""
    return _ref_rand(uv[..., 0], uv[..., 1])


def _tempseed(s, b_f):
    """seed * (b * b) * 12793.46 + b * 1423.34 (glsl:696), fused as XLA
    fuses it; ``b_f`` the bounce as a float32 tensor."""
    return _fma(s * (b_f * b_f), 12793.46, b_f * 1423.34)


def _bounce_draws_reference(s0, s1, samp_f, b_f):
    """ReferenceSampler.bounce_draws from the seeds (s0, s1); ``samp_f`` and
    ``b_f`` (the bounce) are float32 tensors, so that every product rounds
    in float32 as in JAX."""
    ts0, ts1 = _tempseed(s0, b_f), _tempseed(s1, b_f)
    rand_val = _ref_rand(ts0 + samp_f, ts1 + b_f)
    hemi_u = _ref_rand(ts0, ts1)
    hemi_v = _ref_rand(ts0 + 1.0, ts1 + 1.0)
    return rand_val, hemi_u, hemi_v


_M32 = 0xFFFFFFFF


def _mul_u32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, without overflow."""
    return (x * (c & 0xFFFF) + ((x * (c >> 16)) & 0xFFFF) * 65536) & _M32


def _hash_u32(x):
    """lowbias32 on uint32 values held in int64 tensors."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _u32_to_unit_float(x):
    """The top 24 bits as a float in [0, 1)."""
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _bounce_draws_hash(h_pix, samp_u: int, b: int):
    """The hash flow's (rand_val, hemi_u, hemi_v) of bounce b, from the keyed
    pixel hash ``h_pix`` (dims 2, 3, 4)."""
    base = (h_pix + ((samp_u * 7919) & _M32) + b * 127) & _M32
    rand_val = _u32_to_unit_float(_hash_u32(base + 2))
    hemi_u = _u32_to_unit_float(_hash_u32(base + 3))
    hemi_v = _u32_to_unit_float(_hash_u32(base + 4))
    return rand_val, hemi_u, hemi_v


def _as_f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class ReferenceSampler:
    """The reference shader's stateful flow. ``pixel_uv`` (R, 2) in [0, 1];
    ``frag`` (R, 2) gl_FragCoord (pixel centre, +0.5)."""

    def __init__(self, pixel_uv, frag):
        self.pixel_uv = pixel_uv
        self.frag = frag
        self.seed = None

    def start_sample(self, samp):
        # seed = uv * float(fragX + fragY + samp + 1.0)  (glsl:688)
        samp_f = _as_f32(samp, self.frag.device)
        self.scale = self.frag[:, 0] + self.frag[:, 1] + (samp_f + 1.0)
        self.seed = self.pixel_uv * self.scale[:, None]

    def camera_jitter(self):
        # (glsl:205) jitter = (rand(seed), rand(seed + 1)) * 2e-5. In seed +
        # 1 XLA fuses the seed's own product into a multiply-add as well
        # (checked bitwise against jitted JAX): uv * scale + 1, one rounding.
        s0, s1 = self.seed[:, 0], self.seed[:, 1]
        j0 = _ref_rand(s0, s1)
        j1 = _ref_rand(_fma(self.pixel_uv[:, 0], self.scale, 1.0),
                       _fma(self.pixel_uv[:, 1], self.scale, 1.0))
        return torch.stack([j0, j1], dim=-1) * 0.00002

    def _tempseed(self, bounce):
        # (glsl:696)
        b_f = _as_f32(bounce, self.seed.device)
        return _tempseed(self.seed, b_f)

    def bounce_draws(self, samp, bounce):
        """(rand_val, hemi_u, hemi_v); the reference reuses rand_val for both
        the reflect-vs-diffuse choice (:720) and Russian roulette (:766)."""
        dev = self.seed.device
        return _bounce_draws_reference(
            self.seed[:, 0], self.seed[:, 1], _as_f32(samp, dev),
            _as_f32(bounce, dev))


class HashSampler:
    """Counter-based sampler: value = hash(pixel_id, key, sample, bounce,
    dim). ``pixel_id`` (R,) integer tensor, read as uint32."""

    # dimension tags
    JITTER_X, JITTER_Y, SCATTER, HEMI_U, HEMI_V = 0, 1, 2, 3, 4

    def __init__(self, pixel_id, key: int = 0):
        self.pixel_id = pixel_id.long() & _M32
        self.key = int(key) & _M32
        self._samp = 0
        key_h = int(_hash_u32(torch.tensor((self.key + 0x9E3779B9) & _M32)))
        self._h_pix = _hash_u32(self.pixel_id ^ key_h)

    def start_sample(self, samp):
        self._samp = int(samp)

    def _draw(self, bounce: int, dim: int):
        h = (self._h_pix + ((self._samp * 7919) & _M32) + int(bounce) * 127
             + dim) & _M32
        return _u32_to_unit_float(_hash_u32(h))

    def camera_jitter(self):
        jx = self._draw(0, self.JITTER_X) - 0.5
        jy = self._draw(0, self.JITTER_Y) - 0.5
        return torch.stack([jx, jy], dim=-1)  # full-pixel AA jitter

    def bounce_draws(self, samp, bounce):
        return (
            self._draw(bounce, self.SCATTER),
            self._draw(bounce, self.HEMI_U),
            self._draw(bounce, self.HEMI_V),
        )
