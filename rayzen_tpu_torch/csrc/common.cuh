// Shared device math of the port's kernels: intersection, RNG and shading
// helpers, each written as the same sequence of float operations as its JAX
// counterpart (rayzen_tpu/ops/pallas_traverse.py, rayzen_tpu/ops/megakernel.py)
// and as the plain PyTorch versions in rayzen_tpu_torch/ops/*.py.
//
// Build without --use_fast_math and with --fmad=false (ext.py): every
// multiply and add rounds on its own, as in the plain versions; the
// hemisphere's sinf/cosf are CUDA's accurate library functions, not
// __sinf/__cosf, and the sin hash uses sinf_libm below.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define RZ_DEV __device__ __forceinline__

namespace rz {

// ops/intersect.py: Moller-Trumbore epsilons and the no-hit distance
constexpr float DET_EPS = 1e-4f;
constexpr float T_EPS = 1e-4f;
constexpr float T_FAR = 1e30f;
// glsl:197 literal (megakernel.PI_REF)
constexpr float PI_REF = 3.14159f;
// per-thread traversal stack: a single-pop walk holds at most depth + 1
// entries; the wrappers check ws.tree_depth + 1 against this on the host and
// the walks NaN-poison their result if a tree of unknown depth overflows it
constexpr int STACK_DEPTH = 64;

constexpr unsigned kFullMask = 0xffffffffu;  // every lane of a warp

RZ_DEV float nan_f() { return __int_as_float(0x7fc00000); }

RZ_DEV float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return (ax * bx + ay * by) + az * bz;
}

// megakernel._normalize: v / max(|v|, eps)
RZ_DEV void normalize3(float& x, float& y, float& z, float eps) {
  float n = fmaxf(sqrtf((x * x + y * y) + z * z), eps);
  x = x / n;
  y = y / n;
  z = z / n;
}

RZ_DEV float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// x**5 as jax.lax.integer_pow evaluates it: x * ((x*x) * (x*x))
RZ_DEV float pow5(float x) {
  float x2 = x * x;
  return x * (x2 * x2);
}

// pallas_traverse._safe_inv: huge-but-finite inverse, no 0 * inf NaNs
RZ_DEV float safe_inv(float d) {
  return (d >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(d), 1e-30f);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

RZ_DEV Ray make_ray(float ox, float oy, float oz, float dx, float dy, float dz) {
  return Ray{ox, oy, oz, dx, dy, dz, safe_inv(dx), safe_inv(dy), safe_inv(dz)};
}

// pallas_traverse._slab over one box b = [bmin(3) bmax(3)]
RZ_DEV bool slab(const Ray& r, const float* b, float& tmin) {
  float t0 = (b[0] - r.ox) * r.ix;
  float t1 = (b[3] - r.ox) * r.ix;
  float lo = fminf(t0, t1);
  float hi = fmaxf(t0, t1);
  t0 = (b[1] - r.oy) * r.iy;
  t1 = (b[4] - r.oy) * r.iy;
  lo = fmaxf(lo, fminf(t0, t1));
  hi = fminf(hi, fmaxf(t0, t1));
  t0 = (b[2] - r.oz) * r.iz;
  t1 = (b[5] - r.oz) * r.iz;
  lo = fmaxf(lo, fminf(t0, t1));
  hi = fminf(hi, fmaxf(t0, t1));
  tmin = lo;
  return hi >= fmaxf(lo, 0.0f);
}

// pallas_traverse._mt_broadcast: one triangle, v0, e1 and e2 in the xyz of
// three float4s (their w is not read)
RZ_DEV bool moller_trumbore(const Ray& r, const float4& v0, const float4& e1,
                            const float4& e2, float& t) {
  const float v0x = v0.x, v0y = v0.y, v0z = v0.z;
  const float e1x = e1.x, e1y = e1.y, e1z = e1.z;
  const float e2x = e2.x, e2y = e2.y, e2z = e2.z;
  float hx = r.dy * e2z - r.dz * e2y;
  float hy = r.dz * e2x - r.dx * e2z;
  float hz = r.dx * e2y - r.dy * e2x;
  float a = (e1x * hx + e1y * hy) + e1z * hz;
  bool valid = fabsf(a) >= DET_EPS;
  float f = 1.0f / (valid ? a : 1.0f);
  float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  float u = f * ((sx * hx + sy * hy) + sz * hz);
  float qx = sy * e1z - sz * e1y;
  float qy = sz * e1x - sx * e1z;
  float qz = sx * e1y - sy * e1x;
  float v = f * ((r.dx * qx + r.dy * qy) + r.dz * qz);
  t = f * ((e2x * qx + e2y * qy) + e2z * qz);
  return valid && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
         (u + v <= 1.0f) && (t > T_EPS);
}

// The same test on a triangle row tri = [v0(3) e1(3) e2(3)]
RZ_DEV bool moller_trumbore(const Ray& r, const float* tri, float& t) {
  const float4 v0 = make_float4(__ldg(tri + 0), __ldg(tri + 1), __ldg(tri + 2), 0.0f);
  const float4 e1 = make_float4(__ldg(tri + 3), __ldg(tri + 4), __ldg(tri + 5), 0.0f);
  const float4 e2 = make_float4(__ldg(tri + 6), __ldg(tri + 7), __ldg(tri + 8), 0.0f);
  return moller_trumbore(r, v0, e1, e2, t);
}

// ---- the warp map of K1 and K7 ----
//
// A launch over n slots (pixels, or rays of a wave) of a width x height
// frame, in blocks of kThreads: block tile ``tile`` is a kTileW x
// (kThreads / kTileW) screen tile, its warps 8 x 4 pixels, two across, and
// the tiles are clipped at the right and bottom edges; any other wave (n !=
// width x height) is mapped linearly. Either map gives each slot exactly
// one lane, and a slot's result does not depend on its lane, so the map
// changes only which rays share a warp. The plain form is
// ops/megakernel.py tile_pixels.
constexpr int kTileW = 16;

// Block tiles of a launch over n slots.
template <int kThreads>
__host__ __device__ inline int tile_blocks(int n, int width, int height) {
  static_assert(kThreads % 64 == 0, "a block is whole 16-pixel rows of warps");
  constexpr int kTileH = kThreads / kTileW;
  if ((long long)width * height != n) return (n + kThreads - 1) / kThreads;
  return ((width + kTileW - 1) / kTileW) * ((height + kTileH - 1) / kTileH);
}

// The slot of lane ``lane`` of warp ``warp`` in block tile ``tile``, -1 for
// none.
template <int kThreads>
RZ_DEV int tile_pixel(int tile, int warp, int lane, int n, int width,
                      int height) {
  if ((long long)width * height != n) {
    const int i = tile * kThreads + warp * 32 + lane;
    return i < n ? i : -1;
  }
  constexpr int kTileH = kThreads / kTileW;
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int x = (tile % tiles_x) * kTileW + (warp & 1) * 8 + (lane & 7);
  const int y = (tile / tiles_x) * kTileH + (warp >> 1) * 4 + (lane >> 3);
  return x < width && y < height ? y * width + x : -1;
}

// The compiled budget of a kernel launched with ``threads`` threads: out =
// {threads per block, registers per thread, local memory per thread in bytes
// (the walk stacks and any spills), resident warps per SM}.
template <class Kernel>
inline int budget_of(Kernel kernel, int threads, int* out) {
  cudaFuncAttributes a{};
  int blocks = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                      0);
  }
  out[0] = threads;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = blocks * (threads / 32);
  return static_cast<int>(e);
}

// ---- RNG (megakernel._ref_rand, _hash_u32, _u32_to_unit_float) ----

// libm's single-precision sine (glibc / Arm optimized-routines sinf), the one
// XLA's CPU backend calls and so the one behind tests/golden/*.npz; see
// sinf_libm in ops/megakernel.py. The sin hash multiplies sin by 43758.5453,
// so CUDA's own sinf, which differs from it in the last bit for some
// arguments, would send those paths elsewhere. float64 reduction and
// polynomial, rounded once to float32.
static __device__ const uint32_t kInvPio4[24] = {
    0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
    0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
    0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};

// sin (n even) or cos (n odd, negated when neg) polynomial
RZ_DEV double sinf_poly(double x, double x2, int n, bool neg) {
  if ((n & 1) == 0) {
    const double x3 = x * x2;
    const double s1 = 0x1.1107605230bc4p-7 + x2 * -0x1.994eb3774cf24p-13;
    const double x7 = x3 * x2;
    const double s = x + x3 * -0x1.555545995a603p-3;
    return s + x7 * s1;
  }
  const double g = neg ? -1.0 : 1.0;
  const double x4 = x2 * x2;
  const double c2 = g * -0x1.6c087e89a359dp-10 + x2 * (g * 0x1.99343027bf8c3p-16);
  const double c1 = g * 0x1p0 + x2 * (g * -0x1.ffffffd0c621cp-2);
  const double x6 = x4 * x2;
  const double c = c1 + x4 * (g * 0x1.55553e1068f19p-5);
  return c + x6 * c2;
}

RZ_DEV double quadrant_sign(int q) { return (q & 3) == 1 || (q & 3) == 2 ? -1.0 : 1.0; }

RZ_DEV float sinf_libm(float y) {
  const uint32_t bits = __float_as_uint(y);
  const uint32_t top = (bits >> 20) & 0x7ff;
  const double x = (double)y;
  if (top < (0x3F490FDBu >> 20)) {  // |y| < pi/4
    if (top < (0x39800000u >> 20)) return y;  // |y| < 2^-12
    return (float)sinf_poly(x, x * x, 0, false);
  }
  if (top < (0x42F00000u >> 20)) {  // |y| < 120
    const double r = x * 0x1.45F306DC9C883p+23;  // 2/pi * 2^24
    const int n = ((int32_t)r + 0x800000) >> 24;
    double xr = x - (double)n * 0x1.921FB54442D18p0;
    xr = xr * quadrant_sign(n);
    return (float)sinf_poly(xr, xr * xr, n, (n & 2) != 0);
  }
  if (top < 0x7F8u) {  // finite: integer reduction against 4/pi
    const uint32_t* arr = &kInvPio4[(bits >> 26) & 15];
    const int shift = (bits >> 23) & 7;
    const uint32_t xi = ((bits & 0xffffffu) | 0x800000u) << shift;
    uint64_t res0 = xi * arr[0];  // low 32 bits only, as in libm
    const uint64_t res1 = (uint64_t)xi * arr[4];
    const uint64_t res2 = (uint64_t)xi * arr[8];
    res0 = (res2 >> 32) | (res0 << 32);
    res0 += res1;
    const uint64_t n = (res0 + (1ULL << 61)) >> 62;
    res0 -= n << 62;
    double xl = (double)(int64_t)res0 * 0x1.921FB54442D18p-62;
    const int q = (int)n + (int)(bits >> 31);
    xl = xl * quadrant_sign(q);
    return (float)sinf_poly(xl, xl * xl, (int)n, (q & 2) != 0);
  }
  return nan_f();
}

// fract(sin(x * 12.9898 + y * 78.233) * 43758.5453)  (glsl:188-190). The
// first product is fused into a multiply-add, as XLA's CPU backend fuses it
// (see _fma in ops/megakernel.py): one ulp here is a different draw.
RZ_DEV float ref_rand(float x, float y) {
  float s = sinf_libm(__fmaf_rn(x, 12.9898f, y * 78.233f)) * 43758.5453f;
  return s - floorf(s);
}

// lowbias32
RZ_DEV uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

RZ_DEV float u32_to_unit(uint32_t x) {
  return (float)(int32_t)(x >> 8) * (1.0f / 16777216.0f);
}

}  // namespace rz
