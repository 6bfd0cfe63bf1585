// K4's continuation kernel: resume the rays still alive after phase 1 at
// bounce b_start from their 13 continuation rows and trace them to b_stop.
//
// Replaces rayzen_tpu/ops/megakernel.py::_make_continuation_kernel (:743),
// launched by sample_wave_split (:1022). Phase 1 (sample_kernel.cu with a
// state output) traces bounces 0..split-1 and writes the rows, in pixel
// order; the host computes the compaction permutation (ops/megakernel.py
// _compaction_permutation, cumsum ranks as in JAX): ``order`` (slot ->
// pixel, the live rays first) and the live count, both left on the device.
// This kernel reads the rows of the ray in slot j < live through the
// permutation, in place, runs the shared bounce loop (shade.cuh), adds the
// path's colour (from 0, as in JAX :781-786) into phase 1's colour at its
// pixel (the single add JAX's scatter makes), and adds its rays into an
// int64 total. With split_every (emit) it writes the rows for the next
// compaction back at the pixel; a dead pixel's rows are never touched (its
// alive row is already 0). So the state stays in pixel order for the whole
// sample and no (13, R) copy is gathered or scattered. kOctant runs the
// bounce walks as K9.
//
// What bounds it on an H100: the walks, over the few live rays (6.6% of a
// 1080p frame after phase 1 at split_bounce 2, half of them past one more
// bounce): the chain of a path's dependent node loads, L2-resident tables
// (~0.5 MB for the demo), and lanes that idle once their path ends. The
// design: (1) a persistent grid of the blocks the card holds at once whose
// warps take 32 live slots at a time from a device counter (one atomicAdd
// per warp per take) until the device live count is reached, so no block
// is launched for the dead slots and no count comes back to the host; a
// warp's 32 rays are consecutive in the compaction's order (one direction
// octant under the octant rebin) and walk each bounce together. A form
// where a lane whose path ends takes the next live ray at once (in-thread
// regeneration, as K1's regen_kernel) was measured and dropped: no faster at
// split_bounce 2 (136k live rays, about one a resident lane) and 1.11x at
// split_bounce 1 (PERF.md §6): it mixes rays of other bounces and octants
// into a warp. (2) K1's register budget, __launch_bounds__(128, 8): 64
// registers for 32 resident warps per SM (128 x 6 and 128 x 4 measured
// slower). Each ray's path depends only on its own rows, so which lane
// traces it changes no pixel's colour and no ray count.
#include <algorithm>

#include "shade.cuh"

namespace {

using rz::Path;
using rz::SampleParams;

// Block size and the blocks each SM must hold at once (__launch_bounds__):
// K1's 128 x 8; scripts/k1_schedule.py rebuilds with other values (-D) to
// sweep them.
#ifndef RZ_CONT_THREADS
#define RZ_CONT_THREADS 128
#endif
#ifndef RZ_CONT_MIN_BLOCKS
#define RZ_CONT_MIN_BLOCKS 8
#endif
constexpr int kThreads = RZ_CONT_THREADS;
static_assert(kThreads % 32 == 0, "whole warps");

// A launch's split state: the (13, n) rows in pixel order, the permutation
// and the live count on the device, the colour and the ray total they add
// into, and the slot counter (zeroed by the launcher).
struct Split {
  float* state;
  int n;
  const int* order;
  const int* live;
  float* color;
  unsigned long long* rays;
  int* next;
  bool emit;
};

// The ray of pixel ``pix``: its path from the rows and its sampler seeds.
__device__ __forceinline__ void load_ray(const Split& s, int pix, Path& path,
                                         rz::Sampler& smp) {
  const auto row = [&](int k) { return s.state[(size_t)k * s.n + pix]; };
  path = Path{};
  path.alive = row(rz::kAlive) > 0.5f;
  path.ox = row(rz::kOx);
  path.oy = row(rz::kOy);
  path.oz = row(rz::kOz);
  path.dx = row(rz::kDx);
  path.dy = row(rz::kDy);
  path.dz = row(rz::kDz);
  path.tp[0] = row(rz::kTx);
  path.tp[1] = row(rz::kTy);
  path.tp[2] = row(rz::kTz);
  path.ior = row(rz::kIor);
  smp.s0 = row(rz::kS0);
  smp.s1 = row(rz::kS1);
}

// A path that ended: its colour into the pixel's, its rows for the next
// compaction.
__device__ __forceinline__ void finish_ray(const Split& s, int pix,
                                           const Path& path,
                                           const rz::Sampler& smp) {
  float* c = s.color + 3 * (size_t)pix;
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = c[k] + path.c[k];
  if (s.emit) rz::store_state(s.state, s.n, pix, path, smp.s0, smp.s1);
}

// The warp's traced rays into the total: one atomic a warp.
__device__ __forceinline__ void add_rays(const Split& s,
                                         unsigned long long rays) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    rays += __shfl_xor_sync(rz::kFullMask, rays, off);
  }
  if ((threadIdx.x & 31) == 0 && rays) atomicAdd(s.rays, rays);
}

// The sin-hash sampler of the split (the host checks the flow).
__device__ __forceinline__ rz::Sampler split_sampler(const SampleParams& p) {
  rz::Sampler smp{};
  smp.hash = false;
  smp.samp_f = p.samp0;
  return smp;
}

// One ray a lane: a warp takes 32 live slots (consecutive in the
// compaction's order, so of one direction octant under the octant rebin),
// traces them through the shared bounce loop and takes the next 32. With
// kOctant every lane of the warp stays in the loop (K9's votes name the
// whole warp).
template <class Walk, bool kOctant>
__global__ void __launch_bounds__(kThreads, RZ_CONT_MIN_BLOCKS)
    continuation_kernel(Walk w, const float* __restrict__ mats, Split s,
                        SampleParams p) {
  const int lane = threadIdx.x & 31;
  const int live = *s.live;
  unsigned long long rays = 0;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(s.next, 32);
    base = __shfl_sync(rz::kFullMask, base, 0);
    if (base >= live) break;
    const int j = base + lane;
    Path path{};
    rz::Sampler smp = split_sampler(p);
    const int pix = j < live ? __ldg(s.order + j) : -1;
    if (pix >= 0) load_ray(s, pix, path, smp);
    rz::trace_bounces<kOctant>(w, mats, p, smp, p.b_start, p.b_stop, path);
    if (pix >= 0) {
      finish_ray(s, pix, path, smp);
      rays += path.rays;
    }
  }
  add_rays(s, rays);
}

// Blocks of a persistent launch of ``kernel``: as many as the card holds at
// once (0 on an error, returned in *err).
template <class Kernel>
int persistent_blocks(Kernel kernel, cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  }
  *err = e;
  return e == cudaSuccess ? std::max(1, sms * per_sm) : 0;
}

template <bool kOctant, class Walk>
int launch_continuation(Walk w, const float* mats, const Split& s,
                        const SampleParams* params, void* stream) {
  if (s.n <= 0) return static_cast<int>(cudaGetLastError());
  const auto kernel = continuation_kernel<Walk, kOctant>;
  cudaError_t e = cudaSuccess;
  const int blocks = persistent_blocks(kernel, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(s.next, 0, sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, kThreads, 0, st>>>(w, mats, s, *params);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// state: (13, n) float32 continuation rows (rz::StateRow) in pixel order,
// rewritten in place when emit != 0; order: (n,) int32 slot -> pixel; live:
// the live count (one int32 on the device); color: (n, 3) float32, added
// into; rays: one int64, added into; next: one int32 of scratch (the slot
// counter).
#define RZ_CONT_ARGS                                                        \
  const float *inner, const float *leaf, int leaf_w, int leaf_k,            \
      const float *mats, float *state, int n, const int *order,             \
      const int *live, const rz::SampleParams *params, float *color,        \
      long long *rays, int *next, int emit, void *stream
#define RZ_CONT_SPLIT                                                       \
  Split {                                                                   \
    state, n, order, live, color,                                           \
        reinterpret_cast<unsigned long long*>(rays), next, emit != 0        \
  }
#define RZ_CONT_WALK rz::Bvh2Walk{{inner, leaf, leaf_w, leaf_k}}

int rz_continuation(RZ_CONT_ARGS) {
  return launch_continuation<false>(RZ_CONT_WALK, mats, RZ_CONT_SPLIT, params,
                                    stream);
}

int rz_continuation_octant(RZ_CONT_ARGS) {
  return launch_continuation<true>(RZ_CONT_WALK, mats, RZ_CONT_SPLIT, params,
                                   stream);
}

// The counting forms (the walks through rz::Counted, LaneCount at every
// step; read with rz_continuation_lanes): diagnostics, off the render path.
int rz_continuation_count(RZ_CONT_ARGS) {
  return launch_continuation<false>(rz::Counted<rz::Bvh2Walk>{RZ_CONT_WALK},
                                    mats, RZ_CONT_SPLIT, params, stream);
}

int rz_continuation_octant_count(RZ_CONT_ARGS) {
  return launch_continuation<true>(rz::Counted<rz::Bvh2Walk>{RZ_CONT_WALK},
                                   mats, RZ_CONT_SPLIT, params, stream);
}

int rz_continuation_lanes(unsigned long long* out, int reset) {
  return rz::read_walk_lanes(out, reset);
}

// The compiled budget (rz::budget_of) of a form: 0 plain, 1 K9.
int rz_continuation_budget(int form, int* out) {
  if (form == 1) {
    return rz::budget_of(continuation_kernel<rz::Bvh2Walk, true>, kThreads,
                         out);
  }
  return rz::budget_of(continuation_kernel<rz::Bvh2Walk, false>, kThreads,
                       out);
}

}  // extern "C"
