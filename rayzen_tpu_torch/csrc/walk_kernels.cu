// K2, K3, K5, K6, K7 and K8 as standalone kernels over flat (R,) arrays.
//
// K2 replaces rayzen_tpu/ops/pallas_traverse.py::_make_closest_kernel_bvh2
// (:428), launched by pallas_closest_hit_bvh2 (:1338); K3 replaces
// ::_make_shadow_kernel_bvh2 (:580), launched by pallas_shadow_walk_bvh2
// (:1350): the per-wave walks of kernels="pallas-bvh2" and of the bounces
// of "pallas-nomega". K7 replaces ::_make_closest_kernel (:128) and
// ::_make_shadow_kernel (:189), launched by pallas_closest_hit (:1381) and
// pallas_shadow_walk (:1405): the per-wave walks of kernels="pallas-ml".
// The per-wave loop launches them on every slot of the wave at every bounce
// with an ``act`` mask. K8 (::tiered_walk_closest :796, ::tiered_walk_shadow
// :879) and K5 (::bvh8_walk_closest :617, ::bvh8_walk_shadow :728) have no
// launcher of their own in the JAX package, only their use inside the sample
// kernel; these launchers let them be held against their plain versions and
// against K2/K3 on the whole tree. All of these run one kernel,
// live_walk_kernel, a template over the walk policy (walk.cuh: Bvh2Walk,
// TieredWalk, Bvh8Walk, MisslinkWalk) and the mode: it walks only the live
// rays of its wave, each in the thread of its own slot (a dead slot's
// thread stores its result and retires at once); a whole-frame wave's rays
// are taken in K1's 8 x 4 warp tiles; and __launch_bounds__ holds it to 64
// registers for 32 resident warps per SM.
// K6 replaces ::_make_closest_kernel_frustum (:1093) and
// ::_make_shadow_kernel_frustum (:1191), launched by
// pallas_closest_hit_frustum (:1361) and pallas_shadow_walk_frustum (:1370):
// the primary walk of kernels="pallas-nomega". Its kernel,
// frustum_walk_kernel, takes the same map and budget, but its packet is a
// warp: every lane of a warp with a live slot stays to the end.
// The walks themselves (and what bounds them on the card) are in walk.cuh
// and frustum.cuh. These kernels add only the per-ray loads and stores:
// rays are (R, 3) rows, read once, so the launch is latency-bound like the
// walk.
//
// Plain C interface for ctypes (ext.py). Each entry point launches on the
// given stream, never synchronises, and returns cudaGetLastError().
#include "frustum.cuh"

namespace {

// ---- the live rays only: K2, K3, K5, K7, K8 ----
//
// Block size and the blocks each SM must hold at once (__launch_bounds__):
// 128 x 8, the fastest point of K7's measured sweep (PERF.md §6);
// scripts/k1_schedule.py rebuilds with other values (-D) to sweep them.
#ifndef RZ_LIVE_THREADS
#define RZ_LIVE_THREADS 128
#endif
#ifndef RZ_LIVE_MIN_BLOCKS
#define RZ_LIVE_MIN_BLOCKS 8
#endif
// The live slots are walked in place: compacting a block's live slots into
// its first warps through shared memory, in the blocks at most half or
// three quarters live, tied the in-place walk on every wave of a 1080p
// per-wave sample, K7's and K2/K3's, down to bounce 4's 0.21% live, and
// compacting every block lost 4% on the half-live shadow wave (PERF.md
// §6): a sparse wave is bound by its longest walk, not by the warps its
// dead slots hold.
constexpr int kLiveThreads = RZ_LIVE_THREADS;
static_assert(kLiveThreads % 32 == 0, "whole warps");
// the wave positions' map: K1's warp tiles, 16 x 8 block tiles of 8 x 4
// warps (common.cuh), whatever kLiveThreads is
constexpr int kMapThreads = 128;

// The wave slot at position pos (-1: none): the tile map over a whole
// width x height frame, the identity on any other wave.
__device__ __forceinline__ int wave_slot(long long pos, int n, int width,
                                         int height) {
  return rz::tile_pixel<kMapThreads>(
      (int)(pos / kMapThreads), (int)(pos % kMapThreads) >> 5,
      (int)(pos & 31), n, width, height);
}

// Positions of a launch over n slots: whole block tiles.
int wave_positions(int n, int width, int height) {
  return rz::tile_blocks<kMapThreads>(n, width, height) * kMapThreads;
}

// A launch's rays and outputs: closest reads t_init (K2 only; null: T_FAR)
// and writes t, tri, cross and menc; shadow reads maxd and writes vis.
struct WaveIO {
  const float* orig;
  const float* dir;
  const float* maxd;
  const float* t_init;
  const uint8_t* act;
  float* t_out;
  int* tri_out;
  float* cross_out;
  float* menc_out;
  float* vis_out;
};

// Slot i's result: a closest ray's hit record, a shadow ray's vis.
template <int kMode>
__device__ __forceinline__ void store_result(const WaveIO& io, int i,
                                             const rz::HitRec& h, float vis) {
  if constexpr (kMode == rz::kClosest) {
    io.t_out[i] = h.t;
    io.tri_out[i] = h.tri;
    io.cross_out[3 * i] = h.cx;
    io.cross_out[3 * i + 1] = h.cy;
    io.cross_out[3 * i + 2] = h.cz;
    io.menc_out[i] = h.menc;
  } else {
    io.vis_out[i] = vis;
  }
}

// Slot i's state before its walk: a closest ray's no-hit record from
// t_init or T_FAR, a shadow ray's bound maxd.
template <int kMode>
__device__ __forceinline__ rz::HitRec start_hit(const WaveIO& io, int i) {
  rz::HitRec h{rz::T_FAR, -1, 0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (kMode == rz::kShadow) {
    h.t = io.maxd[i];
  } else {
    if (io.t_init) h.t = io.t_init[i];
  }
  return h;
}

// The walk of Walk in mode kClosest or kShadow over the live rays of the
// wave. Block b takes wave positions [b, b + 1) x kLiveThreads, one a
// thread. An inactive slot gets its result at once: t = t_init or T_FAR,
// tri = -1, cross = menc = 0 (closest), vis = 1 (shadow), as the JAX
// launchers give inactive rays, and its thread retires; a live slot's
// thread walks its ray. Each ray's walk is its own, so which thread walks
// it changes no result.
template <int kMode, class Walk, class Count>
__global__ void __launch_bounds__(kLiveThreads, RZ_LIVE_MIN_BLOCKS)
    live_walk_kernel(Walk w, WaveIO io, int n, int width, int height,
                     float min_vis, float t_eps) {
  const int i = wave_slot((long long)blockIdx.x * kLiveThreads + threadIdx.x,
                          n, width, height);
  if (i < 0) return;
  if (io.act[i] == 0) {
    store_result<kMode>(io, i, start_hit<rz::kClosest>(io, i), 1.0f);
    return;
  }
  const rz::Ray r = rz::make_ray(io.orig[3 * i], io.orig[3 * i + 1],
                                 io.orig[3 * i + 2], io.dir[3 * i],
                                 io.dir[3 * i + 1], io.dir[3 * i + 2]);
  rz::HitRec h = start_hit<kMode>(io, i);
  float vis = 1.0f;
  w.template walk<kMode>(r, min_vis, t_eps, h, vis, Count{});
  store_result<kMode>(io, i, h, vis);
}

template <int kMode, class Count = rz::NoCount, class Walk>
int launch_live(Walk w, const WaveIO& io, int n, int width, int height,
                float min_vis, float t_eps, void* stream) {
  if (n > 0) {
    live_walk_kernel<kMode, Walk, Count>
        <<<(wave_positions(n, width, height) + kLiveThreads - 1) / kLiveThreads,
           kLiveThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            w, io, n, width, height, min_vis, t_eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Count = rz::NoCount, class Walk>
int launch_closest(Walk w, const float* orig, const float* dir,
                   const uint8_t* act, const float* t_init, int n, int width,
                   int height, float* t_out, int* tri_out, float* cross_out,
                   float* menc_out, void* stream) {
  const WaveIO io{orig,  dir,     nullptr,   t_init,   act,
                  t_out, tri_out, cross_out, menc_out, nullptr};
  return launch_live<rz::kClosest, Count>(w, io, n, width, height, 0.0f, 0.0f,
                                          stream);
}

template <class Count = rz::NoCount, class Walk>
int launch_shadow(Walk w, const float* orig, const float* dir,
                  const float* maxd, const uint8_t* act, int n, int width,
                  int height, float min_vis, float t_eps, float* vis_out,
                  void* stream) {
  const WaveIO io{orig,    dir,     maxd,    nullptr, act,
                  nullptr, nullptr, nullptr, nullptr, vis_out};
  return launch_live<rz::kShadow, Count>(w, io, n, width, height, min_vis,
                                         t_eps, stream);
}

// ---- K6: the packet walks over the wave's warp tiles ----
//
// The packet is a warp of the same map as the live-ray walks' (wave_slot:
// K1's 8 x 4 warp tiles on a whole-frame wave, 32 consecutive slots on any
// other), so a frame's packet is the compact tile whose frustum K1's K6
// forms walk, not a 32 x 1 strip of a row. Its stack is one copy per warp
// in shared memory (frustum.cuh SharedStack). Every lane of a warp with a
// live slot stays to the end (the frustum's shuffles name the whole warp);
// a warp with none stores its slots' results (as an inactive slot's below)
// and retires at once. The same budget as the live-ray walks: 128 x 8.
// Measured against 32 x 1 strips with a per-lane stack and no budget
// (PERF.md §6): 5-6% faster at the demo's 1080p waves, where every lane of
// a packet takes every step; 70 registers (RZ_LIVE_MIN_BLOCKS 6) tied.
template <int kMode, class Count>
__global__ void __launch_bounds__(kLiveThreads, RZ_LIVE_MIN_BLOCKS)
    frustum_walk_kernel(rz::Tables tb, WaveIO io, int n, int width,
                        int height, float min_vis, float t_eps) {
  __shared__ int stacks[(kLiveThreads / 32) * rz::STACK_DEPTH];
  const int i = wave_slot((long long)blockIdx.x * kLiveThreads + threadIdx.x,
                          n, width, height);
  const bool on = i >= 0 && io.act[i] != 0;
  // an inactive slot's result (the packet walks give a lane without a ray
  // none of its own): t = T_FAR, tri = -1 (closest); vis = 1 (shadow)
  const rz::HitRec none{rz::T_FAR, -1, 0.0f, 0.0f, 0.0f, 0.0f};
  if (__ballot_sync(rz::kFullMask, on) == 0u) {
    if (i >= 0) store_result<kMode>(io, i, none, 1.0f);
    return;
  }
  rz::SharedStack stack{stacks + (threadIdx.x >> 5) * rz::STACK_DEPTH};
  rz::Ray r{};
  float maxd = 0.0f;
  if (on) {
    r = rz::make_ray(io.orig[3 * i], io.orig[3 * i + 1], io.orig[3 * i + 2],
                     io.dir[3 * i], io.dir[3 * i + 1], io.dir[3 * i + 2]);
    if constexpr (kMode == rz::kShadow) maxd = io.maxd[i];
  }
  rz::HitRec h = none;
  float vis = 1.0f;
  if constexpr (kMode == rz::kClosest) {
    rz::frustum_walk_closest(tb, r, on, h, stack, Count{});
  } else {
    vis = rz::frustum_walk_shadow(tb, r, on, maxd, min_vis, t_eps, stack,
                                  Count{});
  }
  if (i >= 0) store_result<kMode>(io, i, on ? h : none, on ? vis : 1.0f);
}

template <int kMode, class Count>
int launch_frustum(const rz::Tables& tb, const WaveIO& io, int n, int width,
                   int height, float min_vis, float t_eps, void* stream) {
  if (n > 0) {
    frustum_walk_kernel<kMode, Count>
        <<<(wave_positions(n, width, height) + kLiveThreads - 1) / kLiveThreads,
           kLiveThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            tb, io, n, width, height, min_vis, t_eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Count = rz::NoCount>
int launch_frustum_closest(const rz::Tables& tb, const float* orig,
                           const float* dir, const uint8_t* act, int n,
                           int width, int height, float* t_out, int* tri_out,
                           float* cross_out, float* menc_out, void* stream) {
  const WaveIO io{orig,  dir,     nullptr,   nullptr,  act,
                  t_out, tri_out, cross_out, menc_out, nullptr};
  return launch_frustum<rz::kClosest, Count>(tb, io, n, width, height, 0.0f,
                                             0.0f, stream);
}

template <class Count = rz::NoCount>
int launch_frustum_shadow(const rz::Tables& tb, const float* orig,
                          const float* dir, const float* maxd,
                          const uint8_t* act, int n, int width, int height,
                          float min_vis, float t_eps, float* vis_out,
                          void* stream) {
  const WaveIO io{orig,    dir,     maxd,    nullptr, act,
                  nullptr, nullptr, nullptr, nullptr, vis_out};
  return launch_frustum<rz::kShadow, Count>(tb, io, n, width, height, min_vis,
                                            t_eps, stream);
}

}  // namespace

extern "C" {

const char* rz_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int rz_stack_depth() { return rz::STACK_DEPTH; }

// K2 / K3 over the whole tree; width x height: the frame a whole-frame wave
// covers (its rays are then taken in warp tiles), 0 x 0 for any other wave
#define RZ_BVH2_CLOSEST_ARGS                                                \
  const float *inner, const float *leaf, int leaf_w, int leaf_k,            \
      const float *orig, const float *dir, const uint8_t *act,              \
      const float *t_init, int n, int width, int height, float *t_out,      \
      int *tri_out, float *cross_out, float *menc_out, void *stream
#define RZ_BVH2_SHADOW_ARGS                                                 \
  const float *inner, const float *leaf, int leaf_w, int leaf_k,            \
      const float *orig, const float *dir, const float *maxd,               \
      const uint8_t *act, int n, int width, int height, float min_vis,      \
      float t_eps, float *vis_out, void *stream
#define RZ_BVH2_POLICY rz::Bvh2Walk{{inner, leaf, leaf_w, leaf_k}}

int rz_closest_bvh2(RZ_BVH2_CLOSEST_ARGS) {
  return launch_closest(RZ_BVH2_POLICY, orig, dir, act, t_init, n, width,
                        height, t_out, tri_out, cross_out, menc_out, stream);
}

int rz_shadow_bvh2(RZ_BVH2_SHADOW_ARGS) {
  return launch_shadow(RZ_BVH2_POLICY, orig, dir, maxd, act, n, width, height,
                       min_vis, t_eps, vis_out, stream);
}

// The counting K2 / K3 (LaneCount at every walk step; read with
// rz_live_walk_lanes): a diagnostic, off the render path.
int rz_closest_bvh2_count(RZ_BVH2_CLOSEST_ARGS) {
  return launch_closest<rz::LaneCount>(RZ_BVH2_POLICY, orig, dir, act, t_init,
                                       n, width, height, t_out, tri_out,
                                       cross_out, menc_out, stream);
}

int rz_shadow_bvh2_count(RZ_BVH2_SHADOW_ARGS) {
  return launch_shadow<rz::LaneCount>(RZ_BVH2_POLICY, orig, dir, maxd, act, n,
                                      width, height, min_vis, t_eps, vis_out,
                                      stream);
}

// K8 and K5 (the harness launchers): linear waves
#define RZ_K8_CLOSEST_ARGS                                                  \
  const float *top, const float *tre_inner, const float *tre_leaf, int si, \
      int sl, int leaf_w, int leaf_k, const float *orig, const float *dir, \
      const uint8_t *act, int n, float *t_out, int *tri_out,               \
      float *cross_out, float *menc_out, void *stream
#define RZ_K8_SHADOW_ARGS                                                   \
  const float *top, const float *tre_inner, const float *tre_leaf, int si, \
      int sl, int leaf_w, int leaf_k, const float *orig, const float *dir, \
      const float *maxd, const uint8_t *act, int n, float min_vis,         \
      float t_eps, float *vis_out, void *stream
#define RZ_K8_POLICY \
  rz::TieredWalk { { top, tre_inner, tre_leaf, si, sl, leaf_w, leaf_k } }

int rz_closest_tiered(RZ_K8_CLOSEST_ARGS) {
  return launch_closest(RZ_K8_POLICY, orig, dir, act, nullptr, n, 0, 0, t_out,
                        tri_out, cross_out, menc_out, stream);
}

int rz_shadow_tiered(RZ_K8_SHADOW_ARGS) {
  return launch_shadow(RZ_K8_POLICY, orig, dir, maxd, act, n, 0, 0, min_vis,
                       t_eps, vis_out, stream);
}

// The counting K8 (as the counting K2 / K3).
int rz_closest_tiered_count(RZ_K8_CLOSEST_ARGS) {
  return launch_closest<rz::LaneCount>(RZ_K8_POLICY, orig, dir, act, nullptr,
                                       n, 0, 0, t_out, tri_out, cross_out,
                                       menc_out, stream);
}

int rz_shadow_tiered_count(RZ_K8_SHADOW_ARGS) {
  return launch_shadow<rz::LaneCount>(RZ_K8_POLICY, orig, dir, maxd, act, n, 0,
                                      0, min_vis, t_eps, vis_out, stream);
}

int rz_closest_bvh8(const float* inner8, const float* leaf8, int leaf_w,
                    int leaf_k, const float* orig, const float* dir,
                    const uint8_t* act, int n, float* t_out, int* tri_out,
                    float* cross_out, float* menc_out, void* stream) {
  const rz::Bvh8Walk w{{inner8, leaf8, leaf_w, leaf_k}};
  return launch_closest(w, orig, dir, act, nullptr, n, 0, 0, t_out, tri_out,
                        cross_out, menc_out, stream);
}

int rz_shadow_bvh8(const float* inner8, const float* leaf8, int leaf_w,
                   int leaf_k, const float* orig, const float* dir,
                   const float* maxd, const uint8_t* act, int n,
                   float min_vis, float t_eps, float* vis_out, void* stream) {
  const rz::Bvh8Walk w{{inner8, leaf8, leaf_w, leaf_k}};
  return launch_shadow(w, orig, dir, maxd, act, n, 0, 0, min_vis, t_eps,
                       vis_out, stream);
}

// K6 over the BVH2 tables; width x height as K2's (K2's arguments without
// t_init, K3's)
#define RZ_K6_CLOSEST_ARGS                                                  \
  const float *inner, const float *leaf, int leaf_w, int leaf_k,            \
      const float *orig, const float *dir, const uint8_t *act, int n,       \
      int width, int height, float *t_out, int *tri_out, float *cross_out,  \
      float *menc_out, void *stream
#define RZ_K6_TABLES rz::Tables{inner, leaf, leaf_w, leaf_k}

int rz_closest_frustum(RZ_K6_CLOSEST_ARGS) {
  return launch_frustum_closest(RZ_K6_TABLES, orig, dir, act, n, width, height,
                                t_out, tri_out, cross_out, menc_out, stream);
}

int rz_shadow_frustum(RZ_BVH2_SHADOW_ARGS) {
  return launch_frustum_shadow(RZ_K6_TABLES, orig, dir, maxd, act, n, width,
                               height, min_vis, t_eps, vis_out, stream);
}

// The counting K6 (LaneCount at every packet step, which every lane of the
// warp takes; read with rz_live_walk_lanes): a diagnostic.
int rz_closest_frustum_count(RZ_K6_CLOSEST_ARGS) {
  return launch_frustum_closest<rz::LaneCount>(
      RZ_K6_TABLES, orig, dir, act, n, width, height, t_out, tri_out,
      cross_out, menc_out, stream);
}

int rz_shadow_frustum_count(RZ_BVH2_SHADOW_ARGS) {
  return launch_frustum_shadow<rz::LaneCount>(RZ_K6_TABLES, orig, dir, maxd,
                                              act, n, width, height, min_vis,
                                              t_eps, vis_out, stream);
}

// K7: over ml_nodes / ml_tris; width x height as K2's
#define RZ_K7_CLOSEST_ARGS                                                 \
  const float *nodes, const float *tris, int leaf_k, const float *orig,    \
      const float *dir, const uint8_t *act, int n, int width, int height,  \
      float *t_out, int *tri_out, float *cross_out, float *menc_out,       \
      void *stream
#define RZ_K7_SHADOW_ARGS                                                  \
  const float *nodes, const float *tris, int leaf_k, const float *orig,    \
      const float *dir, const float *maxd, const uint8_t *act, int n,      \
      int width, int height, float min_vis, float t_eps, float *vis_out,   \
      void *stream
#define RZ_K7_POLICY                                                 \
  rz::MisslinkWalk {                                                 \
    rz::MisslinkTables {                                             \
      reinterpret_cast<const float4*>(nodes),                        \
          reinterpret_cast<const float4*>(tris), leaf_k              \
    }                                                                \
  }

int rz_closest_misslink(RZ_K7_CLOSEST_ARGS) {
  return launch_closest(RZ_K7_POLICY, orig, dir, act, nullptr, n, width,
                        height, t_out, tri_out, cross_out, menc_out, stream);
}

int rz_shadow_misslink(RZ_K7_SHADOW_ARGS) {
  return launch_shadow(RZ_K7_POLICY, orig, dir, maxd, act, n, width, height,
                       min_vis, t_eps, vis_out, stream);
}

// The counting K7 (as the counting K2 / K3).
int rz_closest_misslink_count(RZ_K7_CLOSEST_ARGS) {
  return launch_closest<rz::LaneCount>(RZ_K7_POLICY, orig, dir, act, nullptr,
                                       n, width, height, t_out, tri_out,
                                       cross_out, menc_out, stream);
}

int rz_shadow_misslink_count(RZ_K7_SHADOW_ARGS) {
  return launch_shadow<rz::LaneCount>(RZ_K7_POLICY, orig, dir, maxd, act, n,
                                      width, height, min_vis, t_eps, vis_out,
                                      stream);
}

// The counting forms' sums (rz::read_walk_lanes).
int rz_live_walk_lanes(unsigned long long* out, int reset) {
  return rz::read_walk_lanes(out, reset);
}

// The compiled budget (rz::budget_of) of a live-ray walk: 0 K7 closest, 1 K7
// shadow, 2 K2, 3 K3, 4 K8 closest, 5 K8 shadow, 6 K6 closest, 7 K6 shadow.
int rz_live_walk_budget(int form, int* out) {
  using rz::kClosest;
  using rz::kShadow;
  using rz::NoCount;
  switch (form) {
    case 1:
      return rz::budget_of(live_walk_kernel<kShadow, rz::MisslinkWalk, NoCount>,
                           kLiveThreads, out);
    case 2:
      return rz::budget_of(live_walk_kernel<kClosest, rz::Bvh2Walk, NoCount>,
                           kLiveThreads, out);
    case 3:
      return rz::budget_of(live_walk_kernel<kShadow, rz::Bvh2Walk, NoCount>,
                           kLiveThreads, out);
    case 4:
      return rz::budget_of(live_walk_kernel<kClosest, rz::TieredWalk, NoCount>,
                           kLiveThreads, out);
    case 5:
      return rz::budget_of(live_walk_kernel<kShadow, rz::TieredWalk, NoCount>,
                           kLiveThreads, out);
    case 6:
      return rz::budget_of(frustum_walk_kernel<kClosest, NoCount>, kLiveThreads,
                           out);
    case 7:
      return rz::budget_of(frustum_walk_kernel<kShadow, NoCount>, kLiveThreads,
                           out);
    default:
      return rz::budget_of(
          live_walk_kernel<kClosest, rz::MisslinkWalk, NoCount>, kLiveThreads,
          out);
  }
}

}  // extern "C"
