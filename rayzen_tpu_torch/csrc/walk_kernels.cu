// K2, K3, K5, K6, K7 and K8 as standalone kernels: one thread per ray over
// flat (R,) arrays.
//
// K2 replaces rayzen_tpu/ops/pallas_traverse.py::_make_closest_kernel_bvh2
// (:428), launched by pallas_closest_hit_bvh2 (:1338); K3 replaces
// ::_make_shadow_kernel_bvh2 (:580), launched by pallas_shadow_walk_bvh2
// (:1350). K8 (::tiered_walk_closest :796, ::tiered_walk_shadow :879) has no
// launcher of its own in the JAX package, only its use inside the sample
// kernel; these launchers let it be held against its plain version and
// against K2/K3 on the whole tree. The same holds for K5
// (::bvh8_walk_closest :617, ::bvh8_walk_shadow :728). K6 replaces
// ::_make_closest_kernel_frustum (:1093) and ::_make_shadow_kernel_frustum
// (:1191), launched by pallas_closest_hit_frustum (:1361) and
// pallas_shadow_walk_frustum (:1370); its packet is a warp of 32
// consecutive rays, so every thread of a launched block stays to the end.
// K7 replaces ::_make_closest_kernel (:128) and ::_make_shadow_kernel (:189),
// launched by pallas_closest_hit (:1381) and pallas_shadow_walk (:1405): the
// per-wave walks of kernels="pallas-ml", which the per-wave loop launches on
// every slot of the wave at every bounce with an ``act`` mask. Its kernel
// (misslink_kernel) walks only the live rays: each block compacts the live
// slots of its 128 wave slots into shared memory, in order, and then walks
// them, so the dead warps of waves that are mostly dead (half the slots are
// live at bounce 1 of the demo, a few percent later) retire at once.
// The parent's one-thread-per-slot K7 over the records stays beside it
// (rz_*_misslink_rows) as the anchor the card checks hold it to.
// The walks themselves (and what bounds them on the card) are in walk.cuh
// and frustum.cuh. These kernels add only the per-ray loads and stores:
// rays are (R, 3) rows, read once, so the launch is latency-bound like the
// walk.
//
// Plain C interface for ctypes (ext.py). Each entry point launches on the
// given stream, never synchronises, and returns cudaGetLastError().
#include "frustum.cuh"

namespace {

constexpr int kBlock = 128;

// ---- K7: the live rays only ----
//
// Block size and the blocks each SM must hold at once (__launch_bounds__):
// 128 x 8, the fastest point of a measured sweep (PERF.md §6);
// scripts/k1_schedule.py rebuilds with other values (-D) to sweep them.
#ifndef RZ_K7_THREADS
#define RZ_K7_THREADS 128
#endif
#ifndef RZ_K7_MIN_BLOCKS
#define RZ_K7_MIN_BLOCKS 8
#endif
constexpr int kK7Threads = RZ_K7_THREADS;
constexpr int kK7Warps = kK7Threads / 32;
static_assert(kK7Threads % 32 == 0, "whole warps");
// the wave positions' map: K1's warp tiles, 16 x 8 block tiles of 8 x 4
// warps (common.cuh), whatever kK7Threads is
constexpr int kMapThreads = 128;

// The wave slot at position pos (-1: none): the tile map over a whole
// width x height frame, the identity on any other wave.
__device__ __forceinline__ int k7_slot(long long pos, int n, int width,
                                       int height) {
  return rz::tile_pixel<kMapThreads>(
      (int)(pos / kMapThreads), (int)(pos % kMapThreads) >> 5,
      (int)(pos & 31), n, width, height);
}

// Positions of a launch over n slots: whole block tiles.
int k7_positions(int n, int width, int height) {
  return rz::tile_blocks<kMapThreads>(n, width, height) * kMapThreads;
}

// A launch's rays and outputs: closest writes t, tri, cross and menc;
// shadow reads maxd and writes vis.
struct K7Rays {
  const float* orig;
  const float* dir;
  const float* maxd;
  const uint8_t* act;
  float* t_out;
  int* tri_out;
  float* cross_out;
  float* menc_out;
  float* vis_out;
};

// Slot i's result: a closest ray's hit record, a shadow ray's vis.
template <int kMode>
__device__ __forceinline__ void k7_store(const K7Rays& io, int i,
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

// K7 in mode kClosest or kShadow over the live rays of the wave. Block b
// takes wave positions [b, b + 1) x kK7Threads, one a thread. An inactive
// slot gets its result at once: t = T_FAR, tri = -1, cross = menc = 0
// (closest), vis = 1 (shadow). Every warp votes its live slots
// (__ballot_sync), the block adds up the warps' counts, and each live slot
// goes into the block's queue in shared memory at its prefix popcount, in
// position order. Then the first ``queued`` threads walk the queue, each ray
// writing its result at its own slot, and the other warps retire at once.
// No count leaves the device.
template <int kMode, class Count>
__global__ void __launch_bounds__(kK7Threads, RZ_K7_MIN_BLOCKS)
    misslink_kernel(rz::MisslinkTables tb, K7Rays io, int n, int width,
                    int height, float min_vis, float t_eps) {
  __shared__ int queue[kK7Threads];
  __shared__ int warp_live[kK7Warps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const rz::HitRec none{rz::T_FAR, -1, 0.0f, 0.0f, 0.0f, 0.0f};
  const int slot = k7_slot((long long)blockIdx.x * kK7Threads + threadIdx.x, n,
                           width, height);
  const bool live = slot >= 0 && io.act[slot] != 0;
  if (slot >= 0 && !live) k7_store<kMode>(io, slot, none, 1.0f);
  const unsigned m = __ballot_sync(rz::kFullMask, live);
  if (lane == 0) warp_live[warp] = __popc(m);
  __syncthreads();
  int at = 0, queued = 0;
#pragma unroll
  for (int w = 0; w < kK7Warps; ++w) {
    const int v = warp_live[w];
    at += w < warp ? v : 0;
    queued += v;
  }
  if (live) queue[at + __popc(m & ((1u << lane) - 1u))] = slot;
  __syncthreads();
  if ((int)threadIdx.x >= queued) return;
  const int i = queue[threadIdx.x];
  const rz::Ray r = rz::make_ray(io.orig[3 * i], io.orig[3 * i + 1],
                                 io.orig[3 * i + 2], io.dir[3 * i],
                                 io.dir[3 * i + 1], io.dir[3 * i + 2]);
  rz::HitRec h = none;
  if constexpr (kMode == rz::kShadow) h.t = io.maxd[i];
  float vis = 1.0f;
  rz::walk_misslink<kMode>(tb, r, min_vis, t_eps, h, vis, Count{});
  k7_store<kMode>(io, i, h, vis);
}

template <int kMode, class Count = rz::NoCount>
int launch_misslink(const float* nodes, const float* tris, int leaf_k,
                    const K7Rays& io, int n, int width, int height,
                    float min_vis, float t_eps, void* stream) {
  if (n > 0) {
    misslink_kernel<kMode, Count>
        <<<(k7_positions(n, width, height) + kK7Threads - 1) / kK7Threads,
           kK7Threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            rz::MisslinkTables{reinterpret_cast<const float4*>(nodes),
                               reinterpret_cast<const float4*>(tris), leaf_k},
            io, n, width, height, min_vis, t_eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Walk>
__global__ void closest_kernel(Walk w, const float* __restrict__ orig,
                               const float* __restrict__ dir,
                               const uint8_t* __restrict__ act,
                               const float* __restrict__ t_init, int n,
                               float* __restrict__ t_out,
                               int* __restrict__ tri_out,
                               float* __restrict__ cross_out,
                               float* __restrict__ menc_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rz::HitRec h{t_init ? t_init[i] : rz::T_FAR, -1, 0.0f, 0.0f, 0.0f, 0.0f};
  if (act[i]) {
    const rz::Ray r = rz::make_ray(orig[3 * i], orig[3 * i + 1],
                                   orig[3 * i + 2], dir[3 * i],
                                   dir[3 * i + 1], dir[3 * i + 2]);
    w.closest(r, h);
  }
  t_out[i] = h.t;
  tri_out[i] = h.tri;
  cross_out[3 * i] = h.cx;
  cross_out[3 * i + 1] = h.cy;
  cross_out[3 * i + 2] = h.cz;
  menc_out[i] = h.menc;
}

template <class Walk>
__global__ void shadow_kernel(Walk w, const float* __restrict__ orig,
                              const float* __restrict__ dir,
                              const float* __restrict__ maxd,
                              const uint8_t* __restrict__ act, int n,
                              float min_vis, float t_eps,
                              float* __restrict__ vis_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float vis = 1.0f;  // inactive rays report 1 (pallas_shadow_walk_bvh2)
  if (act[i]) {
    const rz::Ray r = rz::make_ray(orig[3 * i], orig[3 * i + 1],
                                   orig[3 * i + 2], dir[3 * i],
                                   dir[3 * i + 1], dir[3 * i + 2]);
    vis = w.shadow(r, maxd[i], min_vis, t_eps);
  }
  vis_out[i] = vis;
}

// K6: every thread of the block stays (the frustum's shuffles name the whole
// warp); threads past n are lanes without a ray
__global__ void closest_frustum_kernel(rz::Tables tb,
                                       const float* __restrict__ orig,
                                       const float* __restrict__ dir,
                                       const uint8_t* __restrict__ act, int n,
                                       float* __restrict__ t_out,
                                       int* __restrict__ tri_out,
                                       float* __restrict__ cross_out,
                                       float* __restrict__ menc_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < n && act[i] != 0;
  rz::HitRec h{rz::T_FAR, -1, 0.0f, 0.0f, 0.0f, 0.0f};
  rz::Ray r{};
  if (on) {
    r = rz::make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                     dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
  }
  rz::frustum_closest(tb, r, on, h);
  if (i >= n) return;
  t_out[i] = h.t;
  tri_out[i] = h.tri;
  cross_out[3 * i] = h.cx;
  cross_out[3 * i + 1] = h.cy;
  cross_out[3 * i + 2] = h.cz;
  menc_out[i] = h.menc;
}

__global__ void shadow_frustum_kernel(rz::Tables tb,
                                      const float* __restrict__ orig,
                                      const float* __restrict__ dir,
                                      const float* __restrict__ maxd,
                                      const uint8_t* __restrict__ act, int n,
                                      float min_vis, float t_eps,
                                      float* __restrict__ vis_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < n && act[i] != 0;
  rz::Ray r{};
  float md = 0.0f;
  if (on) {
    r = rz::make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                     dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
    md = maxd[i];
  }
  // inactive rays report 1 (pallas_shadow_walk_frustum)
  const float vis = rz::frustum_shadow(tb, r, on, md, min_vis, t_eps);
  if (i < n) vis_out[i] = vis;
}

template <class Walk>
int launch_closest(Walk w, const float* orig, const float* dir,
                   const uint8_t* act, const float* t_init, int n,
                   float* t_out, int* tri_out, float* cross_out,
                   float* menc_out, void* stream) {
  if (n > 0) {
    closest_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        w, orig, dir, act, t_init, n, t_out, tri_out, cross_out, menc_out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Walk>
int launch_shadow(Walk w, const float* orig, const float* dir,
                  const float* maxd, const uint8_t* act, int n, float min_vis,
                  float t_eps, float* vis_out, void* stream) {
  if (n > 0) {
    shadow_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        w, orig, dir, maxd, act, n, min_vis, t_eps, vis_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* rz_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int rz_stack_depth() { return rz::STACK_DEPTH; }

int rz_closest_bvh2(const float* inner, const float* leaf, int leaf_w,
                    int leaf_k, const float* orig, const float* dir,
                    const uint8_t* act, const float* t_init, int n,
                    float* t_out, int* tri_out, float* cross_out,
                    float* menc_out, void* stream) {
  const rz::Bvh2Walk w{{inner, leaf, leaf_w, leaf_k}};
  return launch_closest(w, orig, dir, act, t_init, n, t_out, tri_out,
                        cross_out, menc_out, stream);
}

int rz_shadow_bvh2(const float* inner, const float* leaf, int leaf_w,
                   int leaf_k, const float* orig, const float* dir,
                   const float* maxd, const uint8_t* act, int n,
                   float min_vis, float t_eps, float* vis_out, void* stream) {
  const rz::Bvh2Walk w{{inner, leaf, leaf_w, leaf_k}};
  return launch_shadow(w, orig, dir, maxd, act, n, min_vis, t_eps, vis_out,
                       stream);
}

int rz_closest_tiered(const float* top, const float* tre_inner,
                      const float* tre_leaf, int si, int sl, int leaf_w,
                      int leaf_k, const float* orig, const float* dir,
                      const uint8_t* act, int n, float* t_out, int* tri_out,
                      float* cross_out, float* menc_out, void* stream) {
  const rz::TieredWalk w{{top, tre_inner, tre_leaf, si, sl, leaf_w, leaf_k}};
  return launch_closest(w, orig, dir, act, nullptr, n, t_out, tri_out,
                        cross_out, menc_out, stream);
}

int rz_shadow_tiered(const float* top, const float* tre_inner,
                     const float* tre_leaf, int si, int sl, int leaf_w,
                     int leaf_k, const float* orig, const float* dir,
                     const float* maxd, const uint8_t* act, int n,
                     float min_vis, float t_eps, float* vis_out,
                     void* stream) {
  const rz::TieredWalk w{{top, tre_inner, tre_leaf, si, sl, leaf_w, leaf_k}};
  return launch_shadow(w, orig, dir, maxd, act, n, min_vis, t_eps, vis_out,
                       stream);
}

int rz_closest_bvh8(const float* inner8, const float* leaf8, int leaf_w,
                    int leaf_k, const float* orig, const float* dir,
                    const uint8_t* act, int n, float* t_out, int* tri_out,
                    float* cross_out, float* menc_out, void* stream) {
  const rz::Bvh8Walk w{{inner8, leaf8, leaf_w, leaf_k}};
  return launch_closest(w, orig, dir, act, nullptr, n, t_out, tri_out,
                        cross_out, menc_out, stream);
}

int rz_shadow_bvh8(const float* inner8, const float* leaf8, int leaf_w,
                   int leaf_k, const float* orig, const float* dir,
                   const float* maxd, const uint8_t* act, int n,
                   float min_vis, float t_eps, float* vis_out, void* stream) {
  const rz::Bvh8Walk w{{inner8, leaf8, leaf_w, leaf_k}};
  return launch_shadow(w, orig, dir, maxd, act, n, min_vis, t_eps, vis_out,
                       stream);
}

int rz_closest_frustum(const float* inner, const float* leaf, int leaf_w,
                       int leaf_k, const float* orig, const float* dir,
                       const uint8_t* act, int n, float* t_out, int* tri_out,
                       float* cross_out, float* menc_out, void* stream) {
  if (n > 0) {
    closest_frustum_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        rz::Tables{inner, leaf, leaf_w, leaf_k}, orig, dir, act, n, t_out,
        tri_out, cross_out, menc_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int rz_shadow_frustum(const float* inner, const float* leaf, int leaf_w,
                      int leaf_k, const float* orig, const float* dir,
                      const float* maxd, const uint8_t* act, int n,
                      float min_vis, float t_eps, float* vis_out,
                      void* stream) {
  if (n > 0) {
    shadow_frustum_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        rz::Tables{inner, leaf, leaf_w, leaf_k}, orig, dir, maxd, act, n,
        min_vis, t_eps, vis_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7: the live rays only, over ml_nodes / ml_tris; width x height: the
// frame a whole-frame wave covers (its rays are then taken in warp tiles)
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
#define RZ_K7_CLOSEST_IO \
  K7Rays { orig, dir, nullptr, act, t_out, tri_out, cross_out, menc_out, nullptr }
#define RZ_K7_SHADOW_IO \
  K7Rays { orig, dir, maxd, act, nullptr, nullptr, nullptr, nullptr, vis_out }

int rz_closest_misslink(RZ_K7_CLOSEST_ARGS) {
  return launch_misslink<rz::kClosest>(nodes, tris, leaf_k, RZ_K7_CLOSEST_IO,
                                       n, width, height, 0.0f, 0.0f, stream);
}

int rz_shadow_misslink(RZ_K7_SHADOW_ARGS) {
  return launch_misslink<rz::kShadow>(nodes, tris, leaf_k, RZ_K7_SHADOW_IO, n,
                                      width, height, min_vis, t_eps, stream);
}

// The counting K7 (LaneCount at every walk step; read with
// rz_misslink_lanes): a diagnostic, off the render path.
int rz_closest_misslink_count(RZ_K7_CLOSEST_ARGS) {
  return launch_misslink<rz::kClosest, rz::LaneCount>(
      nodes, tris, leaf_k, RZ_K7_CLOSEST_IO, n, width, height, 0.0f, 0.0f,
      stream);
}

int rz_shadow_misslink_count(RZ_K7_SHADOW_ARGS) {
  return launch_misslink<rz::kShadow, rz::LaneCount>(
      nodes, tris, leaf_k, RZ_K7_SHADOW_IO, n, width, height, min_vis, t_eps,
      stream);
}

// The parent's K7 (one thread per slot, in wave order, over the records) and
// its counting form: the anchor of the card checks.
#define RZ_K7_ROWS_CLOSEST_ARGS                                           \
  const float *rec, int rec_w, int leaf_k, const float *orig,             \
      const float *dir, const uint8_t *act, int n, float *t_out,          \
      int *tri_out, float *cross_out, float *menc_out, void *stream
#define RZ_K7_ROWS_SHADOW_ARGS                                            \
  const float *rec, int rec_w, int leaf_k, const float *orig,             \
      const float *dir, const float *maxd, const uint8_t *act, int n,     \
      float min_vis, float t_eps, float *vis_out, void *stream

int rz_closest_misslink_rows(RZ_K7_ROWS_CLOSEST_ARGS) {
  const rz::MisslinkRowsWalk<rz::NoCount> w{{rec, rec_w, leaf_k}};
  return launch_closest(w, orig, dir, act, nullptr, n, t_out, tri_out,
                        cross_out, menc_out, stream);
}

int rz_shadow_misslink_rows(RZ_K7_ROWS_SHADOW_ARGS) {
  const rz::MisslinkRowsWalk<rz::NoCount> w{{rec, rec_w, leaf_k}};
  return launch_shadow(w, orig, dir, maxd, act, n, min_vis, t_eps, vis_out,
                       stream);
}

int rz_closest_misslink_rows_count(RZ_K7_ROWS_CLOSEST_ARGS) {
  const rz::MisslinkRowsWalk<rz::LaneCount> w{{rec, rec_w, leaf_k}};
  return launch_closest(w, orig, dir, act, nullptr, n, t_out, tri_out,
                        cross_out, menc_out, stream);
}

int rz_shadow_misslink_rows_count(RZ_K7_ROWS_SHADOW_ARGS) {
  const rz::MisslinkRowsWalk<rz::LaneCount> w{{rec, rec_w, leaf_k}};
  return launch_shadow(w, orig, dir, maxd, act, n, min_vis, t_eps, vis_out,
                       stream);
}

// The counting K7 forms' sums (rz::read_walk_lanes).
int rz_misslink_lanes(unsigned long long* out, int reset) {
  return rz::read_walk_lanes(out, reset);
}

// The compiled budget (rz::budget_of) of a K7 form: 0 closest, 1 shadow
// (misslink_kernel), 2 closest, 3 shadow (the parent's, over the records).
int rz_misslink_budget(int form, int* out) {
  using Rows = rz::MisslinkRowsWalk<rz::NoCount>;
  switch (form) {
    case 1:
      return rz::budget_of(misslink_kernel<rz::kShadow, rz::NoCount>,
                           kK7Threads, out);
    case 2: return rz::budget_of(closest_kernel<Rows>, kBlock, out);
    case 3: return rz::budget_of(shadow_kernel<Rows>, kBlock, out);
    default:
      return rz::budget_of(misslink_kernel<rz::kClosest, rz::NoCount>,
                           kK7Threads, out);
  }
}

}  // extern "C"
