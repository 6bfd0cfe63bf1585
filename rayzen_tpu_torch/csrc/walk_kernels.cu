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
// per-wave walks of kernels="pallas-ml".
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

int rz_closest_misslink(const float* rec, int rec_w, int leaf_k,
                        const float* orig, const float* dir,
                        const uint8_t* act, int n, float* t_out, int* tri_out,
                        float* cross_out, float* menc_out, void* stream) {
  const rz::MisslinkWalk w{{rec, rec_w, leaf_k}};
  return launch_closest(w, orig, dir, act, nullptr, n, t_out, tri_out,
                        cross_out, menc_out, stream);
}

int rz_shadow_misslink(const float* rec, int rec_w, int leaf_k,
                       const float* orig, const float* dir, const float* maxd,
                       const uint8_t* act, int n, float min_vis, float t_eps,
                       float* vis_out, void* stream) {
  const rz::MisslinkWalk w{{rec, rec_w, leaf_k}};
  return launch_shadow(w, orig, dir, maxd, act, n, min_vis, t_eps, vis_out,
                       stream);
}

}  // extern "C"
