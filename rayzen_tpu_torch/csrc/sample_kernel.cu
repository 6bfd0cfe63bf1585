// K1: full path-tracing samples, one thread per pixel, all of the pixel's
// samples inside the thread and all state in registers.
//
// Replaces rayzen_tpu/ops/megakernel.py::_make_sample_kernel (:460), launched
// by sample_wave (:1044): per sample, raygen with the 2e-5 sin-hash jitter
// (_raygen_tiles :341), the primary closest hit, sky on miss, GGX direct
// lighting with transmission shadow rays (_direct_lighting_tiles :362),
// scatter (_scatter_tiles :146) and bounces 1..max_bounces-1 with Russian
// roulette (_make_bounce_body :251); the sin-hash and lowbias32 RNG flows are
// evaluated inline (:69-110, :605-637). Every expression keeps the operation
// order of the JAX code and of the plain version in ops/megakernel.py.
//
// The walk is a template policy (walk.cuh): rz::Bvh2Walk over the whole tree
// (K2/K3), rz::TieredWalk over the treelet view (K8) — the kernel's
// ``tiered=True`` instantiation (megakernel.py:531-552), which the JAX
// package runs for scenes past the single-tree budget — or rz::Bvh8Walk
// over the wide tables (K5, cfg.wide_nodes, megakernel.py:503-510). kOctant
// runs the bounce walks (b >= 1) as K9 (cfg.octant_bounce_walks,
// megakernel.py:694-698; shade.cuh). kFrustum runs the primary closest hit
// as K6, the warp-packet frustum walk (cfg.frustum_primary,
// megakernel.py:519-525, over the BVH2 tables only), with the shadows and
// bounces on K2/K3. All instantiations share every line of shading, RNG and
// bounce code (shade.cuh).
//
// Phase 1 of the split-bounce wavefront (K4, megakernel.py:976-992) is K1
// with one sample, b_stop = split_bounce and a state output: it also writes
// the 13 continuation rows (stop_bounce / emit_state, :486-490, :706-711)
// that continuation_kernel.cu resumes from.
//
// What bounds it on an H100: the BVH walks (walk.cuh), dependent loads from
// L2-resident tables (~0.5 MB for the demo scene; 37 MB of treelet tables
// for the 503k-triangle field, most of the 50 MB L2). A walk step waits on
// its load, and a warp steps only as far as its longest walk, so the time
// goes to load latency that too few warps hide and to lanes that idle in
// the step loop; bandwidth and flops are far from their bounds (PERF.md).
// Shading is a few hundred flops per bounce, and the only other global
// traffic is the (R, 2) uv read and the (R, 3) + (R,) result write.
//
// Two schedules, fixed at compile time by what an instantiation's walks
// need:
// - regen_kernel, for K1 over the whole tree, the tiered view and the wide
//   tables (rz_sample_wave, _tiered, _wide). (1) Warp tiles: a warp covers
//   8 x 4 pixels and a block 16 x 8, so its primary and shadow rays share
//   more nodes per step than a row of 32. (2) In-thread regeneration: each
//   iteration traces one ray per lane (the primary ray, shadow ray li of the
//   primary hit, or the next bounce) at one call site, through one node
//   loop for closest and shadow rays (walk.cuh kEither), and a lane whose
//   path ends starts its own next sample at once instead of idling through
//   the warp's bounce tail. (3) A register budget: __launch_bounds__ holds
//   it to 64 registers (some spills, to L1-cached local memory) for 32
//   resident warps per SM, where the lockstep K1's 128-157 registers left
//   12-16 to hide the walks' load latency. (4) Over the tiered view the
//   warps are persistent: each takes warp tiles from a counter until none
//   is left. K4's plain phase 1 (rz_sample_wave_phase1) runs the same loop
//   for one sample with a state output (regen_phase1_kernel).
// - sample_kernel, the lockstep loop: a thread runs its samples in turn,
//   each through the primary walk, the shadow walks of direct_lighting and
//   trace_bounces, at separate call sites. K9's votes (kOctant) and K6's
//   packet walk (kFrustum) need the whole warp at each of those calls, so
//   K1's K9 and K6 forms (rz_sample_wave_octant, _tiered_octant,
//   _wide_octant, _frustum, _frustum_octant) and phase 1's (_phase1_octant,
//   _frustum, _frustum_octant, the same instantiations with a state output)
//   run it, with regen_kernel's warp tiles and register budget and,
//   for K6, one packet stack per warp in shared memory. A warp-synchronous
//   form of regen_kernel for K9 and K6 (every lane in the loop until its
//   warp is done, one call site that votes) measured slower or no faster on
//   every form: the octant groups serialise the bounce walks that
//   regeneration overlaps, and the packet waits each sample for the warp's
//   longest path, which the lockstep loop does anyway (PERF.md §6).
// The K9 and K6 forms replace rayzen_tpu/ops/megakernel.py:215
// (_octant_masked_walk, used by _make_bounce_body :251-257, :697) and
// :515-525, :576-585 (the frustum primary, pallas_traverse.py:1002). What
// bounds them is what bounds K1, dependent loads of L2-resident tables and
// lanes idle in a warp's walk, against a work bound of ~4.2 ms (K9) and
// ~3.6 ms (K6) per 1080p/64 spp demo frame (PERF.md §6: max(fp32 ops / 67
// TFLOP/s, bytes / 3.35 TB/s), operations). The warp tiles make a warp's
// rays, and so K6's packet, coherent; the budget holds 32 warps resident
// to hide the load latency; the shared stack frees K6's 256 B per lane.
#include <algorithm>
#include <type_traits>

#include "frustum.cuh"
#include "shade.cuh"

namespace {

using rz::Path;
using rz::SampleParams;

// Block size, and the blocks each SM must hold at once (__launch_bounds__;
// registers per thread <= 65536 / (threads x blocks)): 128 x 8, 64
// registers and 32 resident warps, the fastest point of the measured
// register sweep for the whole tree and the tiered view alike (PERF.md §5).
// scripts/k1_schedule.py rebuilds with other values (-D) to sweep them.
#ifndef RZ_K1_THREADS
#define RZ_K1_THREADS 128
#endif
#ifndef RZ_K1_MIN_BLOCKS
#define RZ_K1_MIN_BLOCKS 8
#endif
constexpr int kThreads = RZ_K1_THREADS;
static_assert(kThreads % 64 == 0, "a block is whole 16-pixel rows of warps");
constexpr int kWarps = kThreads / 32;

// K1's warp map over a launch (common.cuh): block tiles of kThreads
__host__ __device__ inline int tile_blocks(int n, int width, int height) {
  return rz::tile_blocks<kThreads>(n, width, height);
}
__device__ __forceinline__ int tile_pixel(int tile, int warp, int lane, int n,
                                          int width, int height) {
  return rz::tile_pixel<kThreads>(tile, warp, lane, n, width, height);
}

using rz::Counted;
using rz::LaneCount;

// The lockstep loop with K1's warp tiles and register budget (tile_pixel,
// __launch_bounds__(kThreads, RZ_K1_MIN_BLOCKS)) and K6's packet stack in
// shared memory.
// Count: LaneCount in the counting forms (Walk is then Counted<...>), which
// also counts K6's packet steps.
template <class Walk, bool kOctant, bool kFrustum, class Count = rz::NoCount>
__global__ void __launch_bounds__(kThreads, RZ_K1_MIN_BLOCKS)
    sample_kernel(Walk w, const float* __restrict__ mats,
                  const float* __restrict__ lights,
                  const float* __restrict__ cam, const float* __restrict__ uv,
                  const uint8_t* __restrict__ act, int n, SampleParams p,
                  float* __restrict__ color_out, int* __restrict__ rays_out,
                  float* __restrict__ state_out) {
  const int i = tile_pixel(blockIdx.x, threadIdx.x >> 5, threadIdx.x & 31, n,
                           p.width, p.height);  // -1: no pixel
  // K9's votes and K6's shuffles name the whole warp: with kOctant or
  // kFrustum every lane stays to the end
  constexpr bool kWarp = kOctant || kFrustum;
  if (!kWarp && i < 0) return;
  // the K6 forms' packet stacks, one per warp
  __shared__ int stacks[kFrustum ? kWarps * rz::STACK_DEPTH : 1];
  rz::SharedStack stack{stacks +
                        (kFrustum ? (threadIdx.x >> 5) * rz::STACK_DEPTH : 0)};
  const bool on = i >= 0 && act[i] != 0;
  float acc[3] = {0.0f, 0.0f, 0.0f};  // the current sub-block's sum
  int rays = 0;
  if (i >= 0) {  // the sub-block sums add up here
#pragma unroll
    for (int c = 0; c < 3; ++c) color_out[3 * i + c] = 0.0f;
  }
  Path path{};
  rz::Sampler smp{};
  if (on || kWarp) {
    const float u = on ? uv[2 * i] : 0.0f, v = on ? uv[2 * i + 1] : 0.0f;
    const float W = (float)p.width, H = (float)p.height;
    float P[8], V[12];
#pragma unroll
    for (int k = 0; k < 8; ++k) P[k] = __ldg(cam + k);  // inv_proj rows 0-1
#pragma unroll
    for (int k = 0; k < 12; ++k) V[k] = __ldg(cam + 16 + k);  // inv_view 0-2
    const float cpx = __ldg(cam + 32), cpy = __ldg(cam + 33),
                cpz = __ldg(cam + 34);

    smp.hash = p.rng_hash != 0;
    smp.h_pix = rz::pixel_key(p, u, v);

    // sample fusion (cfg.sample_fuse, megakernel.py:592-607, :723-730):
    // sub-block sb sums the samples g * fuse + sb in order of g, from zero,
    // and the sub-blocks add up in order, ((A0 + A1) + A2) + ..., in
    // color_out, so that no sum but the current one takes registers; with
    // fuse 1 this is the plain sum over samples
    const int groups = p.n_samples / p.fuse;
    for (int s = 0; s < p.n_samples; ++s) {
      const int sb = s / groups, g = s - sb * groups;
      path = Path{};
      bool hit0 = false;
      float dx = 0.0f, dy = 0.0f, dz = 0.0f;
      if (on) {
        rz::camera_dir(P, V, u, v, W, H, p.samp0 + (float)(g * p.fuse + sb),
                       smp, dx, dy, dz);
      }

      // ---- bounce 0: primary hit, the only bounce with direct lighting
      rz::HitRec h{rz::T_FAR, -1, 0.0f, 0.0f, 0.0f, 0.0f};
      const rz::Ray pr = rz::make_ray(cpx, cpy, cpz, dx, dy, dz);
      if constexpr (kFrustum) {  // every lane of the warp
        rz::frustum_walk_closest(w.tb, pr, on, h, stack, Count{});
      } else if (on) {
        w.closest(pr, h);
      }
      if (on) {
        rays += 1;
        if (h.menc == 0.0f) {  // sky (glsl:706-709)
          const float sky_t = 0.5f * (dy + 1.0f);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            acc[c] = acc[c] + (p.sky_h[c] + p.sky_d[c] * sky_t);
          }
        } else {
          hit0 = true;
          float nx, ny, nz;
          rz::hit_normal(h, nx, ny, nz);
          const rz::Material m = rz::load_material(mats, p.n_mats, h.menc);
          const float px = cpx + dx * h.t, py = cpy + dy * h.t,
                      pz = cpz + dz * h.t;
          float vx = cpx - px, vy = cpy - py, vz = cpz - pz;
          rz::normalize3(vx, vy, vz, 1e-20f);
          float direct[3];
          rz::direct_lighting(w, lights, p, px, py, pz, nx, ny, nz, vx, vy,
                              vz, m, direct);
          rays += p.n_lights;
#pragma unroll
          for (int c = 0; c < 3; ++c) path.c[c] = 0.0f + direct[c];

          rz::start_path(smp, px, py, pz, dx, dy, dz, nx, ny, nz, m, path);
        }
      }

      // ---- bounces 1..b_stop-1 ----
      rz::trace_bounces<kOctant>(w, mats, p, smp, 1, p.b_stop, path);
      rays += path.rays;
      if (hit0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = acc[c] + path.c[c];
      }
      if (g == groups - 1) {  // the sub-block ends: fold its sum in
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (i >= 0) color_out[3 * i + c] = color_out[3 * i + c] + acc[c];
          acc[c] = 0.0f;
        }
      }
    }
  }
  if (i < 0) return;
  rays_out[i] = rays;
  // phase 1 (one sample): the path where it stopped, and its seeds
  if (state_out) {
    rz::store_state(state_out, n, i, path, on ? smp.s0 : 0.0f,
                    on ? smp.s1 : 0.0f);
  }
}

template <bool kOctant, bool kFrustum, class Count = rz::NoCount, class Walk>
int launch_sample(Walk w, const float* mats, const float* lights,
                  const float* cam, const float* uv, const uint8_t* act, int n,
                  const SampleParams* params, float* color_out, int* rays_out,
                  float* state_out, void* stream) {
  using W = std::conditional_t<std::is_same_v<Count, LaneCount>, Counted<Walk>,
                               Walk>;
  if (n > 0) {
    sample_kernel<W, kOctant, kFrustum, Count>
        <<<tile_blocks(n, params->width, params->height), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            W{w}, mats, lights, cam, uv, act, n, *params, color_out, rays_out,
            state_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- the regenerating K1: rz_sample_wave, _tiered and _wide ----


// Persistent warps, for the tiered K1: the launch starts as many blocks as
// the card holds at once, and each warp takes warp tiles, in order, from a
// counter until none is left, so a warp that finishes early takes more
// work. Measured in turns (PERF.md §6): the tiered K1 0.91x, the whole-tree
// K1 1.02-1.04x and the wide K1 1.00x, so only the tiered walks run so.
template <class Walk>
constexpr bool kPersistent = std::is_same_v<Walk, rz::TieredWalk>;

// A lane's stage in its current sample: the primary ray, shadow ray li of
// the primary hit (stage = li >= 0), or a bounce ray.
constexpr int kPrimary = -1, kBounce = -2;

// K1 with in-thread path regeneration: each lane runs its own pixel's
// samples as a state machine that traces one ray per iteration, at one walk
// call site (Walk::trace, a kEither walk: closest and shadow rays share the
// node loop). A lane whose path ends starts its next sample at once instead
// of waiting for the longest path of its warp. Each pixel sums its samples,
// sub-blocks and lights in the lockstep kernel's order, with the same
// operations, so its colour and ray count are the lockstep kernel's bit for
// bit. Between iterations a lane keeps its sample's state: the path (whose
// origin holds the hit point and whose colour holds the direct-lighting sum
// while the lights are sampled), the primary hit's normal and material, the
// sampler seeds, the sub-block sum and the ray count; the view vector, the
// material row and each light's ray are recomputed where they are used.
template <class Count, class Walk>
__device__ __forceinline__ void regen_pixel(
    int i, const Walk& w, const float* __restrict__ mats,
    const float* __restrict__ lights, const float* __restrict__ cam,
    const float* __restrict__ uv, const uint8_t* __restrict__ act,
    const SampleParams& p, float* __restrict__ color_out,
    int* __restrict__ rays_out, int n, float* __restrict__ state_out) {
#pragma unroll
  for (int c = 0; c < 3; ++c) color_out[3 * i + c] = 0.0f;
  if (act[i] == 0 || p.n_samples <= 0) {
    rays_out[i] = 0;
    if (state_out) rz::store_state(state_out, n, i, Path{}, 0.0f, 0.0f);
    return;
  }
  const Count cnt{};
  const float u = uv[2 * i], v = uv[2 * i + 1];
  const float cpx = __ldg(cam + 32), cpy = __ldg(cam + 33),
              cpz = __ldg(cam + 34);
  rz::Sampler smp{};
  smp.hash = p.rng_hash != 0;
  smp.h_pix = rz::pixel_key(p, u, v);
  const int groups = p.n_samples / p.fuse;  // sample fusion, as sample_kernel

  float acc[3] = {0.0f, 0.0f, 0.0f};  // the current sub-block's sum
  int rays = 0;
  int s = 0, stage = kPrimary, b = 0;
  bool hit0 = false;
  Path path{};
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, menc = 0.0f;  // the primary hit
  // sample s: its primary direction in path.d
  const auto begin_sample = [&]() {
    const int sb = s / groups, g = s - sb * groups;
    float P[8], V[12];
#pragma unroll
    for (int k = 0; k < 8; ++k) P[k] = __ldg(cam + k);
#pragma unroll
    for (int k = 0; k < 12; ++k) V[k] = __ldg(cam + 16 + k);
    path = Path{};
    rz::camera_dir(P, V, u, v, (float)p.width, (float)p.height,
                   p.samp0 + (float)(g * p.fuse + sb), smp, path.dx, path.dy,
                   path.dz);
    stage = kPrimary;
    hit0 = false;
  };
  begin_sample();
  for (;;) {
    // ---- this iteration's ray, and its walk: one call site for all lanes
    const bool shadow = stage >= 0;
    rz::HitRec h{rz::T_FAR, -1, 0.0f, 0.0f, 0.0f, 0.0f};
    rz::Ray r;
    if (stage == kPrimary) {
      r = rz::make_ray(cpx, cpy, cpz, path.dx, path.dy, path.dz);
    } else if (shadow) {
      const rz::LightRay l =
          rz::light_ray(lights + 8 * stage, path.ox, path.oy, path.oz);
      h.t = l.maxd;
      r = rz::shadow_ray(l, path.ox, path.oy, path.oz);
    } else {
      r = rz::make_ray(path.ox, path.oy, path.oz, path.dx, path.dy, path.dz);
    }
    float vis = 1.0f;
    w.trace(r, shadow, p.min_vis, p.shadow_eps, h, vis, cnt);
    rays += 1;

    // ---- what the ray found
    bool done = false;
    if (stage == kPrimary) {
      if (h.menc == 0.0f) {  // sky (glsl:706-709)
        const float sky_t = 0.5f * (path.dy + 1.0f);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc[c] = acc[c] + (p.sky_h[c] + p.sky_d[c] * sky_t);
        }
        done = true;
      } else {  // bounce 0, the only one with direct lighting
        hit0 = true;
        rz::hit_normal(h, nx, ny, nz);
        menc = h.menc;
        path.ox = cpx + path.dx * h.t;
        path.oy = cpy + path.dy * h.t;
        path.oz = cpz + path.dz * h.t;
        rz::light_init(p, rz::load_material(mats, p.n_mats, menc), path.c);
        stage = 0;
      }
    } else if (shadow) {
      const float* g = lights + 8 * stage;
      const rz::LightRay l = rz::light_ray(g, path.ox, path.oy, path.oz);
      float vx = cpx - path.ox, vy = cpy - path.oy, vz = cpz - path.oz;
      rz::normalize3(vx, vy, vz, 1e-20f);
      const float n_dot_v = fmaxf(rz::dot3(nx, ny, nz, vx, vy, vz), 0.0f);
      rz::add_light(g, l, vis, p.min_vis,
                    rz::load_material(mats, p.n_mats, menc), nx, ny, nz, vx,
                    vy, vz, n_dot_v, path.c);
      stage += 1;
    } else {
      rz::shade_bounce(mats, p, smp, b, h, path);
      b += 1;
      done = !path.alive || b >= p.b_stop;
    }
    if (stage == p.n_lights) {  // the lights are done: bounce 0's scatter
#pragma unroll
      for (int c = 0; c < 3; ++c) path.c[c] = 0.0f + path.c[c];
      rz::start_path(smp, path.ox, path.oy, path.oz, path.dx, path.dy,
                     path.dz, nx, ny, nz,
                     rz::load_material(mats, p.n_mats, menc), path);
      stage = kBounce;
      b = 1;
      done = b >= p.b_stop;
    }
    if (!done) continue;

    // ---- the sample ends: fold it in, and start the next; phase 1 (one
    // sample) writes the path where it stopped, and its seeds
    if (state_out) rz::store_state(state_out, n, i, path, smp.s0, smp.s1);
    if (hit0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + path.c[c];
    }
    const int sb = s / groups, g = s - sb * groups;
    if (g == groups - 1) {  // the sub-block ends
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        color_out[3 * i + c] = color_out[3 * i + c] + acc[c];
        acc[c] = 0.0f;
      }
    }
    if (++s == p.n_samples) break;
    begin_sample();
  }
  rays_out[i] = rays;
}

// rays_out holds n + 1 ints: the last, zeroed by the wrapper, is the
// persistent warps' counter of warp tiles taken.
template <class Walk, class Count>
__global__ void __launch_bounds__(kThreads, RZ_K1_MIN_BLOCKS)
    regen_kernel(Walk w, const float* __restrict__ mats,
                 const float* __restrict__ lights,
                 const float* __restrict__ cam, const float* __restrict__ uv,
                 const uint8_t* __restrict__ act, int n, SampleParams p,
                 float* __restrict__ color_out, int* __restrict__ rays_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (!kPersistent<Walk>) {
    const int i = tile_pixel(blockIdx.x, warp, lane, n, p.width, p.height);
    if (i >= 0) {
      regen_pixel<Count>(i, w, mats, lights, cam, uv, act, p, color_out,
                         rays_out, n, nullptr);
    }
  } else {
    const int n_items = tile_blocks(n, p.width, p.height) * kWarps;
    for (;;) {
      int item = 0;
      if (lane == 0) item = atomicAdd(rays_out + n, 1);
      item = __shfl_sync(rz::kFullMask, item, 0);
      if (item >= n_items) break;
      const int i =
          tile_pixel(item / kWarps, item % kWarps, lane, n, p.width, p.height);
      if (i >= 0) {
        regen_pixel<Count>(i, w, mats, lights, cam, uv, act, p, color_out,
                           rays_out, n, nullptr);
      }
    }
  }
}

// K4's plain phase 1 on the regenerating loop: regen_kernel's warp tiles,
// one pixel a lane and one sample, which writes the pixel's state rows when
// its path stops (b_stop = split_bounce). One walk call site serves the
// primary, shadow and bounce rays of a warp's lanes, so a lane no longer
// idles through its neighbours' walks of another kind, as in the lockstep
// loop (0.74 vs 0.82 ms at 1080p on an H100, PERF.md §6). Lanes that went
// on to the same lane slot of their warp's next tiles (2, 4, 8 tiles a
// warp) lost: a warp then runs as long as its lanes' longest chain of
// pixels.
template <class Walk, class Count>
__global__ void __launch_bounds__(kThreads, RZ_K1_MIN_BLOCKS)
    regen_phase1_kernel(Walk w, const float* __restrict__ mats,
                        const float* __restrict__ lights,
                        const float* __restrict__ cam,
                        const float* __restrict__ uv,
                        const uint8_t* __restrict__ act, int n, SampleParams p,
                        float* __restrict__ color_out,
                        int* __restrict__ rays_out,
                        float* __restrict__ state_out) {
  const int i = tile_pixel(blockIdx.x, threadIdx.x >> 5, threadIdx.x & 31, n,
                           p.width, p.height);
  if (i >= 0) {
    regen_pixel<Count>(i, w, mats, lights, cam, uv, act, p, color_out,
                       rays_out, n, state_out);
  }
}

template <class Count = rz::NoCount, class Walk>
int launch_regen(Walk w, const float* mats, const float* lights,
                 const float* cam, const float* uv, const uint8_t* act, int n,
                 const SampleParams* params, float* color_out, int* rays_out,
                 void* stream) {
  if (n > 0) {
    int blocks = tile_blocks(n, params->width, params->height);
    if constexpr (kPersistent<Walk>) {  // as many as the card holds at once
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess) {
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      }
      if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, regen_kernel<Walk, Count>, kThreads, 0);
      }
      if (e != cudaSuccess) return static_cast<int>(e);
      blocks = std::min(blocks, std::max(1, sms * per_sm));
    }
    regen_kernel<Walk, Count>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            w, mats, lights, cam, uv, act, n, *params, color_out, rays_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4's phase 1, plain form: regen_phase1_kernel.
template <class Count = rz::NoCount, class Walk>
int launch_phase1(Walk w, const float* mats, const float* lights,
                  const float* cam, const float* uv, const uint8_t* act, int n,
                  const SampleParams* params, float* color_out, int* rays_out,
                  float* state_out, void* stream) {
  if (n > 0) {
    regen_phase1_kernel<Walk, Count>
        <<<tile_blocks(n, params->width, params->height), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(w, mats, lights, cam, uv, act,
                                                n, *params, color_out,
                                                rays_out, state_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The compiled budget of a K1 kernel launched with kThreads threads: out =
// {threads per block, registers per thread, local memory per thread in bytes
// (the walk stacks and any spills), resident warps per SM}.
template <class Kernel>
int budget_of(Kernel kernel, int* out) {
  return rz::budget_of(kernel, kThreads, out);
}

}  // namespace

// The entry points: K1 (whole tree, tiered or wide, each plain or with K9
// bounce walks; whole tree with the K6 primary, plain or K9; the K9 and K6
// forms on the tiled lockstep loop) and K4's phase 1 (whole tree, plain or
// K9, each with or without the K6 primary). K1
// passes params->b_stop = max_bounces; phase 1 passes n_samples = 1 and the
// split. The wide forms take the wide tables (inner8, leaf8) in the places
// of (inner, leaf).
#define RZ_BVH2_ARGS                                                       \
  const float *inner, const float *leaf, int leaf_w, int leaf_k,           \
      const float *mats, const float *lights, const float *cam,            \
      const float *uv, const uint8_t *act, int n,                          \
      const rz::SampleParams *params, float *color_out, int *rays_out
#define RZ_TIERED_ARGS                                                     \
  const float *top, const float *tre_inner, const float *tre_leaf, int si, \
      int sl, int leaf_w, int leaf_k, const float *mats,                   \
      const float *lights, const float *cam, const float *uv,              \
      const uint8_t *act, int n, const rz::SampleParams *params,           \
      float *color_out, int *rays_out
#define RZ_BVH2_WALK rz::Bvh2Walk{{inner, leaf, leaf_w, leaf_k}}
#define RZ_BVH8_WALK rz::Bvh8Walk{{inner, leaf, leaf_w, leaf_k}}
#define RZ_TIERED_WALK \
  rz::TieredWalk{{top, tre_inner, tre_leaf, si, sl, leaf_w, leaf_k}}
#define RZ_REST mats, lights, cam, uv, act, n, params, color_out, rays_out

extern "C" {

int rz_sample_params_size() { return (int)sizeof(rz::SampleParams); }

int rz_sample_wave(RZ_BVH2_ARGS, void* stream) {
  return launch_regen(RZ_BVH2_WALK, RZ_REST, stream);
}

int rz_sample_wave_octant(RZ_BVH2_ARGS, void* stream) {
  return launch_sample<true, false>(RZ_BVH2_WALK, RZ_REST, nullptr,
                                          stream);
}

int rz_sample_wave_tiered(RZ_TIERED_ARGS, void* stream) {
  return launch_regen(RZ_TIERED_WALK, RZ_REST, stream);
}

int rz_sample_wave_tiered_octant(RZ_TIERED_ARGS, void* stream) {
  return launch_sample<true, false>(RZ_TIERED_WALK, RZ_REST, nullptr,
                                          stream);
}

int rz_sample_wave_phase1(RZ_BVH2_ARGS, float* state_out, void* stream) {
  return launch_phase1(RZ_BVH2_WALK, RZ_REST, state_out, stream);
}

int rz_sample_wave_phase1_octant(RZ_BVH2_ARGS, float* state_out,
                                 void* stream) {
  return launch_sample<true, false>(RZ_BVH2_WALK, RZ_REST,
                                                  state_out, stream);
}

int rz_sample_wave_wide(RZ_BVH2_ARGS, void* stream) {
  return launch_regen(RZ_BVH8_WALK, RZ_REST, stream);
}

int rz_sample_wave_wide_octant(RZ_BVH2_ARGS, void* stream) {
  return launch_sample<true, false>(RZ_BVH8_WALK, RZ_REST, nullptr,
                                          stream);
}

int rz_sample_wave_frustum(RZ_BVH2_ARGS, void* stream) {
  return launch_sample<false, true>(RZ_BVH2_WALK, RZ_REST, nullptr,
                                          stream);
}

int rz_sample_wave_frustum_octant(RZ_BVH2_ARGS, void* stream) {
  return launch_sample<true, true>(RZ_BVH2_WALK, RZ_REST, nullptr,
                                         stream);
}

int rz_sample_wave_phase1_frustum(RZ_BVH2_ARGS, float* state_out,
                                  void* stream) {
  return launch_sample<false, true>(RZ_BVH2_WALK, RZ_REST,
                                                  state_out, stream);
}

int rz_sample_wave_phase1_frustum_octant(RZ_BVH2_ARGS, float* state_out,
                                         void* stream) {
  return launch_sample<true, true>(RZ_BVH2_WALK, RZ_REST,
                                                 state_out, stream);
}

// The counting K1 forms: each form with LaneCount at every walk step (the
// regenerating kernel for the whole tree, tiered and wide; the tiled
// lockstep loop, walking through Counted, for the K9 and K6 forms). Only
// chip_smoke.py, scripts/k1_schedule.py and the card tests launch them; the
// sums are read with rz_walk_lanes.
int rz_sample_wave_count(RZ_BVH2_ARGS, void* stream) {
  return launch_regen<LaneCount>(RZ_BVH2_WALK, RZ_REST, stream);
}

int rz_sample_wave_tiered_count(RZ_TIERED_ARGS, void* stream) {
  return launch_regen<LaneCount>(RZ_TIERED_WALK, RZ_REST, stream);
}

int rz_sample_wave_wide_count(RZ_BVH2_ARGS, void* stream) {
  return launch_regen<LaneCount>(RZ_BVH8_WALK, RZ_REST, stream);
}

int rz_sample_wave_octant_count(RZ_BVH2_ARGS, void* stream) {
  return launch_sample<true, false, LaneCount>(RZ_BVH2_WALK, RZ_REST,
                                                     nullptr, stream);
}

int rz_sample_wave_tiered_octant_count(RZ_TIERED_ARGS, void* stream) {
  return launch_sample<true, false, LaneCount>(RZ_TIERED_WALK, RZ_REST,
                                                     nullptr, stream);
}

int rz_sample_wave_wide_octant_count(RZ_BVH2_ARGS, void* stream) {
  return launch_sample<true, false, LaneCount>(RZ_BVH8_WALK, RZ_REST,
                                                     nullptr, stream);
}

int rz_sample_wave_frustum_count(RZ_BVH2_ARGS, void* stream) {
  return launch_sample<false, true, LaneCount>(RZ_BVH2_WALK, RZ_REST,
                                                     nullptr, stream);
}

int rz_sample_wave_frustum_octant_count(RZ_BVH2_ARGS, void* stream) {
  return launch_sample<true, true, LaneCount>(RZ_BVH2_WALK, RZ_REST,
                                                    nullptr, stream);
}

// The counting forms of K4's phase 1 (the octant and frustum ones are the
// same instantiations as K1's K9 and K6 counting forms).
int rz_sample_wave_phase1_count(RZ_BVH2_ARGS, float* state_out, void* stream) {
  return launch_phase1<LaneCount>(RZ_BVH2_WALK, RZ_REST, state_out, stream);
}

int rz_sample_wave_phase1_octant_count(RZ_BVH2_ARGS, float* state_out,
                                       void* stream) {
  return launch_sample<true, false, LaneCount>(
      RZ_BVH2_WALK, RZ_REST, state_out, stream);
}

int rz_sample_wave_phase1_frustum_count(RZ_BVH2_ARGS, float* state_out,
                                        void* stream) {
  return launch_sample<false, true, LaneCount>(
      RZ_BVH2_WALK, RZ_REST, state_out, stream);
}

int rz_sample_wave_phase1_frustum_octant_count(RZ_BVH2_ARGS, float* state_out,
                                               void* stream) {
  return launch_sample<true, true, LaneCount>(
      RZ_BVH2_WALK, RZ_REST, state_out, stream);
}

// out[0] = active lane-steps, out[1] = warp-steps x 32 over the counting
// launches since the last reset (synchronises the device); reset != 0 then
// zeroes the sums.
int rz_walk_lanes(unsigned long long* out, int reset) {
  return rz::read_walk_lanes(out, reset);
}

// The compiled budget (budget_of) of a K1 form: policy 0 the whole tree, 1
// the tiered view, 2 the wide tables (regen_kernel); 3-5 the same with K9
// bounce walks, 6 the K6 primary, 7 the K6 primary with K9 bounce walks
// (the tiled sample_kernel); 8 K4's plain phase 1 (its K9 and K6 forms are
// 3, 6 and 7 of a build with its tiles).
int rz_sample_budget(int policy, int* out) {
  using rz::Bvh2Walk;
  using rz::Bvh8Walk;
  using rz::NoCount;
  using rz::TieredWalk;
  switch (policy) {
    case 1: return budget_of(regen_kernel<TieredWalk, NoCount>, out);
    case 2: return budget_of(regen_kernel<Bvh8Walk, NoCount>, out);
    case 3: return budget_of(sample_kernel<Bvh2Walk, true, false>, out);
    case 4: return budget_of(sample_kernel<TieredWalk, true, false>, out);
    case 5: return budget_of(sample_kernel<Bvh8Walk, true, false>, out);
    case 6: return budget_of(sample_kernel<Bvh2Walk, false, true>, out);
    case 7: return budget_of(sample_kernel<Bvh2Walk, true, true>, out);
    case 8: return budget_of(regen_phase1_kernel<Bvh2Walk, NoCount>, out);
    default: return budget_of(regen_kernel<Bvh2Walk, NoCount>, out);
  }
}

}  // extern "C"
