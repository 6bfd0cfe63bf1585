// K1: full path-tracing samples, one thread per pixel, all samples looped
// inside the thread and all state in registers.
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
// Phase 1 of the split-bounce wavefront (K4, megakernel.py:976-992) is this
// kernel with one sample, b_stop = split_bounce and a state output: it also
// writes the 13 continuation rows (stop_bounce / emit_state, :486-490,
// :706-711) that continuation_kernel.cu resumes from.
//
// What bounds it on an H100: the BVH walks (walk.cuh) — dependent, divergent
// loads from L2-resident tables (~0.5 MB for the demo scene; ~45 MB of
// treelet tables for the 503k-triangle field, about the size of the L2). Shading is a
// few hundred flops per bounce and the only global traffic besides the walks
// is the (R, 2) uv read and the (R, 3) + (R,) result write. The design keeps
// the whole sample loop in one thread, so no wave state ever goes to memory
// and a ray that dies stops costing work at once; materials, lights and the
// camera are tiny tables read through the read-only cache. Divergence between
// the rays of a warp (different bounce counts, different walks) is the known
// cost of this simple form.
#include "frustum.cuh"
#include "shade.cuh"

namespace {

using rz::Path;
using rz::SampleParams;
constexpr int kBlock = 128;

template <class Walk, bool kOctant, bool kFrustum>
__global__ void sample_kernel(Walk w, const float* __restrict__ mats,
                              const float* __restrict__ lights,
                              const float* __restrict__ cam,
                              const float* __restrict__ uv,
                              const uint8_t* __restrict__ act, int n,
                              SampleParams p, float* __restrict__ color_out,
                              int* __restrict__ rays_out,
                              float* __restrict__ state_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // K9's votes and K6's shuffles name the whole warp: with kOctant or
  // kFrustum every lane stays to the end
  constexpr bool kWarp = kOctant || kFrustum;
  if (!kWarp && i >= n) return;
  const bool on = i < n && act[i] != 0;
  float acc[3] = {0.0f, 0.0f, 0.0f};  // the current sub-block's sum
  int rays = 0;
  if (i < n) {  // the sub-block sums add up here
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
    uint32_t key_h = 0;
    if (smp.hash) {
      const uint32_t pixel_id =
          (uint32_t)(int32_t)floorf(v * H) * (uint32_t)(p.width * 2) +
          (uint32_t)(int32_t)floorf(u * W);
      key_h = rz::hash_u32((uint32_t)p.key + 0x9E3779B9u);
      smp.h_pix = rz::hash_u32(pixel_id ^ key_h);
    }

    // sample fusion (cfg.sample_fuse, megakernel.py:592-607, :723-730):
    // sub-block sb sums the samples g * fuse + sb in order of g, from zero,
    // and the sub-blocks add up in order, ((A0 + A1) + A2) + ..., in
    // color_out, so that no sum but the current one takes registers; with
    // fuse 1 this is the plain sum over samples
    const int groups = p.n_samples / p.fuse;
    for (int s = 0; s < p.n_samples; ++s) {
      const int sb = s / groups, g = s - sb * groups;
      const float samp_f = p.samp0 + (float)(g * p.fuse + sb);
      smp.samp_f = samp_f;
      path = Path{};
      bool hit0 = false;
      float dx = 0.0f, dy = 0.0f, dz = 0.0f;
      if (on) {
        float jx, jy;
        if (!smp.hash) {
          // seed = uv * (fragX + fragY + samp + 1) (glsl:688)
          const float scale =
              ((floorf(u * W) + floorf(v * H)) + 1.0f) + (samp_f + 1.0f);
          smp.s0 = u * scale;
          smp.s1 = v * scale;
          jx = rz::ref_rand(smp.s0, smp.s1) * 0.00002f;
          jy = rz::ref_rand(smp.s0 + 1.0f, smp.s1 + 1.0f) * 0.00002f;
        } else {
          smp.samp_u = (uint32_t)(int32_t)samp_f;
          const uint32_t jbase = smp.h_pix + smp.samp_u * 7919u;
          jx = (rz::u32_to_unit(rz::hash_u32(jbase + 0u)) - 0.5f) / W;
          jy = (rz::u32_to_unit(rz::hash_u32(jbase + 1u)) - 0.5f) / H;
        }

        // ---- raygen (glsl:204-212) ----
        const float ndx = (u + jx) * 2.0f - 1.0f;
        const float ndy = (v + jy) * 2.0f - 1.0f;
        const float eye0 = ((P[0] * ndx + P[1] * ndy) - P[2]) + P[3];
        const float eye1 = ((P[4] * ndx + P[5] * ndy) - P[6]) + P[7];
        dx = (V[0] * eye0 + V[1] * eye1) - V[2];
        dy = (V[4] * eye0 + V[5] * eye1) - V[6];
        dz = (V[8] * eye0 + V[9] * eye1) - V[10];
        rz::normalize3(dx, dy, dz, 0.0f);
      }

      // ---- bounce 0: primary hit, the only bounce with direct lighting
      rz::HitRec h{rz::T_FAR, -1, 0.0f, 0.0f, 0.0f, 0.0f};
      const rz::Ray pr = rz::make_ray(cpx, cpy, cpz, dx, dy, dz);
      if constexpr (kFrustum) {
        rz::frustum_closest(w.tb, pr, on, h);  // every lane of the warp
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

          // bounce-0 scatter (throughput starts at 1)
          float rand_val, hu, hv;
          smp.draws(0, rand_val, hu, hv);
          float nd[3];
          path.ior = 1.0f;
          rz::scatter(dx, dy, dz, nx, ny, nz, path.ior, rand_val, hu, hv, m,
                      nd, path.tp);
          const float push =
              rz::dot3(nd[0], nd[1], nd[2], nx, ny, nz) > 0.0f ? 0.003f
                                                               : -0.003f;
          path.ox = px + nx * push;
          path.oy = py + ny * push;
          path.oz = pz + nz * push;
          path.dx = nd[0];
          path.dy = nd[1];
          path.dz = nd[2];
          path.alive = true;
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
          if (i < n) color_out[3 * i + c] = color_out[3 * i + c] + acc[c];
          acc[c] = 0.0f;
        }
      }
    }
  }
  if (i >= n) return;
  rays_out[i] = rays;
  // phase 1 (one sample): the path where it stopped, and its seeds
  if (state_out) {
    rz::store_state(state_out, n, i, path, on ? smp.s0 : 0.0f,
                    on ? smp.s1 : 0.0f);
  }
}

template <bool kOctant, bool kFrustum = false, class Walk>
int launch_sample(Walk w, const float* mats, const float* lights,
                  const float* cam, const float* uv, const uint8_t* act, int n,
                  const SampleParams* params, float* color_out, int* rays_out,
                  float* state_out, void* stream) {
  if (n > 0) {
    sample_kernel<Walk, kOctant, kFrustum>
        <<<(n + kBlock - 1) / kBlock, kBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(
        w, mats, lights, cam, uv, act, n, *params, color_out, rays_out,
        state_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The entry points: K1 (whole tree, tiered or wide, each plain or with K9
// bounce walks; whole tree with the K6 primary, plain or K9) and K4's phase
// 1 (whole tree, plain or K9, each with or without the K6 primary). K1
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
  return launch_sample<false>(RZ_BVH2_WALK, RZ_REST, nullptr, stream);
}

int rz_sample_wave_octant(RZ_BVH2_ARGS, void* stream) {
  return launch_sample<true>(RZ_BVH2_WALK, RZ_REST, nullptr, stream);
}

int rz_sample_wave_tiered(RZ_TIERED_ARGS, void* stream) {
  return launch_sample<false>(RZ_TIERED_WALK, RZ_REST, nullptr, stream);
}

int rz_sample_wave_tiered_octant(RZ_TIERED_ARGS, void* stream) {
  return launch_sample<true>(RZ_TIERED_WALK, RZ_REST, nullptr, stream);
}

int rz_sample_wave_phase1(RZ_BVH2_ARGS, float* state_out, void* stream) {
  return launch_sample<false>(RZ_BVH2_WALK, RZ_REST, state_out, stream);
}

int rz_sample_wave_phase1_octant(RZ_BVH2_ARGS, float* state_out,
                                 void* stream) {
  return launch_sample<true>(RZ_BVH2_WALK, RZ_REST, state_out, stream);
}

int rz_sample_wave_wide(RZ_BVH2_ARGS, void* stream) {
  return launch_sample<false>(RZ_BVH8_WALK, RZ_REST, nullptr, stream);
}

int rz_sample_wave_wide_octant(RZ_BVH2_ARGS, void* stream) {
  return launch_sample<true>(RZ_BVH8_WALK, RZ_REST, nullptr, stream);
}

int rz_sample_wave_frustum(RZ_BVH2_ARGS, void* stream) {
  return launch_sample<false, true>(RZ_BVH2_WALK, RZ_REST, nullptr, stream);
}

int rz_sample_wave_frustum_octant(RZ_BVH2_ARGS, void* stream) {
  return launch_sample<true, true>(RZ_BVH2_WALK, RZ_REST, nullptr, stream);
}

int rz_sample_wave_phase1_frustum(RZ_BVH2_ARGS, float* state_out,
                                  void* stream) {
  return launch_sample<false, true>(RZ_BVH2_WALK, RZ_REST, state_out, stream);
}

int rz_sample_wave_phase1_frustum_octant(RZ_BVH2_ARGS, float* state_out,
                                         void* stream) {
  return launch_sample<true, true>(RZ_BVH2_WALK, RZ_REST, state_out, stream);
}

}  // extern "C"
