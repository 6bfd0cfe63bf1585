// K4's continuation kernel: resume each ray of a compacted wave at bounce
// b_start from its 13 continuation rows and trace it to b_stop.
//
// Replaces rayzen_tpu/ops/megakernel.py::_make_continuation_kernel (:743),
// launched by sample_wave_split (:1022). Phase 1 (sample_kernel.cu with a
// state output) traces bounces 0..split-1 and writes the rows; the host
// permutes them so the live rays come first (ops/megakernel.py
// compaction_permutation, cumsum ranks as in JAX); this kernel runs the
// shared bounce loop (shade.cuh trace_bounces) from there. Its colour starts
// at 0, as in JAX (:781-786); the host adds it to phase 1's colour through
// the permutation. With a state output (split_every) it writes the rows
// again for the next compaction. kOctant runs the bounce walks as K9.
//
// What bounds it on an H100: the walks again, now over dense warps of live
// rays: after compaction a warp holds 32 survivors (or, at the tail, dead
// slots), where in K1 a warp keeps walking for its last live lane. The
// state costs 52 bytes per live ray read and 4 per dead slot (its alive
// row; with split_every also its seeds, which pass through to the 13 rows
// written again for every slot), coalesced: one (R,) row per field. The grid covers all R slots, as JAX
// launches all packets: a dead slot's thread returns at once (its warp
// retires when all 32 are dead), which spares reading the live count back
// to the host, a sync per sample.
#include "shade.cuh"

namespace {

using rz::Path;
using rz::SampleParams;
constexpr int kBlock = 128;

template <class Walk, bool kOctant>
__global__ void continuation_kernel(Walk w, const float* __restrict__ mats,
                                    const float* __restrict__ state_in, int n,
                                    SampleParams p,
                                    float* __restrict__ color_out,
                                    int* __restrict__ rays_out,
                                    float* __restrict__ state_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // K9's votes name the whole warp: with kOctant every lane stays to the end
  if (!kOctant && i >= n) return;
  Path path{};
  rz::Sampler smp{};
  smp.hash = false;  // the split runs the sin-hash flow only (host-checked)
  smp.samp_f = p.samp0;
  if (i < n) {
    const auto row = [&](int k) { return state_in[(size_t)k * n + i]; };
    path.alive = row(rz::kAlive) > 0.5f;
    if (path.alive || state_out) {  // a dead row's seeds only pass through
      smp.s0 = row(rz::kS0);
      smp.s1 = row(rz::kS1);
    }
    if (path.alive) {
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
    }
  }
  rz::trace_bounces<kOctant>(w, mats, p, smp, p.b_start, p.b_stop, path);
  if (i >= n) return;
  color_out[3 * i] = path.c[0];
  color_out[3 * i + 1] = path.c[1];
  color_out[3 * i + 2] = path.c[2];
  rays_out[i] = path.rays;
  if (state_out) rz::store_state(state_out, n, i, path, smp.s0, smp.s1);
}

template <bool kOctant>
int launch_continuation(const float* inner, const float* leaf, int leaf_w,
                        int leaf_k, const float* mats, const float* state_in,
                        int n, const SampleParams* params, float* color_out,
                        int* rays_out, float* state_out, void* stream) {
  if (n > 0) {
    const rz::Bvh2Walk w{{inner, leaf, leaf_w, leaf_k}};
    continuation_kernel<rz::Bvh2Walk, kOctant>
        <<<(n + kBlock - 1) / kBlock, kBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(w, mats, state_in, n, *params,
                                                color_out, rays_out,
                                                state_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// state_in / state_out: (13, n) float32 continuation rows (rz::StateRow);
// state_out may be null (the last phase of a sample)
int rz_continuation(const float* inner, const float* leaf, int leaf_w,
                    int leaf_k, const float* mats, const float* state_in,
                    int n, const rz::SampleParams* params, float* color_out,
                    int* rays_out, float* state_out, void* stream) {
  return launch_continuation<false>(inner, leaf, leaf_w, leaf_k, mats,
                                    state_in, n, params, color_out, rays_out,
                                    state_out, stream);
}

int rz_continuation_octant(const float* inner, const float* leaf, int leaf_w,
                           int leaf_k, const float* mats,
                           const float* state_in, int n,
                           const rz::SampleParams* params, float* color_out,
                           int* rays_out, float* state_out, void* stream) {
  return launch_continuation<true>(inner, leaf, leaf_w, leaf_k, mats,
                                   state_in, n, params, color_out, rays_out,
                                   state_out, stream);
}

}  // extern "C"
