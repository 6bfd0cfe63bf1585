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
// (K2/K3), or rz::TieredWalk over the treelet view (K8) — the kernel's
// ``tiered=True`` instantiation (megakernel.py:531-552), which the JAX
// package runs for scenes past the single-tree budget. Both instantiations
// share every line of shading, RNG and bounce code below.
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
#include "walk.cuh"

namespace rz {

// per-call constants (mirrored field for field by ext.SampleParams)
struct SampleParams {
  int32_t width, height, n_samples, max_bounces;
  int32_t rr_start, rng_hash, key, n_mats;
  int32_t n_lights;
  float samp0;       // sample index of the first sample (progressive keyed)
  float min_vis;     // shadow visibility floor
  float shadow_eps;  // shadow-ray t_eps
  float sky_h[3];    // sky horizon colour
  float sky_d[3];    // zenith - horizon, rounded once from double like JAX's
  float ambient[3];
};

}  // namespace rz

namespace {

using rz::SampleParams;
constexpr int kBlock = 128;

struct Material {
  float ar, ag, ab, metal, rough, refl, transp, ior;
};

// megakernel._material_columns: the row of material |menc| - 1, zeros when
// that is not a material id (a miss encodes 0)
__device__ __forceinline__ Material load_material(const float* mats,
                                                  int n_mats, float menc) {
  const float mat_f = fabsf(menc) - 1.0f;
  Material m{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (mat_f >= 0.0f && mat_f < (float)n_mats && mat_f == floorf(mat_f)) {
    const float* row = mats + 8 * (int)mat_f;
    m = Material{__ldg(row), __ldg(row + 1), __ldg(row + 2), __ldg(row + 3),
                 __ldg(row + 4), __ldg(row + 5), __ldg(row + 6),
                 __ldg(row + 7)};
  }
  return m;
}

// oriented unit normal from the walk's cross product and sign-encoded material
__device__ __forceinline__ void hit_normal(const rz::HitRec& h, float& nx,
                                           float& ny, float& nz) {
  const float sgn = h.menc < 0.0f ? -1.0f : 1.0f;
  const float nn =
      fmaxf(sqrtf((h.cx * h.cx + h.cy * h.cy) + h.cz * h.cz), 1e-20f);
  nx = h.cx / nn * sgn;
  ny = h.cy / nn * sgn;
  nz = h.cz / nn * sgn;
}

// megakernel._hemisphere (glsl:192-202)
__device__ __forceinline__ void hemisphere(float nx, float ny, float nz,
                                           float u, float v, float& ox,
                                           float& oy, float& oz) {
  const float ct = sqrtf(1.0f - u);
  const float st = sqrtf(fmaxf(0.0f, 1.0f - ct * ct));
  const float phi = (2.0f * rz::PI_REF) * v;
  const float lx = st * cosf(phi);
  const float ly = st * sinf(phi);
  const float lz = ct;
  const bool m = fabsf(ny) < 0.99f;  // up = (0,1,0) else (1,0,0)
  const float ux = m ? 0.0f : 1.0f;
  const float uy = m ? 1.0f : 0.0f;
  const float uz = 0.0f;
  float tx = uy * nz - uz * ny;
  float ty = uz * nx - ux * nz;
  float tz = ux * ny - uy * nx;
  rz::normalize3(tx, ty, tz, 1e-20f);
  const float bx = ny * tz - nz * ty;
  const float by = nz * tx - nx * tz;
  const float bz = nx * ty - ny * tx;
  ox = (tx * lx + bx * ly) + nx * lz;
  oy = (ty * lx + by * ly) + ny * lz;
  oz = (tz * lx + bz * ly) + nz * lz;
  rz::normalize3(ox, oy, oz, 1e-20f);
}

// megakernel._scatter_tiles (glsl:722-756): new direction, throughput factor
// and the medium's new ior
__device__ __forceinline__ void scatter(float dx, float dy, float dz, float nx,
                                        float ny, float nz, float& cur_ior,
                                        float rand_val, float hemi_u,
                                        float hemi_v, const Material& m,
                                        float nd[3], float f[3]) {
  const bool is_trans = m.transp > 0.0f;
  const bool entering = -rz::dot3(dx, dy, dz, nx, ny, nz) > 0.0f;
  const float sgn = entering ? 1.0f : -1.0f;
  const float nox = nx * sgn, noy = ny * sgn, noz = nz * sgn;
  const float next_ior = entering ? m.ior : 1.0f;
  const float eta = cur_ior / next_ior;
  const float mdn = -rz::dot3(dx, dy, dz, nox, noy, noz);
  const float cosi = rz::clip01(mdn);
  const float q = (cur_ior - next_ior) / (cur_ior + next_ior);
  const float f0 = q * q;
  const float fresnel = f0 + (1.0f - f0) * rz::pow5(1.0f - cosi);

  // refract_dir (glsl:558-567): normal oriented against the incident ray
  const float cosi2 = fminf(fmaxf(mdn, -1.0f), 1.0f);
  const float sint2 = fmaxf(0.0f, 1.0f - cosi2 * cosi2);
  const float kk = 1.0f - (eta * eta) * sint2;
  const bool refr_ok = kk >= 0.0f;
  const float w = eta * cosi2 - sqrtf(fmaxf(kk, 0.0f));
  float rfx = eta * dx + w * nox;
  float rfy = eta * dy + w * noy;
  float rfz = eta * dz + w * noz;
  rz::normalize3(rfx, rfy, rfz, 1e-20f);

  const bool tir_case = is_trans && !refr_ok;
  const bool refract_case = is_trans && refr_ok;
  const bool mirror_case = !is_trans && (rand_val < m.refl);

  if (tir_case) {  // reflect about the oriented normal
    const float d_dot_no = rz::dot3(dx, dy, dz, nox, noy, noz);
    nd[0] = dx - (2.0f * d_dot_no) * nox;
    nd[1] = dy - (2.0f * d_dot_no) * noy;
    nd[2] = dz - (2.0f * d_dot_no) * noz;
    f[0] = f[1] = f[2] = 0.98f;
  } else if (refract_case) {
    nd[0] = rfx;
    nd[1] = rfy;
    nd[2] = rfz;
    const float a[3] = {m.ar, m.ag, m.ab};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float tint = (1.0f - m.transp) + a[c] * m.transp;
      f[c] = rz::clip01((tint * m.transp) * (1.0f - fresnel));
    }
  } else if (mirror_case) {  // reflect about the geometric normal
    const float d_dot_n = rz::dot3(dx, dy, dz, nx, ny, nz);
    nd[0] = dx - (2.0f * d_dot_n) * nx;
    nd[1] = dy - (2.0f * d_dot_n) * ny;
    nd[2] = dz - (2.0f * d_dot_n) * nz;
    f[0] = f[1] = f[2] = 0.95f;
  } else {
    hemisphere(nx, ny, nz, hemi_u, hemi_v, nd[0], nd[1], nd[2]);
    f[0] = m.ar * 0.4f;
    f[1] = m.ag * 0.4f;
    f[2] = m.ab * 0.4f;
  }
  if (refract_case) cur_ior = next_ior;
}

// megakernel._direct_lighting_tiles (glsl:569-663) for one live ray
template <class Walk>
__device__ __forceinline__ void direct_lighting(
    const Walk& w, const float* lights, const SampleParams& p,
    float px, float py, float pz, float nx, float ny, float nz, float vx,
    float vy, float vz, const Material& m, float out[3]) {
  const bool is_transparent = m.transp > 0.0f;
  const float q = (1.0f - m.ior) / (1.0f + m.ior);
  const float f0t = q * q;
  const float a[3] = {m.ar, m.ag, m.ab};
  float f0s[3], outs[3], outt[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f0s[c] = 0.04f * (1.0f - m.metal) + a[c] * m.metal;
    outs[c] = p.ambient[c] * a[c];
    outt[c] = 0.0f;
  }
  const float n_dot_v = fmaxf(rz::dot3(nx, ny, nz, vx, vy, vz), 0.0f);

  for (int li = 0; li < p.n_lights; ++li) {
    const float* g = lights + 8 * li;
    const float g0 = __ldg(g), g1 = __ldg(g + 1), g2 = __ldg(g + 2);
    const bool is_point = __ldg(g + 3) == 1.0f;
    const float lvx = g0 - px, lvy = g1 - py, lvz = g2 - pz;
    const float dist =
        fmaxf(sqrtf((lvx * lvx + lvy * lvy) + lvz * lvz), 0.001f);
    const float dn = sqrtf(fmaxf((g0 * g0 + g1 * g1) + g2 * g2, 1e-40f));
    const float ldx = is_point ? lvx / dist : g0 / dn;
    const float ldy = is_point ? lvy / dist : g1 / dn;
    const float ldz = is_point ? lvz / dist : g2 / dn;
    float attenuation = is_point ? __ldg(g + 7) / (dist * dist) : __ldg(g + 7);
    const float max_dist = is_point ? dist : 1e30f;

    const rz::Ray sr = rz::make_ray(px + ldx * 0.001f, py + ldy * 0.001f,
                                    pz + ldz * 0.001f, ldx, ldy, ldz);
    const float vis = w.shadow(sr, max_dist, p.min_vis, p.shadow_eps);
    attenuation = attenuation * vis;
    const bool lit = vis > p.min_vis;
    if (!lit) continue;

    const float n_dot_l = fmaxf(rz::dot3(nx, ny, nz, ldx, ldy, ldz), 0.0f);
    float hx = ldx + vx, hy = ldy + vy, hz = ldz + vz;
    rz::normalize3(hx, hy, hz, 1e-20f);
    const float n_dot_h = fmaxf(rz::dot3(nx, ny, nz, hx, hy, hz), 0.0f);
    const float h_dot_v = fmaxf(rz::dot3(hx, hy, hz, vx, vy, vz), 0.0f);
    const float p5 = rz::pow5(1.0f - h_dot_v);
    const float lc[3] = {__ldg(g + 4), __ldg(g + 5), __ldg(g + 6)};

    // transparent specular-only lobe (glsl:571-609)
    if (is_transparent) {
      const float f_t = f0t + (1.0f - f0t) * p5;
      const float rough_t = fmaxf(m.rough, 0.02f);
      const float r2 = rough_t * rough_t;
      const float a2_t = r2 * r2;
      const float dden_t = (n_dot_h * n_dot_h) * (a2_t - 1.0f) + 1.0f;
      const float d_t = a2_t / ((rz::PI_REF * dden_t) * dden_t + 1e-6f);
      const float k_t = ((rough_t + 1.0f) * (rough_t + 1.0f)) / 8.0f;
      const float gv_t = n_dot_v / ((n_dot_v * (1.0f - k_t) + k_t) + 1e-6f);
      const float gl_t = n_dot_l / ((n_dot_l * (1.0f - k_t) + k_t) + 1e-6f);
      const float denom_t = fmaxf((4.0f * n_dot_l) * n_dot_v, 1e-4f);
      const float spec_t = (((f_t * d_t) * gv_t) * gl_t) / denom_t;
      if (n_dot_l > 0.0f) {  // glsl:591 continue
        const float wt = (spec_t * attenuation) * n_dot_l;
#pragma unroll
        for (int c = 0; c < 3; ++c) outt[c] = outt[c] + wt * lc[c];
      }
    } else {
      // standard diffuse + specular (glsl:611-660)
      const float r2 = m.rough * m.rough;
      const float alpha2 = r2 * r2;
      const float dden_s = (n_dot_h * n_dot_h) * (alpha2 - 1.0f) + 1.0f;
      const float d_s = alpha2 / fmaxf((rz::PI_REF * dden_s) * dden_s, 1e-12f);
      const float k_s = ((m.rough + 1.0f) * (m.rough + 1.0f)) / 8.0f;
      float g_s = n_dot_v / (n_dot_v * (1.0f - k_s) + k_s);
      g_s = g_s * (n_dot_l / (n_dot_l * (1.0f - k_s) + k_s));
      const float denom_s = fmaxf((4.0f * n_dot_v) * n_dot_l, 1e-4f);
      const float dg = (d_s * g_s) / denom_s;
      const float ndl_pi = n_dot_l / rz::PI_REF;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float f_s = f0s[c] + (1.0f - f0s[c]) * p5;
        const float spec = f_s * dg;
        const float diffuse = ((1.0f - f_s) * a[c]) * ndl_pi;
        outs[c] = outs[c] +
                  fmaxf(0.0f, ((diffuse + spec) * lc[c]) * attenuation);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = is_transparent ? outt[c] : outs[c];
}

// per-bounce draws (rand_val, hemi_u, hemi_v): _bounce_draws_reference /
// _bounce_draws_hash
struct Sampler {
  bool hash;
  float s0, s1, samp_f;  // sin-hash seeds
  uint32_t h_pix, samp_u;  // integer-hash pixel key and sample index

  __device__ __forceinline__ void draws(int b, float& rand_val, float& hu,
                                        float& hv) const {
    if (!hash) {
      const float b_f = (float)b;
      // multiply-add fused as in ref_rand (common.cuh)
      const float ts0 = __fmaf_rn(s0 * (b_f * b_f), 12793.46f, b_f * 1423.34f);
      const float ts1 = __fmaf_rn(s1 * (b_f * b_f), 12793.46f, b_f * 1423.34f);
      rand_val = rz::ref_rand(ts0 + samp_f, ts1 + b_f);
      hu = rz::ref_rand(ts0, ts1);
      hv = rz::ref_rand(ts0 + 1.0f, ts1 + 1.0f);
    } else {
      const uint32_t base = h_pix + samp_u * 7919u + (uint32_t)b * 127u;
      rand_val = rz::u32_to_unit(rz::hash_u32(base + 2u));
      hu = rz::u32_to_unit(rz::hash_u32(base + 3u));
      hv = rz::u32_to_unit(rz::hash_u32(base + 4u));
    }
  }
};

template <class Walk>
__global__ void sample_kernel(Walk w, const float* __restrict__ mats,
                              const float* __restrict__ lights,
                              const float* __restrict__ cam,
                              const float* __restrict__ uv,
                              const uint8_t* __restrict__ act, int n,
                              SampleParams p, float* __restrict__ color_out,
                              int* __restrict__ rays_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  int rays = 0;
  if (act[i]) {
    const float u = uv[2 * i], v = uv[2 * i + 1];
    const float W = (float)p.width, H = (float)p.height;
    float P[8], V[12];
#pragma unroll
    for (int k = 0; k < 8; ++k) P[k] = __ldg(cam + k);  // inv_proj rows 0-1
#pragma unroll
    for (int k = 0; k < 12; ++k) V[k] = __ldg(cam + 16 + k);  // inv_view 0-2
    const float cpx = __ldg(cam + 32), cpy = __ldg(cam + 33),
                cpz = __ldg(cam + 34);

    Sampler smp;
    smp.hash = p.rng_hash != 0;
    uint32_t key_h = 0;
    if (smp.hash) {
      const uint32_t pixel_id =
          (uint32_t)(int32_t)floorf(v * H) * (uint32_t)(p.width * 2) +
          (uint32_t)(int32_t)floorf(u * W);
      key_h = rz::hash_u32((uint32_t)p.key + 0x9E3779B9u);
      smp.h_pix = rz::hash_u32(pixel_id ^ key_h);
    }

    for (int s = 0; s < p.n_samples; ++s) {
      const float samp_f = p.samp0 + (float)s;
      smp.samp_f = samp_f;
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
      float dx = (V[0] * eye0 + V[1] * eye1) - V[2];
      float dy = (V[4] * eye0 + V[5] * eye1) - V[6];
      float dz = (V[8] * eye0 + V[9] * eye1) - V[10];
      rz::normalize3(dx, dy, dz, 0.0f);
      float ox = cpx, oy = cpy, oz = cpz;

      // ---- bounce 0: primary hit, the only bounce with direct lighting ----
      float cr = 0.0f, cg = 0.0f, cb = 0.0f;
      rays += 1;
      rz::HitRec h{rz::T_FAR, -1, 0.0f, 0.0f, 0.0f, 0.0f};
      w.closest(rz::make_ray(ox, oy, oz, dx, dy, dz), h);
      if (h.menc == 0.0f) {  // sky (glsl:706-709)
        const float sky_t = 0.5f * (dy + 1.0f);
        acc[0] = acc[0] + (p.sky_h[0] + p.sky_d[0] * sky_t);
        acc[1] = acc[1] + (p.sky_h[1] + p.sky_d[1] * sky_t);
        acc[2] = acc[2] + (p.sky_h[2] + p.sky_d[2] * sky_t);
        continue;
      }
      float nx, ny, nz;
      hit_normal(h, nx, ny, nz);
      Material m = load_material(mats, p.n_mats, h.menc);
      const float px = ox + dx * h.t, py = oy + dy * h.t, pz = oz + dz * h.t;
      float vx = cpx - px, vy = cpy - py, vz = cpz - pz;
      rz::normalize3(vx, vy, vz, 1e-20f);
      float direct[3];
      direct_lighting(w, lights, p, px, py, pz, nx, ny, nz, vx, vy, vz, m,
                      direct);
      rays += p.n_lights;
      cr = cr + direct[0];
      cg = cg + direct[1];
      cb = cb + direct[2];

      // bounce-0 scatter (throughput starts at 1)
      float rand_val, hu, hv;
      smp.draws(0, rand_val, hu, hv);
      float ior = 1.0f, nd[3], tp[3];
      scatter(dx, dy, dz, nx, ny, nz, ior, rand_val, hu, hv, m, nd, tp);
      float push = rz::dot3(nd[0], nd[1], nd[2], nx, ny, nz) > 0.0f ? 0.003f
                                                                   : -0.003f;
      ox = px + nx * push;
      oy = py + ny * push;
      oz = pz + nz * push;
      dx = nd[0];
      dy = nd[1];
      dz = nd[2];

      // ---- bounces 1..max_bounces-1 ----
      const bool rr_on = p.rr_start < p.max_bounces - 1;
      for (int b = 1; b < p.max_bounces; ++b) {
        rays += 1;
        h = rz::HitRec{rz::T_FAR, -1, 0.0f, 0.0f, 0.0f, 0.0f};
        w.closest(rz::make_ray(ox, oy, oz, dx, dy, dz), h);
        if (h.menc == 0.0f) {
          const float sky_t = 0.5f * (dy + 1.0f);
          cr = cr + tp[0] * (p.sky_h[0] + p.sky_d[0] * sky_t);
          cg = cg + tp[1] * (p.sky_h[1] + p.sky_d[1] * sky_t);
          cb = cb + tp[2] * (p.sky_h[2] + p.sky_d[2] * sky_t);
          break;
        }
        hit_normal(h, nx, ny, nz);
        m = load_material(mats, p.n_mats, h.menc);
        smp.draws(b, rand_val, hu, hv);
        float fct[3];
        scatter(dx, dy, dz, nx, ny, nz, ior, rand_val, hu, hv, m, nd, fct);
        tp[0] = tp[0] * fct[0];
        tp[1] = tp[1] * fct[1];
        tp[2] = tp[2] * fct[2];
        push = rz::dot3(nd[0], nd[1], nd[2], nx, ny, nz) > 0.0f ? 0.003f
                                                             : -0.003f;
        ox = (ox + dx * h.t) + nx * push;
        oy = (oy + dy * h.t) + ny * push;
        oz = (oz + dz * h.t) + nz * push;
        dx = nd[0];
        dy = nd[1];
        dz = nd[2];
        // Russian roulette (glsl:764-769), reusing the scatter draw
        if (rr_on && b > p.rr_start) {
          const float pmax = fmaxf(fmaxf(tp[0], tp[1]), tp[2]);
          if (rand_val > pmax) break;
          const float inv_p = 1.0f / fmaxf(pmax, 1e-12f);
          tp[0] = tp[0] * inv_p;
          tp[1] = tp[1] * inv_p;
          tp[2] = tp[2] * inv_p;
        }
      }
      acc[0] = acc[0] + cr;
      acc[1] = acc[1] + cg;
      acc[2] = acc[2] + cb;
    }
  }
  color_out[3 * i] = acc[0];
  color_out[3 * i + 1] = acc[1];
  color_out[3 * i + 2] = acc[2];
  rays_out[i] = rays;
}

template <class Walk>
int launch_sample(Walk w, const float* mats, const float* lights,
                  const float* cam, const float* uv, const uint8_t* act, int n,
                  const SampleParams* params, float* color_out, int* rays_out,
                  void* stream) {
  if (n > 0) {
    sample_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        w, mats, lights, cam, uv, act, n, *params, color_out, rays_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rz_sample_params_size() { return (int)sizeof(rz::SampleParams); }

int rz_sample_wave(const float* inner, const float* leaf, int leaf_w,
                   int leaf_k, const float* mats, const float* lights,
                   const float* cam, const float* uv, const uint8_t* act,
                   int n, const rz::SampleParams* params, float* color_out,
                   int* rays_out, void* stream) {
  const rz::Bvh2Walk w{{inner, leaf, leaf_w, leaf_k}};
  return launch_sample(w, mats, lights, cam, uv, act, n, params, color_out,
                       rays_out, stream);
}

int rz_sample_wave_tiered(const float* top, const float* tre_inner,
                          const float* tre_leaf, int si, int sl, int leaf_w,
                          int leaf_k, const float* mats, const float* lights,
                          const float* cam, const float* uv,
                          const uint8_t* act, int n,
                          const rz::SampleParams* params, float* color_out,
                          int* rays_out, void* stream) {
  const rz::TieredWalk w{{top, tre_inner, tre_leaf, si, sl, leaf_w, leaf_k}};
  return launch_sample(w, mats, lights, cam, uv, act, n, params, color_out,
                       rays_out, stream);
}

}  // extern "C"
