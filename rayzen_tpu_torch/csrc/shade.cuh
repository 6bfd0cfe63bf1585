// Shading, sampling and the bounce loop shared by K1 (sample_kernel.cu) and
// the split-bounce continuation kernel (continuation_kernel.cu): the
// per-thread forms of rayzen_tpu/ops/megakernel.py's tile helpers
// (_scatter_tiles :146, _direct_lighting_tiles :362, the draws :322) and of
// its bounce body (_make_bounce_body :251), with K9, the octant-masked bounce
// walk (_octant_masked_walk :215), as a template flag of that loop. Every
// expression keeps the operation order of the JAX code and of the plain
// version in ops/megakernel.py.
#pragma once

#include "walk.cuh"

namespace rz {

// per-call constants (mirrored field for field by ext.SampleParams)
struct SampleParams {
  int32_t width, height, n_samples, max_bounces;
  int32_t rr_start, rng_hash, key, n_mats;
  int32_t n_lights;
  int32_t fuse;      // sample fusion: n_samples is a multiple of it
  int32_t b_start;   // continuation: first bounce traced
  int32_t b_stop;    // first bounce not traced: max_bounces, or the split
  float samp0;       // sample index of the first sample (progressive keyed)
  float min_vis;     // shadow visibility floor
  float shadow_eps;  // shadow-ray t_eps
  float sky_h[3];    // sky horizon colour
  float sky_d[3];    // zenith - horizon, rounded once from double like JAX's
  float ambient[3];
};

// The split-bounce continuation state: 13 (R,) float32 rows of one (13, R)
// array, one coalesced row per field (megakernel.py:706-711).
enum StateRow {
  kOx = 0, kOy, kOz, kDx, kDy, kDz, kTx, kTy, kTz, kIor, kAlive, kS0, kS1,
  kStateRows
};

struct Material {
  float ar, ag, ab, metal, rough, refl, transp, ior;
};

// megakernel._material_columns: the row of material |menc| - 1, zeros when
// that is not a material id (a miss encodes 0)
RZ_DEV Material load_material(const float* mats, int n_mats, float menc) {
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
RZ_DEV void hit_normal(const HitRec& h, float& nx, float& ny, float& nz) {
  const float sgn = h.menc < 0.0f ? -1.0f : 1.0f;
  const float nn =
      fmaxf(sqrtf((h.cx * h.cx + h.cy * h.cy) + h.cz * h.cz), 1e-20f);
  nx = h.cx / nn * sgn;
  ny = h.cy / nn * sgn;
  nz = h.cz / nn * sgn;
}

// megakernel._hemisphere (glsl:192-202)
RZ_DEV void hemisphere(float nx, float ny, float nz, float u, float v,
                       float& ox, float& oy, float& oz) {
  const float ct = sqrtf(1.0f - u);
  const float st = sqrtf(fmaxf(0.0f, 1.0f - ct * ct));
  const float phi = (2.0f * PI_REF) * v;
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
  normalize3(tx, ty, tz, 1e-20f);
  const float bx = ny * tz - nz * ty;
  const float by = nz * tx - nx * tz;
  const float bz = nx * ty - ny * tx;
  ox = (tx * lx + bx * ly) + nx * lz;
  oy = (ty * lx + by * ly) + ny * lz;
  oz = (tz * lx + bz * ly) + nz * lz;
  normalize3(ox, oy, oz, 1e-20f);
}

// megakernel._scatter_tiles (glsl:722-756): new direction, throughput factor
// and the medium's new ior
RZ_DEV void scatter(float dx, float dy, float dz, float nx, float ny,
                    float nz, float& cur_ior, float rand_val, float hemi_u,
                    float hemi_v, const Material& m, float nd[3], float f[3]) {
  const bool is_trans = m.transp > 0.0f;
  const bool entering = -dot3(dx, dy, dz, nx, ny, nz) > 0.0f;
  const float sgn = entering ? 1.0f : -1.0f;
  const float nox = nx * sgn, noy = ny * sgn, noz = nz * sgn;
  const float next_ior = entering ? m.ior : 1.0f;
  const float eta = cur_ior / next_ior;
  const float mdn = -dot3(dx, dy, dz, nox, noy, noz);
  const float cosi = clip01(mdn);
  const float q = (cur_ior - next_ior) / (cur_ior + next_ior);
  const float f0 = q * q;
  const float fresnel = f0 + (1.0f - f0) * pow5(1.0f - cosi);

  // refract_dir (glsl:558-567): normal oriented against the incident ray
  const float cosi2 = fminf(fmaxf(mdn, -1.0f), 1.0f);
  const float sint2 = fmaxf(0.0f, 1.0f - cosi2 * cosi2);
  const float kk = 1.0f - (eta * eta) * sint2;
  const bool refr_ok = kk >= 0.0f;
  const float w = eta * cosi2 - sqrtf(fmaxf(kk, 0.0f));
  float rfx = eta * dx + w * nox;
  float rfy = eta * dy + w * noy;
  float rfz = eta * dz + w * noz;
  normalize3(rfx, rfy, rfz, 1e-20f);

  const bool tir_case = is_trans && !refr_ok;
  const bool refract_case = is_trans && refr_ok;
  const bool mirror_case = !is_trans && (rand_val < m.refl);

  if (tir_case) {  // reflect about the oriented normal
    const float d_dot_no = dot3(dx, dy, dz, nox, noy, noz);
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
      f[c] = clip01((tint * m.transp) * (1.0f - fresnel));
    }
  } else if (mirror_case) {  // reflect about the geometric normal
    const float d_dot_n = dot3(dx, dy, dz, nx, ny, nz);
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

// ---- direct lighting: megakernel._direct_lighting_tiles (glsl:569-663) ----
// Per light of the row g: the shadow ray from the hit point p, then the
// light's term given its visibility, added to the accumulator ``out`` that
// light_init started. direct_lighting runs them for one ray in a loop; the
// regenerating K1 runs one light per iteration of its lane loop.

struct LightRay {
  float ldx, ldy, ldz;  // unit direction to the light
  float atten;          // attenuation before the shadow test
  float maxd;           // the shadow ray's max distance
};

RZ_DEV LightRay light_ray(const float* g, float px, float py, float pz) {
  const float g0 = __ldg(g), g1 = __ldg(g + 1), g2 = __ldg(g + 2);
  const bool is_point = __ldg(g + 3) == 1.0f;
  const float lvx = g0 - px, lvy = g1 - py, lvz = g2 - pz;
  const float dist = fmaxf(sqrtf((lvx * lvx + lvy * lvy) + lvz * lvz), 0.001f);
  const float dn = sqrtf(fmaxf((g0 * g0 + g1 * g1) + g2 * g2, 1e-40f));
  LightRay l;
  l.ldx = is_point ? lvx / dist : g0 / dn;
  l.ldy = is_point ? lvy / dist : g1 / dn;
  l.ldz = is_point ? lvz / dist : g2 / dn;
  l.atten = is_point ? __ldg(g + 7) / (dist * dist) : __ldg(g + 7);
  l.maxd = is_point ? dist : 1e30f;
  return l;
}

RZ_DEV Ray shadow_ray(const LightRay& l, float px, float py, float pz) {
  return make_ray(px + l.ldx * 0.001f, py + l.ldy * 0.001f,
                  pz + l.ldz * 0.001f, l.ldx, l.ldy, l.ldz);
}

// The accumulator before any light: the ambient term of the standard lobe,
// or 0 for a transparent material (specular-only lobe)
RZ_DEV void light_init(const SampleParams& p, const Material& m,
                       float out[3]) {
  const bool is_transparent = m.transp > 0.0f;
  const float a[3] = {m.ar, m.ag, m.ab};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[c] = is_transparent ? 0.0f : p.ambient[c] * a[c];
  }
}

// Add light g's term for the hit (normal n, view v, n_dot_v) given the
// visibility of its shadow ray
RZ_DEV void add_light(const float* g, const LightRay& l, float vis,
                      float min_vis, const Material& m, float nx, float ny,
                      float nz, float vx, float vy, float vz, float n_dot_v,
                      float out[3]) {
  const float attenuation = l.atten * vis;
  const bool lit = vis > min_vis;
  if (!lit) return;
  const float ldx = l.ldx, ldy = l.ldy, ldz = l.ldz;
  const float a[3] = {m.ar, m.ag, m.ab};
  const float n_dot_l = fmaxf(dot3(nx, ny, nz, ldx, ldy, ldz), 0.0f);
  float hx = ldx + vx, hy = ldy + vy, hz = ldz + vz;
  normalize3(hx, hy, hz, 1e-20f);
  const float n_dot_h = fmaxf(dot3(nx, ny, nz, hx, hy, hz), 0.0f);
  const float h_dot_v = fmaxf(dot3(hx, hy, hz, vx, vy, vz), 0.0f);
  const float p5 = pow5(1.0f - h_dot_v);
  const float lc[3] = {__ldg(g + 4), __ldg(g + 5), __ldg(g + 6)};

  if (m.transp > 0.0f) {
    // transparent specular-only lobe (glsl:571-609)
    const float q = (1.0f - m.ior) / (1.0f + m.ior);
    const float f0t = q * q;
    const float f_t = f0t + (1.0f - f0t) * p5;
    const float rough_t = fmaxf(m.rough, 0.02f);
    const float r2 = rough_t * rough_t;
    const float a2_t = r2 * r2;
    const float dden_t = (n_dot_h * n_dot_h) * (a2_t - 1.0f) + 1.0f;
    const float d_t = a2_t / ((PI_REF * dden_t) * dden_t + 1e-6f);
    const float k_t = ((rough_t + 1.0f) * (rough_t + 1.0f)) / 8.0f;
    const float gv_t = n_dot_v / ((n_dot_v * (1.0f - k_t) + k_t) + 1e-6f);
    const float gl_t = n_dot_l / ((n_dot_l * (1.0f - k_t) + k_t) + 1e-6f);
    const float denom_t = fmaxf((4.0f * n_dot_l) * n_dot_v, 1e-4f);
    const float spec_t = (((f_t * d_t) * gv_t) * gl_t) / denom_t;
    if (n_dot_l > 0.0f) {  // glsl:591 continue
      const float wt = (spec_t * attenuation) * n_dot_l;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c] = out[c] + wt * lc[c];
    }
  } else {
    // standard diffuse + specular (glsl:611-660)
    const float r2 = m.rough * m.rough;
    const float alpha2 = r2 * r2;
    const float dden_s = (n_dot_h * n_dot_h) * (alpha2 - 1.0f) + 1.0f;
    const float d_s = alpha2 / fmaxf((PI_REF * dden_s) * dden_s, 1e-12f);
    const float k_s = ((m.rough + 1.0f) * (m.rough + 1.0f)) / 8.0f;
    float g_s = n_dot_v / (n_dot_v * (1.0f - k_s) + k_s);
    g_s = g_s * (n_dot_l / (n_dot_l * (1.0f - k_s) + k_s));
    const float denom_s = fmaxf((4.0f * n_dot_v) * n_dot_l, 1e-4f);
    const float dg = (d_s * g_s) / denom_s;
    const float ndl_pi = n_dot_l / PI_REF;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float f0s = 0.04f * (1.0f - m.metal) + a[c] * m.metal;
      const float f_s = f0s + (1.0f - f0s) * p5;
      const float spec = f_s * dg;
      const float diffuse = ((1.0f - f_s) * a[c]) * ndl_pi;
      out[c] = out[c] + fmaxf(0.0f, ((diffuse + spec) * lc[c]) * attenuation);
    }
  }
}

// Direct lighting of one live ray, every light in turn
template <class Walk>
RZ_DEV void direct_lighting(const Walk& w, const float* lights,
                            const SampleParams& p, float px, float py,
                            float pz, float nx, float ny, float nz, float vx,
                            float vy, float vz, const Material& m,
                            float out[3]) {
  light_init(p, m, out);
  const float n_dot_v = fmaxf(dot3(nx, ny, nz, vx, vy, vz), 0.0f);
  for (int li = 0; li < p.n_lights; ++li) {
    const float* g = lights + 8 * li;
    const LightRay l = light_ray(g, px, py, pz);
    const float vis =
        w.shadow(shadow_ray(l, px, py, pz), l.maxd, p.min_vis, p.shadow_eps);
    add_light(g, l, vis, p.min_vis, m, nx, ny, nz, vx, vy, vz, n_dot_v, out);
  }
}

// per-bounce draws (rand_val, hemi_u, hemi_v): _bounce_draws_reference /
// _bounce_draws_hash
struct Sampler {
  bool hash;
  float s0, s1, samp_f;  // sin-hash seeds
  uint32_t h_pix, samp_u;  // integer-hash pixel key and sample index

  RZ_DEV void draws(int b, float& rand_val, float& hu, float& hv) const {
    if (!hash) {
      const float b_f = (float)b;
      // multiply-add fused as in ref_rand (common.cuh)
      const float ts0 = __fmaf_rn(s0 * (b_f * b_f), 12793.46f, b_f * 1423.34f);
      const float ts1 = __fmaf_rn(s1 * (b_f * b_f), 12793.46f, b_f * 1423.34f);
      rand_val = ref_rand(ts0 + samp_f, ts1 + b_f);
      hu = ref_rand(ts0, ts1);
      hv = ref_rand(ts0 + 1.0f, ts1 + 1.0f);
    } else {
      const uint32_t base = h_pix + samp_u * 7919u + (uint32_t)b * 127u;
      rand_val = u32_to_unit(hash_u32(base + 2u));
      hu = u32_to_unit(hash_u32(base + 3u));
      hv = u32_to_unit(hash_u32(base + 4u));
    }
  }
};

// The primary ray's direction for sample samp_f of the pixel at uv (u, v):
// the jitter of the sampler's flow, then raygen (glsl:204-212) through the
// inverse projection rows P and inverse view rows V. Sets the sampler's
// per-sample state.
RZ_DEV void camera_dir(const float P[8], const float V[12], float u, float v,
                       float W, float H, float samp_f, Sampler& smp,
                       float& dx, float& dy, float& dz) {
  smp.samp_f = samp_f;
  float jx, jy;
  if (!smp.hash) {
    // seed = uv * (fragX + fragY + samp + 1) (glsl:688)
    const float scale =
        ((floorf(u * W) + floorf(v * H)) + 1.0f) + (samp_f + 1.0f);
    smp.s0 = u * scale;
    smp.s1 = v * scale;
    jx = ref_rand(smp.s0, smp.s1) * 0.00002f;
    jy = ref_rand(smp.s0 + 1.0f, smp.s1 + 1.0f) * 0.00002f;
  } else {
    smp.samp_u = (uint32_t)(int32_t)samp_f;
    const uint32_t jbase = smp.h_pix + smp.samp_u * 7919u;
    jx = (u32_to_unit(hash_u32(jbase + 0u)) - 0.5f) / W;
    jy = (u32_to_unit(hash_u32(jbase + 1u)) - 0.5f) / H;
  }
  const float ndx = (u + jx) * 2.0f - 1.0f;
  const float ndy = (v + jy) * 2.0f - 1.0f;
  const float eye0 = ((P[0] * ndx + P[1] * ndy) - P[2]) + P[3];
  const float eye1 = ((P[4] * ndx + P[5] * ndy) - P[6]) + P[7];
  dx = (V[0] * eye0 + V[1] * eye1) - V[2];
  dy = (V[4] * eye0 + V[5] * eye1) - V[6];
  dz = (V[8] * eye0 + V[9] * eye1) - V[10];
  normalize3(dx, dy, dz, 0.0f);
}

// The integer-hash flow's pixel key (0 for the sin-hash flow)
RZ_DEV uint32_t pixel_key(const SampleParams& p, float u, float v) {
  if (p.rng_hash == 0) return 0u;
  const uint32_t pixel_id =
      (uint32_t)(int32_t)floorf(v * (float)p.height) *
          (uint32_t)(p.width * 2) +
      (uint32_t)(int32_t)floorf(u * (float)p.width);
  const uint32_t key_h = hash_u32((uint32_t)p.key + 0x9E3779B9u);
  return hash_u32(pixel_id ^ key_h);
}

// One ray's path between bounces: the bounce loop's carry (megakernel.py
// :263-264) and, with the sampler seeds, the 13 continuation rows.
struct Path {
  float ox, oy, oz, dx, dy, dz;
  float tp[3];  // throughput
  float ior;    // medium the ray travels in
  bool alive;
  float c[3];   // this sample's radiance so far
  int rays;     // bounce rays traced here
};

// Write the continuation rows of ray i (of n): a dead ray's o, d,
// throughput and ior are zeros, its alive 0; the seeds always.
RZ_DEV void store_state(float* st, int n, int i, const Path& p, float s0,
                        float s1) {
  const float v[kStateRows] = {
      p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, p.tp[0], p.tp[1], p.tp[2], p.ior,
      1.0f, s0, s1};
#pragma unroll
  for (int k = 0; k < kStateRows; ++k) {
    st[(size_t)k * n + i] = (p.alive || k >= kS0) ? v[k] : 0.0f;
  }
}

// K9: the closest hit as 8 octant-masked sub-walks. The TPU kernel walks its
// packet once per direction octant, masked to the rays of that octant, so
// each consensus walk serves directionally coherent rays. Per warp: for
// octant k = 0..7 the lanes whose ray lies in octant k walk together while
// the others wait, and an octant no lane holds is skipped by one vote. Each
// ray takes exactly its own K2/K8 walk, so the hits are the walk's.
// Every lane of the warp must call this (``on`` false for lanes without a
// live ray): the votes name the full warp.
template <class Walk>
RZ_DEV void octant_closest(const Walk& w, const Ray& r, bool on, HitRec& h) {
  const int oct =
      on ? (int)(r.dx > 0.0f) + 2 * (int)(r.dy > 0.0f) + 4 * (int)(r.dz > 0.0f)
         : -1;
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    if (__ballot_sync(kFullMask, oct == k) == 0u) continue;
    if (oct == k) w.closest(r, h);
  }
}

// Bounce 0 of a path whose primary ray (direction d) hit at p, normal n,
// material m: the scatter that starts its throughput (from 1), medium and
// next ray.
RZ_DEV void start_path(const Sampler& smp, float px, float py, float pz,
                       float dx, float dy, float dz, float nx, float ny,
                       float nz, const Material& m, Path& path) {
  float rand_val, hu, hv;
  smp.draws(0, rand_val, hu, hv);
  float nd[3];
  path.ior = 1.0f;
  scatter(dx, dy, dz, nx, ny, nz, path.ior, rand_val, hu, hv, m, nd, path.tp);
  const float push =
      dot3(nd[0], nd[1], nd[2], nx, ny, nz) > 0.0f ? 0.003f : -0.003f;
  path.ox = px + nx * push;
  path.oy = py + ny * push;
  path.oz = pz + nz * push;
  path.dx = nd[0];
  path.dy = nd[1];
  path.dz = nd[2];
  path.alive = true;
}

// Bounce b of a live path after its closest walk found h
// (megakernel._make_bounce_body): sky on a miss, weighted by throughput,
// else scatter and Russian roulette, reusing the scatter draw. A path that
// misses or is cut ends with alive = false.
RZ_DEV void shade_bounce(const float* mats, const SampleParams& p,
                         const Sampler& smp, int b, const HitRec& h, Path& s) {
  if (h.menc == 0.0f) {  // sky (glsl:706-709)
    const float sky_t = 0.5f * (s.dy + 1.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s.c[c] = s.c[c] + s.tp[c] * (p.sky_h[c] + p.sky_d[c] * sky_t);
    }
    s.alive = false;
    return;
  }
  float nx, ny, nz;
  hit_normal(h, nx, ny, nz);
  const Material m = load_material(mats, p.n_mats, h.menc);
  float rand_val, hu, hv;
  smp.draws(b, rand_val, hu, hv);
  float nd[3], fct[3];
  scatter(s.dx, s.dy, s.dz, nx, ny, nz, s.ior, rand_val, hu, hv, m, nd, fct);
#pragma unroll
  for (int c = 0; c < 3; ++c) s.tp[c] = s.tp[c] * fct[c];
  const float push =
      dot3(nd[0], nd[1], nd[2], nx, ny, nz) > 0.0f ? 0.003f : -0.003f;
  s.ox = (s.ox + s.dx * h.t) + nx * push;
  s.oy = (s.oy + s.dy * h.t) + ny * push;
  s.oz = (s.oz + s.dz * h.t) + nz * push;
  s.dx = nd[0];
  s.dy = nd[1];
  s.dz = nd[2];
  // Russian roulette (glsl:764-769), reusing the scatter draw
  if (p.rr_start < p.max_bounces - 1 && b > p.rr_start) {
    const float pmax = fmaxf(fmaxf(s.tp[0], s.tp[1]), s.tp[2]);
    if (rand_val > pmax) {
      s.alive = false;
      return;
    }
    const float inv_p = 1.0f / fmaxf(pmax, 1e-12f);
#pragma unroll
    for (int c = 0; c < 3; ++c) s.tp[c] = s.tp[c] * inv_p;
  }
}

// Bounces b_start..b_stop-1 of one path (the bounce loop of the lockstep K1
// and of the continuation kernel).
// kOctant: the closest walks run as K9. The loop then turns warp-uniform (it
// ends when no lane of the warp is alive), so all 32 lanes reach every vote;
// the caller keeps every lane of the warp in the kernel.
template <bool kOctant, class Walk>
RZ_DEV void trace_bounces(const Walk& w, const float* mats,
                          const SampleParams& p, const Sampler& smp,
                          int b_start, int b_stop, Path& s) {
  for (int b = b_start; b < b_stop; ++b) {
    if (kOctant ? !__any_sync(kFullMask, s.alive) : !s.alive) break;
    const Ray r = make_ray(s.ox, s.oy, s.oz, s.dx, s.dy, s.dz);
    HitRec h{T_FAR, -1, 0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (kOctant) octant_closest(w, r, s.alive, h);
    if (!s.alive) continue;
    s.rays += 1;
    if constexpr (!kOctant) w.closest(r, h);
    shade_bounce(mats, p, smp, b, h, s);
  }
}

}  // namespace rz
