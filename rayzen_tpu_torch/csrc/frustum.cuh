// K6: the packet-frustum walks as warp-cooperative device functions over the
// BVH2 tables (WorldArrays.inner_table / leaf_table).
//
// Replaces rayzen_tpu/ops/pallas_traverse.py::frustum_walk_closest (:1002)
// and ::frustum_walk_shadow (:1115) with their interval helpers (:948-999).
// The Pallas walk moves a packet of 4096 rays through the tree with scalar
// interval tests against the packet's frustum (per-axis origin and
// inverse-direction intervals); rays do work only at leaves, with no box test
// of their own. Here the packet is a warp: its active lanes' rays, the
// warp's 8 x 4 pixel tile of K1's map (common.cuh tile_pixel) in K1's K6
// forms, K4's phase 1 and, on a whole-frame wave, the standalone walks (32
// consecutive ray ids on any other wave). Every lane runs the
// same scalar node loop over one stack, so every branch below that depends
// only on node data is warp-uniform; leaves are tested per lane. Lanes that
// are out of range or inactive stay in the loop
// but are left out of the frustum and of the bounds (the Pallas packet's
// padded lanes have zero directions, which widen its frustum to everything;
// a frustum over fewer rays is still conservative for the rays it serves).
// The closest walk prunes with the packet bound t_max, the warp max of the
// lanes' t_best, refreshed after leaf work and pushes the nearer child (by
// interval entry) on top; the shadow walk stops when the warp's max
// visibility drops to min_vis after leaf work, so a lane that is already at
// or below it may keep losing visibility until then, as in the Pallas walk.
// The float reductions are __shfl_xor_sync butterflies (there is no
// __reduce_min_sync for float); min and max are exact, so every lane gets the
// bits the plain version (ops/walk.py) computes.
//
// Every lane of the warp must call these (``on`` false for a lane without a
// ray): the shuffles name the full warp.
//
// The packet's stack is warp-uniform: one copy per warp in shared memory
// (SharedStack), which frees the 32 copies of a per-lane stack (256 B of
// local memory a lane) under the kernels' 64-register budget.
//
// What bounds it on an H100: the same dependent loads as the BVH2 walk, but
// one node sequence per warp instead of 32 divergent ones, and per node two
// interval box tests (done redundantly by every lane); leaves cost a
// triangle test per lane for every leaf the frustum reaches, which for
// coherent primary rays is about the leaves their own boxes would pass.
#pragma once

#include "walk.cuh"

namespace rz {

RZ_DEV float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

RZ_DEV float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// the packet's per-axis origin intervals and inverse-direction intervals
struct Frustum {
  float olo[3], ohi[3], ilo[3], ihi[3];
};

// _interval_inv: [1/d] for d in [dlo, dhi]; spanning 0 -> (-1e30, 1e30)
RZ_DEV void interval_inv(float dlo, float dhi, float& lo, float& hi) {
  if (dlo > 0.0f) {
    lo = 1.0f / dhi;
    hi = 1.0f / dlo;
  } else if (dhi < 0.0f) {
    lo = 1.0f / dlo;
    hi = 1.0f / dhi;
  } else {
    lo = -1e30f;
    hi = 1e30f;
  }
}

// _interval_mul
RZ_DEV void interval_mul(float alo, float ahi, float blo, float bhi,
                         float& lo, float& hi) {
  const float p1 = alo * blo, p2 = alo * bhi, p3 = ahi * blo, p4 = ahi * bhi;
  lo = fminf(fminf(p1, p2), fminf(p3, p4));
  hi = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
}

// _packet_frustum over the warp's active lanes; false when there is none
RZ_DEV bool packet_frustum(const Ray& r, bool on, Frustum& f) {
  if (__ballot_sync(kFullMask, on) == 0u) return false;
  const float o[3] = {r.ox, r.oy, r.oz}, d[3] = {r.dx, r.dy, r.dz};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    f.olo[ax] = warp_min(on ? o[ax] : INFINITY);
    f.ohi[ax] = warp_max(on ? o[ax] : -INFINITY);
    interval_inv(warp_min(on ? d[ax] : INFINITY),
                 warp_max(on ? d[ax] : -INFINITY), f.ilo[ax], f.ihi[ax]);
  }
  return true;
}

// _frustum_box_test (with _frustum_slab_axis) of box b = [bmin(3) bmax(3)]
RZ_DEV bool frustum_box(const Frustum& f, const float* b, float t_bound,
                        float& entry_lo) {
  float entry = -3.4e38f, exit_hi = 3.4e38f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float t0lo, t0hi, t1lo, t1hi;
    interval_mul(b[ax] - f.ohi[ax], b[ax] - f.olo[ax], f.ilo[ax], f.ihi[ax],
                 t0lo, t0hi);
    interval_mul(b[3 + ax] - f.ohi[ax], b[3 + ax] - f.olo[ax], f.ilo[ax],
                 f.ihi[ax], t1lo, t1hi);
    entry = fmaxf(entry, fminf(t0lo, t1lo));
    exit_hi = fminf(exit_hi, fmaxf(t0hi, t1hi));
  }
  entry_lo = entry;
  return exit_hi >= fmaxf(entry, 0.0f) && entry <= t_bound;
}

// The packet stack, one copy per warp in shared memory (STACK_DEPTH ints):
// get(k) reads entry k and set(k, v) writes it; every lane calls both with
// the same k and v (the walk's control flow is warp-uniform), so a lane
// reads its own writes. sync() comes between a step's pop and its pushes: it
// keeps one lane's pushes from overwriting an entry before another lane has
// popped it.
struct SharedStack {
  int* s;
  RZ_DEV int get(int k) const { return s[k]; }
  RZ_DEV void set(int k, int v) { s[k] = v; }
  RZ_DEV void sync() const { __syncwarp(); }
};

// K6 closest hit from T_FAR (h enters as the no-hit state) on the packet
// stack ``stack``, counting its steps with ``cnt``. On stack overflow every
// lane's t and menc become NaN.
template <class Stack, class Count = NoCount>
RZ_DEV void frustum_walk_closest(const Tables& tb, const Ray& r, bool on,
                                 HitRec& h, Stack& stack,
                                 const Count& cnt = Count{}) {
  Frustum f;
  if (!packet_frustum(r, on, f)) return;
  stack.set(0, 0);
  int sp = 1;
  float t_max = T_FAR;
  while (sp > 0) {  // warp-uniform
    cnt.packet(on);
    const int node = stack.get(--sp);
    float row[16];
    load_inner(tb.inner, node, row);
    float tl, tr;
    const bool ok_l = frustum_box(f, row, t_max, tl);
    const bool ok_r = frustum_box(f, row + 6, t_max, tr);
    const int lref = (int)row[12], rref = (int)row[13];
    const bool l_leaf = row[14] >= 0.0f, r_leaf = row[15] >= 0.0f;
    const bool hl = ok_l && l_leaf, hr = ok_r && r_leaf;
    if (hl && on) leaf_closest(tb, lref, r, h);
    if (hr && on) leaf_closest(tb, rref, r, h);
    if (hl || hr) t_max = warp_max(on ? h.t : -INFINITY);
    // the hit internal children, the nearer entry (by interval entry) on top
    const bool push_l = ok_l && !l_leaf, push_r = ok_r && !r_leaf;
    const int npush = (int)push_l + (int)push_r;
    if (sp + npush > STACK_DEPTH) {  // never write past the stack
      h.t = nan_f();
      h.menc = nan_f();
      return;
    }
    stack.sync();
    if (push_l && push_r) {
      const bool near_left = tl <= tr;
      stack.set(sp, near_left ? rref : lref);
      stack.set(sp + 1, near_left ? lref : rref);
    } else if (npush == 1) {
      stack.set(sp, push_l ? lref : rref);
    }
    sp += npush;
  }
}

// K6 transmission visibility (walk_shadow's contract for the lanes that are
// on; 1 for the others) on the packet stack ``stack``, counting its steps
// with ``cnt``. NaN on stack overflow.
template <class Stack, class Count = NoCount>
RZ_DEV float frustum_walk_shadow(const Tables& tb, const Ray& r, bool on,
                                 float maxd, float min_vis, float t_eps,
                                 Stack& stack, const Count& cnt = Count{}) {
  float vis = 1.0f;
  Frustum f;
  if (!packet_frustum(r, on, f)) return vis;
  const float maxd_hi = warp_max(on ? maxd : 0.0f);
  stack.set(0, 0);
  int sp = 1;
  float alive = 1.0f;  // the warp's max visibility after the last leaf work
  while (sp > 0) {  // warp-uniform
    cnt.packet(on);
    const int node = stack.get(--sp);
    float row[16];
    load_inner(tb.inner, node, row);
    float e;
    const bool ok_l = frustum_box(f, row, maxd_hi, e);
    const bool ok_r = frustum_box(f, row + 6, maxd_hi, e);
    const int lref = (int)row[12], rref = (int)row[13];
    const bool l_leaf = row[14] >= 0.0f, r_leaf = row[15] >= 0.0f;
    const bool hl = ok_l && l_leaf, hr = ok_r && r_leaf;
    if (hl && on) vis = leaf_shadow(tb, lref, r, maxd, t_eps, vis);
    if (hr && on) vis = leaf_shadow(tb, rref, r, maxd, t_eps, vis);
    if (hl || hr) alive = warp_max(on ? vis : 0.0f);
    if (!(alive > min_vis)) return vis;
    // the hit internal children, the left on top
    const bool push_l = ok_l && !l_leaf, push_r = ok_r && !r_leaf;
    const int npush = (int)push_l + (int)push_r;
    if (sp + npush > STACK_DEPTH) return nan_f();  // never write past the stack
    stack.sync();
    if (push_r) stack.set(sp++, rref);
    if (push_l) stack.set(sp++, lref);
  }
  return vis;
}

}  // namespace rz
