// Per-thread BVH2 walks over WorldArrays.inner_table / leaf_table: the device
// functions behind K2 (closest hit) and K3 (shadow transmission), the
// tiered walks of K8 over top_table / tre_inner / tre_leaf, the wide
// walks of K5 over inner8_table / leaf8_table, and the stackless miss-link
// walks of K7 over ml_nodes / ml_tris (standalone kernels only), shared by
// the standalone kernels (walk_kernels.cu) and the sample kernel
// (sample_kernel.cu) through the walk policies at the end of this file. (K6,
// the warp-packet frustum walk, is in frustum.cuh.)
//
// Replaces rayzen_tpu/ops/pallas_traverse.py::bvh2_walk_closest (:243) and
// ::bvh2_walk_shadow (:454), single-pop form, and ::tiered_walk_closest
// (:796) / ::tiered_walk_shadow (:879). The Pallas walks move a packet
// of 4096 rays with one scalar node pointer and push a child when any ray of
// the packet hits it, left child on top. A ray only acts on a node whose box
// it hits itself, so the nodes it processes are exactly its own depth-first,
// left-first walk with the same t pruning; this thread-per-ray walk keeps
// that order, and so finds the same closest triangle and t (ties included)
// and multiplies the same transparencies in the same order.
//
// What bounds it on an H100: the demo scene's tables are ~0.5 MB and stay in
// L2 (the field's 37 MB fill most of it), so a walk is bound by the latency
// of its dependent loads (pop -> inner row -> leaf row) and by the share of
// a warp's lanes that take each step, not by bandwidth. The design keeps
// every ray's state in registers, reads an inner row as four 16-byte loads
// through the read-only path, and keeps the stack in (L1-cached) local
// memory. Each tree layout has one walk template over a mode (WalkMode):
// the closest walk, the shadow walk, or either per lane, with which the
// regenerating K1 (sample_kernel.cu) runs a warp's closest and shadow rays
// through one node loop; its warp tiles, path regeneration and register
// budget are where the latency is hidden and the lanes kept busy.
// Near-first ordering, compressed nodes, shared-memory stacks and node
// caches are left for later work.
#pragma once

#include "common.cuh"

namespace rz {

struct Tables {
  const float* inner;  // (Ni, 16)
  const float* leaf;   // (L, leaf_w)
  int leaf_w;
  int leaf_k;
};

// The tiered view: a top tree in inner-table layout whose child count -2
// names a treelet, and per treelet a fixed block of si inner rows
// (treelet-local refs) and sl leaf rows (copies of leaf-table rows).
struct TieredTables {
  const float* top;        // (Nt, 16)
  const float* tre_inner;  // (Tt, si, 16)
  const float* tre_leaf;   // (Tt, sl, leaf_w)
  int si, sl;
  int leaf_w;
  int leaf_k;

  // treelet tid as an ordinary BVH2 tree (its root is its row 0)
  RZ_DEV Tables treelet(int tid) const {
    return Tables{tre_inner + (size_t)tid * si * 16,
                  tre_leaf + (size_t)tid * sl * leaf_w, leaf_w, leaf_k};
  }
};

struct HitRec {
  float t;      // closest t (t_init / T_FAR when nothing is hit)
  int tri;      // world triangle id, -1 = none
  float cx, cy, cz;  // unnormalized cross(e1, e2) of the winning triangle
  float menc;   // (material + 1) * orientation, 0 = none
};

RZ_DEV void load_inner(const float* inner, int node, float row[16]) {
  const float4* p = reinterpret_cast<const float4*>(inner + (size_t)node * 16);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float4 v = __ldg(p + q);
    row[4 * q + 0] = v.x;
    row[4 * q + 1] = v.y;
    row[4 * q + 2] = v.z;
    row[4 * q + 3] = v.w;
  }
}

// bvh2_walk_closest.leaf_proc for one ray
RZ_DEV void leaf_closest(const Tables& tb, int leaf_idx, const Ray& r,
                         HitRec& h) {
  const float* row = tb.leaf + (size_t)leaf_idx * tb.leaf_w;
  const int K = tb.leaf_k;
  const int first = (int)__ldg(row + 10 * K);
  const int count = (int)__ldg(row + 10 * K + 1);
  const int n = count < K ? count : K;
  for (int k = 0; k < n; ++k) {
    const float* tri = row + 9 * k;
    float t;
    if (moller_trumbore(r, tri, t) && t < h.t) {
      float e1x = __ldg(tri + 3), e1y = __ldg(tri + 4), e1z = __ldg(tri + 5);
      float e2x = __ldg(tri + 6), e2y = __ldg(tri + 7), e2z = __ldg(tri + 8);
      h.t = t;
      h.tri = first + k;
      h.cx = e1y * e2z - e1z * e2y;
      h.cy = e1z * e2x - e1x * e2z;
      h.cz = e1x * e2y - e1y * e2x;
      h.menc = __ldg(row + 10 * K + 2 + k);
    }
  }
}

// bvh2_walk_shadow.leaf_proc for one ray
RZ_DEV float leaf_shadow(const Tables& tb, int leaf_idx, const Ray& r,
                         float maxd, float t_eps, float vis) {
  const float* row = tb.leaf + (size_t)leaf_idx * tb.leaf_w;
  const int K = tb.leaf_k;
  const int count = (int)__ldg(row + 10 * K + 1);
  const int n = count < K ? count : K;
  for (int k = 0; k < n; ++k) {
    float t;
    if (moller_trumbore(r, row + 9 * k, t) && t >= t_eps && t < maxd) {
      vis = vis * __ldg(row + 9 * K + k);  // transparency; 0 = opaque
    }
  }
  return vis;
}

// Push the hit internal children, left on top: it is popped (walked) first.
// Returns false, pushing nothing, when they do not fit the stack.
RZ_DEV bool push_children(int* stack, int& sp, bool push_l, bool push_r,
                          int lref, int rref) {
  const int npush = (int)push_l + (int)push_r;
  if (sp + npush > STACK_DEPTH) return false;  // never write past the stack
  if (push_l && push_r) {
    stack[sp] = rref;
    stack[sp + 1] = lref;
  } else if (push_l) {
    stack[sp] = lref;
  } else if (push_r) {
    stack[sp] = rref;
  }
  sp += npush;
  return true;
}

// What a walk computes. kClosest: the closest hit (K2, K8, K5); kShadow: the
// transmission visibility (K3 and its kin); kEither: either, chosen per lane
// by its ``shadow_lane`` flag, so that a warp whose lanes hold both kinds of ray
// runs them through one node loop (the regenerating K1, sample_kernel.cu).
// A walk's state is a HitRec and a visibility: h.t is the pruning bound, the
// best t so far for a closest ray and maxd (fixed) for a shadow ray; vis is
// the shadow ray's visibility. The three modes run the same slab tests and
// stack in the same order, so each ray processes the same nodes and gets the
// same result bit for bit in any mode.
enum WalkMode { kClosest, kShadow, kEither };

// Walk-loop step counters: NoCount for every kernel but the counting forms
// of K1, the continuation and the standalone walks, which count with
// LaneCount: step() at a step of a per-lane walk, packet(on) at a step of
// K6's packet walk (frustum.cuh).
struct NoCount {
  RZ_DEV void step() const {}
  RZ_DEV void packet(bool) const {}
};

// The walk-loop lane counter: at every step of a walk's node loop the
// lowest active lane of the warp adds the active lanes and 32 to one of
// kCountSlots pairs of 64-bit sums (spread over slots by warp, so that the
// atomics do not queue on one address). active / slots over a launch is the
// walk loop's lane utilisation. In a step of K6's packet walk every lane of
// the warp takes the step, and the lanes with a ray in the packet count as
// active. Each source file has its own sums (no relocatable device code),
// read by its own entry point through read_walk_lanes: all three have
// internal linkage.
namespace {
constexpr int kCountSlots = 1024;
__device__ unsigned long long g_walk_lanes[2 * kCountSlots];

struct LaneCount {
  RZ_DEV void add(unsigned active) const {
    const unsigned slot =
        (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) % kCountSlots;
    atomicAdd(&g_walk_lanes[2 * slot], (unsigned long long)active);
    atomicAdd(&g_walk_lanes[2 * slot + 1], 32ull);
  }
  RZ_DEV void step() const {
    const unsigned m = __activemask();
    if ((int)(threadIdx.x & 31) == __ffs(m) - 1) add(__popc(m));
  }
  RZ_DEV void packet(bool on) const {
    const unsigned m = __ballot_sync(kFullMask, on);
    if ((threadIdx.x & 31) == 0) add(__popc(m));
  }
};

// out[0] = active lane-steps, out[1] = warp-steps x 32 over this source
// file's counting launches since the last reset (synchronises the device);
// reset != 0 then zeroes the sums.
inline int read_walk_lanes(unsigned long long* out, int reset) {
  static unsigned long long h[2 * kCountSlots];
  cudaError_t e = cudaMemcpyFromSymbol(h, g_walk_lanes, sizeof(h));
  out[0] = out[1] = 0;
  for (int k = 0; k < kCountSlots; ++k) {
    out[0] += h[2 * k];
    out[1] += h[2 * k + 1];
  }
  if (e == cudaSuccess && reset) {
    static const unsigned long long zeros[2 * kCountSlots] = {};
    e = cudaMemcpyToSymbol(g_walk_lanes, zeros, sizeof(zeros));
  }
  return static_cast<int>(e);
}
}  // namespace

// The closest or shadow leaf procedure, per lane: bvh2_walk_closest's and
// bvh2_walk_shadow's leaf_proc in one triangle loop.
RZ_DEV void leaf_either(const Tables& tb, int leaf_idx, const Ray& r,
                        bool shadow, float t_eps, HitRec& h, float& vis) {
  const float* row = tb.leaf + (size_t)leaf_idx * tb.leaf_w;
  const int K = tb.leaf_k;
  const int first = (int)__ldg(row + 10 * K);
  const int count = (int)__ldg(row + 10 * K + 1);
  const int n = count < K ? count : K;
  for (int k = 0; k < n; ++k) {
    const float* tri = row + 9 * k;
    float t;
    if (!moller_trumbore(r, tri, t)) continue;
    if (shadow) {
      if (t >= t_eps && t < h.t) vis = vis * __ldg(row + 9 * K + k);
    } else if (t < h.t) {
      float e1x = __ldg(tri + 3), e1y = __ldg(tri + 4), e1z = __ldg(tri + 5);
      float e2x = __ldg(tri + 6), e2y = __ldg(tri + 7), e2z = __ldg(tri + 8);
      h.t = t;
      h.tri = first + k;
      h.cx = e1y * e2z - e1z * e2y;
      h.cy = e1z * e2x - e1x * e2z;
      h.cz = e1x * e2y - e1y * e2x;
      h.menc = __ldg(row + 10 * K + 2 + k);
    }
  }
}

template <int kMode>
RZ_DEV void leaf_walk(const Tables& tb, int leaf_idx, const Ray& r,
                      bool shadow, float t_eps, HitRec& h, float& vis) {
  if constexpr (kMode == kClosest) {
    leaf_closest(tb, leaf_idx, r, h);
  } else if constexpr (kMode == kShadow) {
    vis = leaf_shadow(tb, leaf_idx, r, h.t, t_eps, vis);
  } else {
    leaf_either(tb, leaf_idx, r, shadow, t_eps, h, vis);
  }
}

// A ray's result past a stack overflow: NaN in every mode.
RZ_DEV void poison(HitRec& h, float& vis) {
  h.t = nan_f();
  h.menc = nan_f();
  vis = nan_f();
}

// The BVH2 walk in mode kMode (``shadow_lane`` picks the mode per lane
// under kEither). Closest: ``h`` enters as the state to continue from, h.t the
// initial bound (t_init, T_FAR, or the best hit of an earlier treelet); hits
// at or beyond it are ignored. Shadow: h.t = maxd; vis enters as vis_init (1,
// or what earlier treelets left), multiplies the transparencies of the
// triangles hit within (t_eps, maxd), 0 past an opaque one, and the walk
// stops once vis <= min_vis (shadowVisibility, glsl:507-528).
template <int kMode, class Count>
RZ_DEV void walk_bvh2(const Tables& tb, const Ray& r, bool shadow_lane,
                      float min_vis, float t_eps, HitRec& h, float& vis,
                      const Count& cnt) {
  const bool shadow = kMode == kShadow || (kMode == kEither && shadow_lane);
  if (shadow && !(vis > min_vis)) return;
  int stack[STACK_DEPTH];
  stack[0] = 0;  // root inner node
  int sp = 1;
  while (sp > 0) {
    cnt.step();
    const int node = stack[--sp];
    float row[16];
    load_inner(tb.inner, node, row);
    float tminl, tminr;
    const bool hitl = slab(r, row, tminl) && (tminl <= h.t);
    const bool hitr = slab(r, row + 6, tminr) && (tminr <= h.t);
    const int lref = (int)row[12], rref = (int)row[13];
    const int lcnt = (int)row[14], rcnt = (int)row[15];
    // a shadow ray tests both leaf children with the liveness of the node's
    // start, as the packet walk does, before the early exit
    if (hitl && lcnt >= 0) leaf_walk<kMode>(tb, lref, r, shadow, t_eps, h, vis);
    if (hitr && rcnt >= 0) leaf_walk<kMode>(tb, rref, r, shadow, t_eps, h, vis);
    if (shadow && !(vis > min_vis)) return;
    if (!push_children(stack, sp, hitl && lcnt < 0, hitr && rcnt < 0, lref,
                       rref)) {
      poison(h, vis);
      return;
    }
  }
}

// Closest hit (K2) from the state ``h``. On stack overflow t and menc become
// NaN.
RZ_DEV void walk_closest(const Tables& tb, const Ray& r, HitRec& h) {
  float vis = 1.0f;
  walk_bvh2<kClosest>(tb, r, false, 0.0f, 0.0f, h, vis, NoCount{});
}

// Transmission visibility (K3) along the ray within (t_eps, maxd), times
// ``vis``. NaN on stack overflow.
RZ_DEV float walk_shadow(const Tables& tb, const Ray& r, float maxd,
                         float min_vis, float t_eps, float vis = 1.0f) {
  HitRec h{maxd, -1, 0.0f, 0.0f, 0.0f, 0.0f};
  walk_bvh2<kShadow>(tb, r, true, min_vis, t_eps, h, vis, NoCount{});
  return vis;
}

// K8 over the tiered view, in mode kMode: one node loop over both levels.
// The packet walk (pallas_traverse.py:836-871, :910), per popped top node,
// tests both children's boxes against the bound (the best t so far, or
// maxd), walks the hit left treelet, then the hit right one (each from the
// state so far), and only then goes on with the hit internal children, left
// first. So a closest ray processes its depth-first walk of the whole tree
// with the same pruning and finds the whole-tree walk's hit (ties included);
// a shadow ray multiplies the treelets' transparencies in the whole-tree
// walk's order and returns as soon as vis drops to min_vis, which gives the
// packet walk's product (it tests a top node's boxes only for rays still
// above min_vis and walks the right treelet with what the left one left).
//
// Here both levels share one stack of tagged entries (kTreeletNode) and one
// step per iteration. A top pop tests both boxes and pushes, as the
// decisions of that moment, the hit internal children (left on top, as
// push_children), then the right treelet's root, then the left treelet's
// root on top; a treelet pop is walk_bvh2's step on the treelet's rows.
// Every entry of a treelet lies above the roots still pending, so the
// treelet a local entry belongs to is the one whose root was popped last
// (``tid``). Each ray so takes exactly the steps of the nested walk (a
// treelet walked inside its top node's step, pallas_traverse.py's order) in
// the same order, and a warp whose lanes stand at different levels no longer
// runs a treelet loop while the top-level lanes wait. The stack holds
// kTieredStack entries; the most a walk needs is the top depth plus the
// treelet depth (ops/walk.py check_tiered), which the host checks.
// Measured against the nested walk (PERF.md §6): the tiered K1's walk-loop
// lane utilisation 0.43 -> 0.76 on the field, its time 3% lower, K8 alone
// 10% lower; 80 or 118 registers (RZ_K1_MIN_BLOCKS 6 or 4) lost to 64.
constexpr int kTieredStack = 2 * STACK_DEPTH;

// A stack entry is a top node (0 <= e < kTreeletNode), a node of the
// current treelet (kTreeletNode + its local row) or a treelet's root (~tid).
constexpr int kTreeletNode = 1 << 30;

template <int kMode, class Count>
RZ_DEV void walk_tiered(const TieredTables& tt, const Ray& r,
                        bool shadow_lane, float min_vis, float t_eps,
                        HitRec& h, float& vis, const Count& cnt) {
  const bool shadow = kMode == kShadow || (kMode == kEither && shadow_lane);
  if (shadow && !(vis > min_vis)) return;
  int stack[kTieredStack];
  stack[0] = 0;  // the top tree's root
  int sp = 1;
  int tid = 0;  // the treelet of the local entries on the stack
  while (sp > 0) {
    cnt.step();
    int e = stack[--sp];
    const bool in_treelet = e < 0 || e >= kTreeletNode;
    if (e < 0) {  // a treelet's root: its row 0
      tid = ~e;
      e = 0;
    } else if (e >= kTreeletNode) {
      e -= kTreeletNode;
    }
    float row[16];
    load_inner(in_treelet ? tt.tre_inner + (size_t)tid * tt.si * 16 : tt.top, e,
               row);
    float tminl, tminr;
    const bool hitl = slab(r, row, tminl) && (tminl <= h.t);
    const bool hitr = slab(r, row + 6, tminr) && (tminr <= h.t);
    const int lref = (int)row[12], rref = (int)row[13];
    const int lcnt = (int)row[14], rcnt = (int)row[15];
    if (in_treelet) {  // walk_bvh2's leaf work and early exit
      const Tables tb = tt.treelet(tid);
      if (hitl && lcnt >= 0) leaf_walk<kMode>(tb, lref, r, shadow, t_eps, h, vis);
      if (hitr && rcnt >= 0) leaf_walk<kMode>(tb, rref, r, shadow, t_eps, h, vis);
      if (shadow && !(vis > min_vis)) return;
    }
    // the pushes, bottom to top: right internal, left internal, right
    // treelet root, left treelet root (a treelet row has count -1 or a leaf)
    const int tag = in_treelet ? kTreeletNode : 0;
    const bool push_ri = hitr && rcnt == -1, push_li = hitl && lcnt == -1;
    const bool push_rt = hitr && rcnt == -2, push_lt = hitl && lcnt == -2;
    if (sp + (int)push_ri + (int)push_li + (int)push_rt + (int)push_lt >
        kTieredStack) {  // never write past the stack
      poison(h, vis);
      return;
    }
    if (push_ri) stack[sp++] = rref + tag;
    if (push_li) stack[sp++] = lref + tag;
    if (push_rt) stack[sp++] = ~rref;
    if (push_lt) stack[sp++] = ~lref;
  }
}

RZ_DEV void walk_closest_tiered(const TieredTables& tt, const Ray& r,
                                HitRec& h) {
  float vis = 1.0f;
  walk_tiered<kClosest>(tt, r, false, 0.0f, 0.0f, h, vis, NoCount{});
}

RZ_DEV float walk_shadow_tiered(const TieredTables& tt, const Ray& r,
                                float maxd, float min_vis, float t_eps) {
  HitRec h{maxd, -1, 0.0f, 0.0f, 0.0f, 0.0f};
  float vis = 1.0f;
  walk_tiered<kShadow>(tt, r, true, min_vis, t_eps, h, vis, NoCount{});
  return vis;
}

// ---- K5: the wide-node (BVH8) walks ----
//
// Replaces pallas_traverse.py::bvh8_walk_closest (:617), ::bvh8_walk_shadow
// (:728) and ::_wide_consensus (:597). A wide row (72 floats, 18 float4s)
// holds 8 child boxes, 8 refs, 8 counts, leaf_start and leaf_n; slot ch is a
// leaf child when ch < leaf_n (leaf8 row leaf_start + ch), internal when its
// count is -1, padding otherwise. A padding slot's inverted box passes the
// slab test, so padding is never tested: it is neither hit nor a leaf.
//
// Per popped node, as the packet walk: all 8 boxes against the bound of the
// node's start (t_best, or maxd), then the hit leaf children, then the
// pushes. The packet walk tests all of a node's leaf rows under the union of
// the leaf children its rays hit; this walk tests only the rows of the leaf
// children this ray hit, in slot order (= row order), so a ray tests exactly
// the leaves whose boxes it hits, as the BVH2 walk does, and finds its t.
// The closest walk pushes the hit internal children sorted by the ray's own
// entry distance with the packet walk's 19-comparator descending network
// (there the sort key is the packet's consensus minimum), so the nearest is
// popped first; the shadow walk pushes them in slot order and stops when
// vis drops to min_vis after a node's leaf work. A pop pushes up to 8, so the
// host checks the wide tree's exact need (WorldArrays.wide_stack) and the
// walks NaN-poison a result whose stack would overflow.
//
// What bounds it on an H100: as the BVH2 walk, latency and divergence, with
// a 4-level tree for the demo scene (13 BVH2 levels) but 8 slab tests and
// 18 dependent-free 16-byte loads per node.

constexpr int kInner8W = 72;  // inner8_table row width (66 used)

struct Tables8 {
  const float* inner8;  // (N8, 72)
  const float* leaf8;   // (L8, leaf_w): leaf rows, contiguous per wide node
  int leaf_w;
  int leaf_k;

  RZ_DEV Tables leaves() const { return Tables{nullptr, leaf8, leaf_w, leaf_k}; }
};

// One wide node against one ray: each real slot's box against ``bound``.
// Out: tmin per slot, refs, the hit leaf children and the hit internal
// children as slot bit masks, and the node's first leaf row.
RZ_DEV void wide_node(const float* inner8, int node, const Ray& r, float bound,
                      float tmin[8], int ref[8], unsigned& leaf_hits,
                      unsigned& push, int& leaf_start) {
  const float4* p =
      reinterpret_cast<const float4*>(inner8 + (size_t)node * kInner8W);
  const float4 r0 = __ldg(p + 12), r1 = __ldg(p + 13);
  const float4 c0 = __ldg(p + 14), c1 = __ldg(p + 15);
  const float4 ln = __ldg(p + 16);
  const float refs[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
  const float cnt[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  leaf_start = (int)ln.x;
  const int leaf_n = (int)ln.y;
  leaf_hits = 0u;
  push = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // slots 2k, 2k + 1: floats 12k .. 12k + 11
    const float4 a = __ldg(p + 3 * k), b = __ldg(p + 3 * k + 1),
                 c = __ldg(p + 3 * k + 2);
    const float box[2][6] = {{a.x, a.y, a.z, a.w, b.x, b.y},
                             {b.z, b.w, c.x, c.y, c.z, c.w}};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 2 * k + e;
      ref[ch] = (int)refs[ch];
      tmin[ch] = 0.0f;
      const bool is_leaf = ch < leaf_n, internal = cnt[ch] < 0.0f;
      if ((is_leaf || internal) && slab(r, box[e], tmin[ch]) &&
          tmin[ch] <= bound) {
        if (is_leaf) leaf_hits |= 1u << ch;
        if (internal) push |= 1u << ch;
      }
    }
  }
}

// compare-exchange of the push sort: the larger key first
RZ_DEV void cswap8(float* key, int* ref, bool* on, int i, int j) {
  if (key[i] < key[j]) {
    const float k = key[i];
    key[i] = key[j];
    key[j] = k;
    const int f = ref[i];
    ref[i] = ref[j];
    ref[j] = f;
    const bool o = on[i];
    on[i] = on[j];
    on[j] = o;
  }
}

// Push the slots of ``push``: ``ordered`` sorted by entry distance (the
// nearest on top), else in slot order (the last slot on top). Returns
// false, pushing nothing, when they do not fit the stack.
RZ_DEV bool push_wide(int* stack, int& sp, unsigned push, const float tmin[8],
                      const int ref[8], bool ordered) {
  const int npush = __popc(push);
  if (sp + npush > STACK_DEPTH) return false;  // never write past the stack
  if (!ordered || npush < 2) {
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) {
      if (push & (1u << ch)) stack[sp++] = ref[ch];
    }
    return true;
  }
  float key[8];
  int rf[8];
  bool on[8];
#pragma unroll
  for (int ch = 0; ch < 8; ++ch) {
    on[ch] = (push >> ch) & 1u;
    key[ch] = on[ch] ? tmin[ch] : -INFINITY;
    rf[ch] = ref[ch];
  }
  // pallas_traverse.py:681-683 (ops/walk.py SORT8)
  cswap8(key, rf, on, 0, 1); cswap8(key, rf, on, 2, 3);
  cswap8(key, rf, on, 4, 5); cswap8(key, rf, on, 6, 7);
  cswap8(key, rf, on, 0, 2); cswap8(key, rf, on, 1, 3);
  cswap8(key, rf, on, 4, 6); cswap8(key, rf, on, 5, 7);
  cswap8(key, rf, on, 1, 2); cswap8(key, rf, on, 5, 6);
  cswap8(key, rf, on, 0, 4); cswap8(key, rf, on, 3, 7);
  cswap8(key, rf, on, 1, 5); cswap8(key, rf, on, 2, 6);
  cswap8(key, rf, on, 1, 4); cswap8(key, rf, on, 3, 6);
  cswap8(key, rf, on, 2, 4); cswap8(key, rf, on, 3, 5);
  cswap8(key, rf, on, 3, 4);
#pragma unroll
  for (int ch = 0; ch < 8; ++ch) {
    if (on[ch]) stack[sp++] = rf[ch];
  }
  return true;
}

// K5 in mode kMode (walk_bvh2's contract; a closest ray from T_FAR). Per
// popped node all 8 boxes against the bound of the node's start, then the
// hit leaf children in slot order, then the pushes: a closest ray's sorted by
// its entry distance, a shadow ray's in slot order after the early exit.
template <int kMode, class Count>
RZ_DEV void walk_bvh8(const Tables8& tb, const Ray& r, bool shadow_lane,
                      float min_vis, float t_eps, HitRec& h, float& vis,
                      const Count& cnt) {
  const bool shadow = kMode == kShadow || (kMode == kEither && shadow_lane);
  if (shadow && !(vis > min_vis)) return;
  const Tables lt = tb.leaves();
  int stack[STACK_DEPTH];
  stack[0] = 0;  // root wide node
  int sp = 1;
  while (sp > 0) {
    cnt.step();
    const int node = stack[--sp];
    float tmin[8];
    int ref[8];
    unsigned leaf_hits, push;
    int leaf_start;
    wide_node(tb.inner8, node, r, h.t, tmin, ref, leaf_hits, push, leaf_start);
    for (unsigned m = leaf_hits; m; m &= m - 1) {  // slot order
      leaf_walk<kMode>(lt, leaf_start + __ffs(m) - 1, r, shadow, t_eps, h, vis);
    }
    if (shadow && !(vis > min_vis)) return;
    if (!push_wide(stack, sp, push, tmin, ref, !shadow)) {
      poison(h, vis);
      return;
    }
  }
}

// K5 closest hit from T_FAR (h enters as the no-hit state). On stack
// overflow t and menc become NaN.
RZ_DEV void walk_closest_bvh8(const Tables8& tb, const Ray& r, HitRec& h) {
  float vis = 1.0f;
  walk_bvh8<kClosest>(tb, r, false, 0.0f, 0.0f, h, vis, NoCount{});
}

// K5 transmission visibility (walk_shadow's contract). NaN on overflow.
RZ_DEV float walk_shadow_bvh8(const Tables8& tb, const Ray& r, float maxd,
                              float min_vis, float t_eps) {
  HitRec h{maxd, -1, 0.0f, 0.0f, 0.0f, 0.0f};
  float vis = 1.0f;
  walk_bvh8<kShadow>(tb, r, true, min_vis, t_eps, h, vis, NoCount{});
  return vis;
}

// ---- K7: the stackless miss-link walks ----
//
// Replaces pallas_traverse.py::_make_closest_kernel (:128) and
// ::_make_shadow_kernel (:189). The unified tree (TLAS and BLAS copies
// stitched, packing._build_unified) is walked in pre-order: the packet
// kernel moves 4096 rays with one scalar node pointer; at node cur each ray
// tests the node's own box (hit = box & active & tmin <= its bound); if any
// ray hits an internal node the packet goes to its left child, otherwise
// (and after a leaf) to the node's miss link; -1 ends the walk. Here each
// thread follows its own pointer, and its own hit decides. A node's box holds
// its subtree's boxes, so a ray that misses it would hit nothing the packet
// walks below it; the nodes a ray processes are the packet walk's in the
// same pre-order, with the same strict t < t_best in the leaves, so the
// thread finds the packet's triangle and t, ties included, and multiplies the
// same transparencies in the same order. No stack: a ray's state is one int.
//
// What bounds it on an H100: the tables (~0.3 MB for the demo) stay in L2,
// so a walk is bound by the latency of its dependent loads (node -> next
// node, node -> its triangles), one slab test per node, not by bandwidth or
// operations (its bound, PERF.md §6, is a few percent of its time). A full
// wave is bound by how much of that latency the resident warps hide; a
// sparse one (the bounce waves after the first: 6.6% of the rays live and
// fewer) by its longest walk, a chain of a few hundred dependent node loads,
// ~0.1 ms on the demo whatever the number of live rays. What the design
// does about it: (1) the tables are cut to the loads a step needs
// (packing.misslink_tables): a node is one 32-byte sector, two 16-byte loads
// (box; left/first, and count with miss packed in one word), where a record
// row spread a visit's 36 bytes over two sectors of 416; a leaf triangle is
// three 16-byte loads of a 48-byte row (v0, e1, e2, with the transparency and
// the encoded material in the w words), where a record row took nine scalar
// loads and reloaded e1 and e2 on a hit. (2) The kernel (walk_kernels.cu)
// walks only the live rays, each in its own slot's thread (a dead slot's
// thread retires at once), and a whole-frame wave's rays are taken in K1's
// 8 x 4 warp tiles. Compacting a block's live rays into its first warps
// tied the in-place walk; gathering those of more slots per block into
// full warps (2-16 passes of 128, or persistent blocks) measured slower:
// fewer warps in flight hid less of the latency. (3) 128 x 8 keeps
// its 62 registers and 32 resident warps; 40 or 32 registers spilled and
// lost (PERF.md §6).

// K7's device tables (packing.misslink_tables): per unified node two float4s
// [bmin.xyz bmax.x | bmax.yz, left_first, (count + 1) << 24 | (miss + 1)]
// (the last two words int bits: exact below 2^24 as the records are), per
// world triangle three [v0 transparency | e1 encoded material | e2 0].
struct MisslinkTables {
  const float4* nodes;  // (Nu, 2)
  const float4* tris;   // (Tw, 3)
  int leaf_k;
};

// K7 in mode kClosest or kShadow (walk_bvh2's contract): a closest ray from
// ``h`` (h.t = T_FAR: no bound); a shadow ray with h.t = maxd multiplies into
// vis the transparencies of the triangles it hits within (t_eps, maxd), in
// record order, and stops once vis <= min_vis after a leaf.
template <int kMode, class Count>
RZ_DEV void walk_misslink(const MisslinkTables& tb, const Ray& r,
                          float min_vis, float t_eps, HitRec& h, float& vis,
                          const Count& cnt) {
  static_assert(kMode != kEither, "K7 walks one kind of ray per launch");
  constexpr bool kShadowRay = kMode == kShadow;
  if (kShadowRay && !(vis > min_vis)) return;
  const int K = tb.leaf_k;
  int cur = 0;  // the root
  while (cur >= 0) {
    cnt.step();
    const float4 a = __ldg(tb.nodes + 2 * (size_t)cur);
    const float4 b = __ldg(tb.nodes + 2 * (size_t)cur + 1);
    const float box[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
    const int left = __float_as_int(b.z);
    const unsigned meta = __float_as_uint(b.w);
    const int count = (int)(meta >> 24) - 1;
    const int miss = (int)(meta & 0xffffffu) - 1;
    float tmin;
    const bool hit = slab(r, box, tmin) && (tmin <= h.t);
    if (hit && count >= 0) {  // a leaf: its triangles, in record order
      const int n = count < K ? count : K;
      const float4* tri = tb.tris + 3 * (size_t)left;
      for (int k = 0; k < n; ++k, tri += 3) {
        const float4 v0 = __ldg(tri), e1 = __ldg(tri + 1), e2 = __ldg(tri + 2);
        float t;
        if (!moller_trumbore(r, v0, e1, e2, t)) continue;
        if constexpr (kShadowRay) {
          if (t >= t_eps && t < h.t) vis = vis * v0.w;  // 0 = opaque
        } else if (t < h.t) {
          h.t = t;
          h.tri = left + k;
          h.cx = e1.y * e2.z - e1.z * e2.y;
          h.cy = e1.z * e2.x - e1.x * e2.z;
          h.cz = e1.x * e2.y - e1.y * e2.x;
          h.menc = e1.w;
        }
      }
      if (kShadowRay && !(vis > min_vis)) return;
    }
    cur = (hit && count < 0) ? left : miss;
  }
}

// Walk policies: the tables a kernel walks and how. The standalone kernels
// and sample_kernel are templates over them, so the tiered K1 shares every
// line of shading, RNG and bounce code with the whole-tree K1. ``trace`` is
// the kEither walk of the regenerating K1: a closest ray from ``h`` (h.t =
// T_FAR) or, with ``is_shadow``, a shadow ray with h.t = maxd and vis = 1.
// ``walk<kMode>`` is the one-mode walk the live-ray launcher of the
// standalone walks (walk_kernels.cu live_walk_kernel) runs, counting its
// steps with Count: a closest ray from ``h``, a shadow ray with h.t = maxd
// and vis = 1 (closest and shadow are its NoCount forms).
struct Bvh2Walk {
  Tables tb;
  RZ_DEV void closest(const Ray& r, HitRec& h) const { walk_closest(tb, r, h); }
  RZ_DEV float shadow(const Ray& r, float maxd, float min_vis,
                      float t_eps) const {
    return walk_shadow(tb, r, maxd, min_vis, t_eps);
  }
  template <class Count>
  RZ_DEV void trace(const Ray& r, bool is_shadow, float min_vis,
                    float t_eps, HitRec& h, float& vis,
                    const Count& cnt) const {
    walk_bvh2<kEither>(tb, r, is_shadow, min_vis, t_eps, h, vis, cnt);
  }
  template <int kMode, class Count>
  RZ_DEV void walk(const Ray& r, float min_vis, float t_eps, HitRec& h,
                   float& vis, const Count& cnt) const {
    walk_bvh2<kMode>(tb, r, kMode == kShadow, min_vis, t_eps, h, vis, cnt);
  }
};

struct TieredWalk {
  TieredTables tt;
  RZ_DEV void closest(const Ray& r, HitRec& h) const {
    walk_closest_tiered(tt, r, h);
  }
  RZ_DEV float shadow(const Ray& r, float maxd, float min_vis,
                      float t_eps) const {
    return walk_shadow_tiered(tt, r, maxd, min_vis, t_eps);
  }
  template <class Count>
  RZ_DEV void trace(const Ray& r, bool is_shadow, float min_vis,
                    float t_eps, HitRec& h, float& vis,
                    const Count& cnt) const {
    walk_tiered<kEither>(tt, r, is_shadow, min_vis, t_eps, h, vis, cnt);
  }
  template <int kMode, class Count>
  RZ_DEV void walk(const Ray& r, float min_vis, float t_eps, HitRec& h,
                   float& vis, const Count& cnt) const {
    walk_tiered<kMode>(tt, r, kMode == kShadow, min_vis, t_eps, h, vis, cnt);
  }
};

struct Bvh8Walk {
  Tables8 tb;
  RZ_DEV void closest(const Ray& r, HitRec& h) const {
    walk_closest_bvh8(tb, r, h);
  }
  RZ_DEV float shadow(const Ray& r, float maxd, float min_vis,
                      float t_eps) const {
    return walk_shadow_bvh8(tb, r, maxd, min_vis, t_eps);
  }
  template <class Count>
  RZ_DEV void trace(const Ray& r, bool is_shadow, float min_vis,
                    float t_eps, HitRec& h, float& vis,
                    const Count& cnt) const {
    walk_bvh8<kEither>(tb, r, is_shadow, min_vis, t_eps, h, vis, cnt);
  }
  template <int kMode, class Count>
  RZ_DEV void walk(const Ray& r, float min_vis, float t_eps, HitRec& h,
                   float& vis, const Count& cnt) const {
    walk_bvh8<kMode>(tb, r, kMode == kShadow, min_vis, t_eps, h, vis, cnt);
  }
};

// K7's tables: standalone only (no K1 form walks them).
struct MisslinkWalk {
  MisslinkTables tb;
  template <int kMode, class Count>
  RZ_DEV void walk(const Ray& r, float min_vis, float t_eps, HitRec& h,
                   float& vis, const Count& cnt) const {
    walk_misslink<kMode>(tb, r, min_vis, t_eps, h, vis, cnt);
  }
};

// The walks of the counting forms of the lockstep sample_kernel (K1's K9
// and K6 forms) and of the continuation: Walk's closest and shadow walks as
// its kEither walk (trace, the regenerating K1's, which takes the same
// steps to the same result) with LaneCount at every step.
template <class Walk>
struct Counted : Walk {
  RZ_DEV void closest(const Ray& r, HitRec& h) const {
    float vis = 1.0f;
    this->trace(r, false, 0.0f, 0.0f, h, vis, LaneCount{});
  }
  RZ_DEV float shadow(const Ray& r, float maxd, float min_vis,
                      float t_eps) const {
    HitRec h{maxd, -1, 0.0f, 0.0f, 0.0f, 0.0f};
    float vis = 1.0f;
    this->trace(r, true, min_vis, t_eps, h, vis, LaneCount{});
    return vis;
  }
};

}  // namespace rz
