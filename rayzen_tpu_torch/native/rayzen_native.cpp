// Native host runtime: SAH/midpoint BVH builders and an OBJ parser.
//
// Copied from rayzen_tpu/native/rayzen_native.cpp, C ABI unchanged; built
// by rayzen_tpu_torch/accel/native.py with g++ into native/build/.
//
// The reference keeps its performance-critical host work in C++ (BVH::buildBLAS
// with sweep SAH, RayZen/src/BVH.cpp:22-175; BVH::buildTLAS, :178-240; the OBJ
// loader, RayZen/src/Mesh.cpp:6-50). This library is the equivalent: same
// algorithms (leaf size <= 4 default, per-axis centroid-sorted sweep SAH with
// midpoint fallback, fan triangulation / position-only faces), implemented for
// a flat (T, 3, 3) float32 triangle-soup layout and emitting the threaded
// (miss-link) node arrays the packer consumes. Exposed through a C ABI for
// ctypes (no pybind11 dependency).
//
// Semantics intentionally match rayzen_tpu_torch/accel/builder.py bit-for-bit
// so the native and Python builders are interchangeable (tests assert
// equality).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float axis_of(const Vec3& v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}
// float32 arithmetic to match the numpy builder's precision bit-for-bit
// (near-tie SAH costs must resolve identically in both builders)
static inline float surface_area(const Vec3& lo, const Vec3& hi) {
  const float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
  return 2.0f * (dx * dy + dy * dz + dz * dx);
}

struct Node {
  Vec3 bmin{0, 0, 0};
  Vec3 bmax{0, 0, 0};
  int32_t left_first = 0;  // internal: left child; leaf: first primitive
  int32_t count = 0;       // internal: -1; leaf: >= 0
};

struct Build {
  std::vector<Node> nodes;
  std::vector<int32_t> miss;
  std::vector<int64_t> order;
};

struct Prim {
  Vec3 lo, hi, centroid;
};

// Sweep SAH over all three axes; returns best (axis, split) and leaves
// `scratch` holding the centroid-sorted order for the best axis.
// Mirrors builder.py::_sah_split / reference findSAHSplit (BVH.cpp:22-97).
static bool sah_split(const std::vector<Prim>& prims, int64_t* order,
                      int64_t n, double parent_area, int64_t* out_split,
                      std::vector<int64_t>& scratch) {
  double best_cost = DBL_MAX;
  int best_axis = -1;
  int64_t best_split = -1;
  std::vector<int64_t> sorted(order, order + n);
  std::vector<Vec3> left_lo(n), left_hi(n), right_lo(n), right_hi(n);
  std::vector<int64_t> axis_sorted(n);

  for (int a = 0; a < 3; ++a) {
    std::copy(order, order + n, axis_sorted.begin());
    std::stable_sort(axis_sorted.begin(), axis_sorted.end(),
                     [&](int64_t i, int64_t j) {
                       return axis_of(prims[i].centroid, a) <
                              axis_of(prims[j].centroid, a);
                     });
    Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX}, hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int64_t i = 0; i < n; ++i) {
      lo = vmin(lo, prims[axis_sorted[i]].lo);
      hi = vmax(hi, prims[axis_sorted[i]].hi);
      left_lo[i] = lo;
      left_hi[i] = hi;
    }
    lo = {FLT_MAX, FLT_MAX, FLT_MAX};
    hi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int64_t i = n - 1; i >= 0; --i) {
      lo = vmin(lo, prims[axis_sorted[i]].lo);
      hi = vmax(hi, prims[axis_sorted[i]].hi);
      right_lo[i] = lo;
      right_hi[i] = hi;
    }
    for (int64_t i = 1; i < n; ++i) {
      // areas in f32 (numpy), cost combine in f64 (numpy float64 promotion)
      const float la = surface_area(left_lo[i - 1], left_hi[i - 1]);
      const float ra = surface_area(right_lo[i], right_hi[i]);
      const double cost =
          (double(la) * double(i) + double(ra) * double(n - i)) /
          (parent_area + 1e-6);
      if (cost < best_cost) {
        best_cost = cost;
        best_axis = a;
        best_split = i;
        sorted = axis_sorted;
      }
    }
  }
  if (best_axis < 0) return false;
  scratch = std::move(sorted);
  *out_split = best_split;
  return true;
}

// Longest-axis midpoint partition (builder.py::_midpoint_partition;
// reference BVH.cpp:137-150, :210-224). Partition is stable (keeps relative
// order within each side) to match numpy boolean-mask concatenation.
static int64_t midpoint_partition(const std::vector<Prim>& prims,
                                  int64_t* order, int64_t n, const Vec3& bmin,
                                  const Vec3& bmax,
                                  std::vector<int64_t>& scratch) {
  const Vec3 extent{bmax.x - bmin.x, bmax.y - bmin.y, bmax.z - bmin.z};
  int axis = 0;
  if (extent.y > extent.x && extent.y > extent.z)
    axis = 1;
  else if (extent.z > extent.x)
    axis = 2;
  const float split = 0.5f * (axis_of(bmin, axis) + axis_of(bmax, axis));
  scratch.clear();
  std::vector<int64_t> right;
  for (int64_t i = 0; i < n; ++i) {
    if (axis_of(prims[order[i]].centroid, axis) < split)
      scratch.push_back(order[i]);
    else
      right.push_back(order[i]);
  }
  int64_t mid = (int64_t)scratch.size();
  if (mid == 0 || mid == n) {
    scratch.assign(order, order + n);  // keep original order, halve
    return n / 2;
  }
  scratch.insert(scratch.end(), right.begin(), right.end());
  return mid;
}

static void compute_miss_links(Build& b) {
  b.miss.assign(b.nodes.size(), -1);
  std::vector<std::pair<int32_t, int32_t>> stack;
  stack.push_back({0, -1});
  while (!stack.empty()) {
    auto [node, miss] = stack.back();
    stack.pop_back();
    b.miss[node] = miss;
    if (b.nodes[node].count < 0) {
      const int32_t left = b.nodes[node].left_first;
      stack.push_back({left, left + 1});
      stack.push_back({left + 1, miss});
    }
  }
}

// Shared build core (builder.py::_build). single_leaf => TLAS mode.
static Build* build(const std::vector<Prim>& prims, int leaf_size,
                    bool use_sah, bool single_leaf) {
  auto* b = new Build();
  const int64_t n = (int64_t)prims.size();
  if (n == 0) {
    Node root;
    root.bmin = {FLT_MAX, FLT_MAX, FLT_MAX};
    root.bmax = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    root.left_first = 0;
    root.count = 0;
    b->nodes.push_back(root);
    b->miss.push_back(-1);
    return b;
  }
  b->order.resize(n);
  for (int64_t i = 0; i < n; ++i) b->order[i] = i;

  struct Entry {
    int32_t node;
    int64_t start, end;
  };
  std::vector<Entry> stack;
  b->nodes.emplace_back();
  stack.push_back({0, 0, n});
  std::vector<int64_t> scratch;

  while (!stack.empty()) {
    const Entry e = stack.back();
    stack.pop_back();
    const int64_t count = e.end - e.start;
    Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX}, hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int64_t i = e.start; i < e.end; ++i) {
      lo = vmin(lo, prims[b->order[i]].lo);
      hi = vmax(hi, prims[b->order[i]].hi);
    }
    Node& node = b->nodes[e.node];
    node.bmin = lo;
    node.bmax = hi;
    const bool is_leaf = single_leaf ? (count == 1) : (count <= leaf_size);
    if (is_leaf) {
      node.left_first = (int32_t)e.start;
      node.count = (int32_t)count;
      continue;
    }
    int64_t mid_rel = -1;
    if (use_sah && !single_leaf) {
      const double parent_area = double(surface_area(lo, hi));
      int64_t split;
      if (sah_split(prims, b->order.data() + e.start, count, parent_area,
                    &split, scratch) &&
          split > 0 && split < count) {
        std::copy(scratch.begin(), scratch.end(), b->order.begin() + e.start);
        mid_rel = split;
      }
    }
    if (mid_rel < 0) {
      mid_rel = midpoint_partition(prims, b->order.data() + e.start, count, lo,
                                   hi, scratch);
      std::copy(scratch.begin(), scratch.end(), b->order.begin() + e.start);
    }
    const int64_t mid = e.start + mid_rel;
    const int32_t left = (int32_t)b->nodes.size();
    b->nodes.emplace_back();
    b->nodes.emplace_back();
    b->nodes[e.node].left_first = left;
    b->nodes[e.node].count = -1;
    stack.push_back({left + 1, mid, e.end});
    stack.push_back({left, e.start, mid});
  }
  compute_miss_links(*b);
  return b;
}

}  // namespace

extern "C" {

// ---- BVH builds -----------------------------------------------------------

void* rz_build_blas(const float* verts, int64_t n_tris, int leaf_size,
                    int use_sah) {
  std::vector<Prim> prims(n_tris);
  for (int64_t t = 0; t < n_tris; ++t) {
    const float* v = verts + t * 9;
    Vec3 a{v[0], v[1], v[2]}, b{v[3], v[4], v[5]}, c{v[6], v[7], v[8]};
    prims[t].lo = vmin(a, vmin(b, c));
    prims[t].hi = vmax(a, vmax(b, c));
    prims[t].centroid = {(a.x + b.x + c.x) / 3.0f, (a.y + b.y + c.y) / 3.0f,
                         (a.z + b.z + c.z) / 3.0f};
  }
  return build(prims, leaf_size, use_sah != 0, /*single_leaf=*/false);
}

void* rz_build_tlas(const float* bmin, const float* bmax, int64_t n_inst) {
  std::vector<Prim> prims(n_inst);
  for (int64_t i = 0; i < n_inst; ++i) {
    prims[i].lo = {bmin[i * 3], bmin[i * 3 + 1], bmin[i * 3 + 2]};
    prims[i].hi = {bmax[i * 3], bmax[i * 3 + 1], bmax[i * 3 + 2]};
    prims[i].centroid = {(prims[i].lo.x + prims[i].hi.x) * 0.5f,
                         (prims[i].lo.y + prims[i].hi.y) * 0.5f,
                         (prims[i].lo.z + prims[i].hi.z) * 0.5f};
  }
  return build(prims, 1, /*use_sah=*/false, /*single_leaf=*/true);
}

int64_t rz_bvh_num_nodes(void* handle) {
  return (int64_t) reinterpret_cast<Build*>(handle)->nodes.size();
}

int64_t rz_bvh_num_prims(void* handle) {
  return (int64_t) reinterpret_cast<Build*>(handle)->order.size();
}

// bounds: (N, 6) f32 [bmin|bmax]; meta: (N, 3) i32 [left_first, count, miss];
// order: (T,) i64
void rz_bvh_copy(void* handle, float* bounds, int32_t* meta, int64_t* order) {
  const Build* b = reinterpret_cast<Build*>(handle);
  for (size_t i = 0; i < b->nodes.size(); ++i) {
    const Node& n = b->nodes[i];
    bounds[i * 6 + 0] = n.bmin.x;
    bounds[i * 6 + 1] = n.bmin.y;
    bounds[i * 6 + 2] = n.bmin.z;
    bounds[i * 6 + 3] = n.bmax.x;
    bounds[i * 6 + 4] = n.bmax.y;
    bounds[i * 6 + 5] = n.bmax.z;
    meta[i * 3 + 0] = n.left_first;
    meta[i * 3 + 1] = n.count;
    meta[i * 3 + 2] = b->miss[i];
  }
  std::memcpy(order, b->order.data(), b->order.size() * sizeof(int64_t));
}

void rz_bvh_free(void* handle) { delete reinterpret_cast<Build*>(handle); }

// ---- OBJ parsing ----------------------------------------------------------
// Reference loader semantics (Mesh.cpp:6-50): `v` position lines, `f` faces
// with position-index-only tokens, fan triangulation, 1-based indices.

struct ObjData {
  std::vector<float> verts;  // T * 9
};

void* rz_obj_parse(const char* path) {
  // Skip-and-log semantics matching the Python parser (mesh.py parse_obj):
  // malformed tokens or out-of-range face indices drop the face, never crash.
  // Nothing may throw across the extern "C" / ctypes boundary.
  try {
    std::ifstream file(path);
    if (!file.is_open()) return nullptr;
    auto* out = new ObjData();
    std::vector<Vec3> positions;
    std::string line;
    std::vector<int64_t> face;
    while (std::getline(file, line)) {
      if (line.rfind("v ", 0) == 0) {
        std::istringstream iss(line.substr(2));
        Vec3 v{0, 0, 0};
        if (iss >> v.x >> v.y >> v.z) positions.push_back(v);
      } else if (line.rfind("f ", 0) == 0) {
        std::istringstream iss(line.substr(2));
        face.clear();
        std::string token;
        bool ok = true;
        while (iss >> token) {
          const size_t slash = token.find('/');
          const std::string head =
              slash == std::string::npos ? token : token.substr(0, slash);
          try {
            face.push_back(std::stol(head));
          } catch (const std::exception&) {
            ok = false;
            break;
          }
        }
        if (!ok || face.size() < 3) continue;
        for (size_t i = 1; i + 1 < face.size(); ++i) {
          const int64_t ia = face[0], ib = face[i], ic = face[i + 1];
          const int64_t n = (int64_t)positions.size();
          // 1-based indices (Mesh.cpp:38-46); validate before dereferencing
          if (ia < 1 || ia > n || ib < 1 || ib > n || ic < 1 || ic > n)
            continue;
          const Vec3& a = positions[ia - 1];
          const Vec3& b = positions[ib - 1];
          const Vec3& c = positions[ic - 1];
          const float tri[9] = {a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z};
          out->verts.insert(out->verts.end(), tri, tri + 9);
        }
      }
    }
    return out;
  } catch (...) {
    return nullptr;  // caller falls back to the Python parser
  }
}

int64_t rz_obj_num_triangles(void* handle) {
  return handle ? (int64_t)(reinterpret_cast<ObjData*>(handle)->verts.size() / 9)
                : 0;
}

void rz_obj_copy(void* handle, float* verts) {
  const ObjData* d = reinterpret_cast<ObjData*>(handle);
  std::memcpy(verts, d->verts.data(), d->verts.size() * sizeof(float));
}

void rz_obj_free(void* handle) { delete reinterpret_cast<ObjData*>(handle); }

}  // extern "C"
