// Native BVH builder and tangents: host C++ of svgf_tpu_torch, a copy of
// svgf_tpu's native/bvh_builder.cpp with the same two C entry points and
// the same arithmetic, so that both packages build the same tree and the
// same tangent bits on one machine (tests/test_torch_native.py).
//
// The reference builds its BVHs in C++ on the host (binned SAH BLAS,
// BVH.cpp:60-257). It builds the kind of tree accel/bvh.py's NumPy builder
// builds: 8-bin SAH over 3 axes, median fallback, SINGLE-triangle leaves,
// DFS order with skip links. Not the same tree: it bins in float and
// partitions in place, so leaf order and bounds differ. With one triangle
// a leaf the tree over T triangles always has exactly 2T-1 nodes, so
// callers preallocate every output.
//
// It is host code, not a kernel: svgf_tpu_torch/accel/native.py compiles
// it with g++ at first use (the flags of native/Makefile) and binds it
// with ctypes. It stays apart from csrc/, whose .cu files nvcc builds.
//
// API:    svgf_build_blas(tri_verts[T*9], T, node_min[N*3], node_max[N*3],
//                         skip[N], leaf_tri[N]) -> N (= 2T-1) or -1
//         svgf_tangents(pos[V*3], nrm[V*3], uv[V*2], idx[F*3], V, F, out[V*4])

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int BINS = 8;

struct V3 {
  float x, y, z;
};

static inline V3 vmin(V3 a, V3 b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(V3 a, V3 b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float area(V3 lo, V3 hi) {
  float ex = std::max(hi.x - lo.x, 0.f);
  float ey = std::max(hi.y - lo.y, 0.f);
  float ez = std::max(hi.z - lo.z, 0.f);
  return ex * ey + ey * ez + ez * ex;
}
static inline float get(const V3& v, int axis) {
  return axis == 0 ? v.x : (axis == 1 ? v.y : v.z);
}

struct Builder {
  const float* verts;  // T x 9
  std::vector<V3> tmin, tmax, cent;
  std::vector<int32_t> order;  // triangle ids, partitioned in place

  float* node_min;
  float* node_max;
  int32_t* skip;
  int32_t* leaf_tri;
  int32_t cursor = 0;

  // returns subtree size; emits nodes in DFS order with skip links
  int32_t emit(int32_t lo, int32_t hi, int32_t skip_to_unknown_yet);

  void bounds(int32_t lo, int32_t hi, V3& bmin, V3& bmax) const {
    bmin = {1e30f, 1e30f, 1e30f};
    bmax = {-1e30f, -1e30f, -1e30f};
    for (int32_t k = lo; k < hi; ++k) {
      bmin = vmin(bmin, tmin[order[k]]);
      bmax = vmax(bmax, tmax[order[k]]);
    }
  }

  // binned SAH split; returns axis (-1 if none) + plane
  bool find_split(int32_t lo, int32_t hi, int& best_axis, float& best_plane) const {
    best_axis = -1;
    double best_cost = 1e300;
    for (int axis = 0; axis < 3; ++axis) {
      float cmin = 1e30f, cmax = -1e30f;
      for (int32_t k = lo; k < hi; ++k) {
        float c = get(cent[order[k]], axis);
        cmin = std::min(cmin, c);
        cmax = std::max(cmax, c);
      }
      if (cmax == cmin) continue;
      float scale = BINS / (cmax - cmin);
      int counts[BINS] = {0};
      V3 bmin[BINS], bmax[BINS];
      for (int b = 0; b < BINS; ++b) {
        bmin[b] = {1e30f, 1e30f, 1e30f};
        bmax[b] = {-1e30f, -1e30f, -1e30f};
      }
      for (int32_t k = lo; k < hi; ++k) {
        int32_t t = order[k];
        int b = std::min(BINS - 1, (int)((get(cent[t], axis) - cmin) * scale));
        counts[b]++;
        bmin[b] = vmin(bmin[b], tmin[t]);
        bmax[b] = vmax(bmax[b], tmax[t]);
      }
      // sweep the BINS-1 planes
      double lcost[BINS - 1], rcost[BINS - 1];
      {
        V3 lo3 = {1e30f, 1e30f, 1e30f}, hi3 = {-1e30f, -1e30f, -1e30f};
        int n = 0;
        for (int b = 0; b < BINS - 1; ++b) {
          n += counts[b];
          lo3 = vmin(lo3, bmin[b]);
          hi3 = vmax(hi3, bmax[b]);
          lcost[b] = n ? n * (double)area(lo3, hi3) : 0.0;
          if (!n) lcost[b] = -1.0;  // empty side marker
        }
        lo3 = {1e30f, 1e30f, 1e30f};
        hi3 = {-1e30f, -1e30f, -1e30f};
        n = 0;
        for (int b = BINS - 2; b >= 0; --b) {
          n += counts[b + 1];
          lo3 = vmin(lo3, bmin[b + 1]);
          hi3 = vmax(hi3, bmax[b + 1]);
          rcost[b] = n ? n * (double)area(lo3, hi3) : -1.0;
        }
      }
      for (int b = 0; b < BINS - 1; ++b) {
        if (lcost[b] < 0 || rcost[b] < 0) continue;
        double cost = lcost[b] + rcost[b];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_plane = cmin + (b + 1) / scale;
        }
      }
    }
    return best_axis >= 0;
  }
};

int32_t Builder::emit(int32_t lo, int32_t hi, int32_t skip_to) {
  int32_t me = cursor++;
  V3 bmin, bmax;
  bounds(lo, hi, bmin, bmax);
  node_min[me * 3 + 0] = bmin.x;
  node_min[me * 3 + 1] = bmin.y;
  node_min[me * 3 + 2] = bmin.z;
  node_max[me * 3 + 0] = bmax.x;
  node_max[me * 3 + 1] = bmax.y;
  node_max[me * 3 + 2] = bmax.z;
  skip[me] = skip_to;  // filled as final index after recursion below

  if (hi - lo == 1) {
    leaf_tri[me] = order[lo];
    return 1;
  }
  leaf_tri[me] = -1;

  int axis;
  float plane;
  int32_t mid = lo;
  if (find_split(lo, hi, axis, plane)) {
    int32_t i = lo, j = hi - 1;
    while (i <= j) {
      if (get(cent[order[i]], axis) < plane) {
        ++i;
      } else {
        std::swap(order[i], order[j]);
        --j;
      }
    }
    mid = i;
    if (mid == lo || mid == hi) mid = lo + (hi - lo) / 2;  // degenerate
  } else {
    mid = lo + (hi - lo) / 2;  // all centroids identical: median split
  }

  // left subtree has 2*(mid-lo)-1 nodes; its skip goes to the right child
  int32_t left_size = emit(lo, mid, me + 1 + (2 * (mid - lo) - 1));
  int32_t right_size = emit(mid, hi, skip_to);
  return 1 + left_size + right_size;
}

}  // namespace

extern "C" {

int32_t svgf_build_blas(const float* tri_verts, int32_t T, float* node_min,
                        float* node_max, int32_t* skip, int32_t* leaf_tri) {
  if (T <= 0) return -1;
  Builder b;
  b.verts = tri_verts;
  b.tmin.resize(T);
  b.tmax.resize(T);
  b.cent.resize(T);
  b.order.resize(T);
  for (int32_t t = 0; t < T; ++t) {
    const float* v = tri_verts + t * 9;
    V3 v0{v[0], v[1], v[2]}, v1{v[3], v[4], v[5]}, v2{v[6], v[7], v[8]};
    b.tmin[t] = vmin(vmin(v0, v1), v2);
    b.tmax[t] = vmax(vmax(v0, v1), v2);
    b.cent[t] = {(v0.x + v1.x + v2.x) / 3.f, (v0.y + v1.y + v2.y) / 3.f,
                 (v0.z + v1.z + v2.z) / 3.f};
    b.order[t] = t;
  }
  b.node_min = node_min;
  b.node_max = node_max;
  b.skip = skip;
  b.leaf_tri = leaf_tri;
  int32_t n = 2 * T - 1;
  b.emit(0, T, n);
  return b.cursor == n ? n : -1;
}

// Lengyel per-vertex tangents (reference Scene.cpp:111-161 semantics).
void svgf_tangents(const float* pos /*V*3*/, const float* nrm /*V*3*/,
                   const float* uv /*V*2*/, const int32_t* idx /*F*3*/,
                   int32_t V, int32_t F, float* out /*V*4*/) {
  std::vector<double> tan1(V * 3, 0.0), tan2(V * 3, 0.0);
  for (int32_t f = 0; f < F; ++f) {
    int32_t i0 = idx[f * 3], i1 = idx[f * 3 + 1], i2 = idx[f * 3 + 2];
    double e1[3], e2[3];
    for (int k = 0; k < 3; ++k) {
      e1[k] = pos[i1 * 3 + k] - pos[i0 * 3 + k];
      e2[k] = pos[i2 * 3 + k] - pos[i0 * 3 + k];
    }
    double s1 = uv[i1 * 2] - uv[i0 * 2], t1 = uv[i1 * 2 + 1] - uv[i0 * 2 + 1];
    double s2 = uv[i2 * 2] - uv[i0 * 2], t2 = uv[i2 * 2 + 1] - uv[i0 * 2 + 1];
    double det = s1 * t2 - s2 * t1;
    double r = std::fabs(det) > 1e-20 ? 1.0 / det : 0.0;
    for (int k = 0; k < 3; ++k) {
      double sd = (t2 * e1[k] - t1 * e2[k]) * r;
      double td = (s1 * e2[k] - s2 * e1[k]) * r;
      tan1[i0 * 3 + k] += sd;
      tan1[i1 * 3 + k] += sd;
      tan1[i2 * 3 + k] += sd;
      tan2[i0 * 3 + k] += td;
      tan2[i1 * 3 + k] += td;
      tan2[i2 * 3 + k] += td;
    }
  }
  for (int32_t v = 0; v < V; ++v) {
    double n[3] = {nrm[v * 3], nrm[v * 3 + 1], nrm[v * 3 + 2]};
    double t[3] = {tan1[v * 3], tan1[v * 3 + 1], tan1[v * 3 + 2]};
    double nt = n[0] * t[0] + n[1] * t[1] + n[2] * t[2];
    double o[3] = {t[0] - n[0] * nt, t[1] - n[1] * nt, t[2] - n[2] * nt};
    double len = std::sqrt(o[0] * o[0] + o[1] * o[1] + o[2] * o[2]);
    if (len < 1e-12) {
      // degenerate UVs: arbitrary perpendicular
      double a[3] = {1, 0, 0};
      if (std::fabs(n[0]) >= 0.9) {
        a[0] = 0;
        a[1] = 1;
      }
      o[0] = n[1] * a[2] - n[2] * a[1];
      o[1] = n[2] * a[0] - n[0] * a[2];
      o[2] = n[0] * a[1] - n[1] * a[0];
      len = std::sqrt(o[0] * o[0] + o[1] * o[1] + o[2] * o[2]);
      if (len < 1e-20) len = 1.0;
    }
    double c[3] = {n[1] * t[2] - n[2] * t[1], n[2] * t[0] - n[0] * t[2],
                   n[0] * t[1] - n[1] * t[0]};
    double wsign =
        (c[0] * tan2[v * 3] + c[1] * tan2[v * 3 + 1] + c[2] * tan2[v * 3 + 2]) < 0
            ? -1.0
            : 1.0;
    out[v * 4 + 0] = (float)(o[0] / len);
    out[v * 4 + 1] = (float)(o[1] / len);
    out[v * 4 + 2] = (float)(o[2] / len);
    out[v * 4 + 3] = (float)wsign;
  }
}

}  // extern "C"
