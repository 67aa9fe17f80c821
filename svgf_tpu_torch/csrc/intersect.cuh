// Shared device code of the two intersector kernels (intersect_dense.cu,
// intersect_clustered.cu).
//
// Both write the Hit record through HitOut (below) and read the world
// triangle soup packed once per scene by the wrapper
// (svgf_tpu_torch/kernels/intersect.py packed_scene) as three float4 a
// column:
//   (v0.x, v0.y, v0.z, instance id bits), (e1, prim id bits), (e2, material id bits)
// with e1 = v1 - v0 and e2 = v2 - v0: the float subtractions that
// ray_triangle_comp (svgf_tpu_torch/ops/geometry.py) makes per test give
// the same values once per triangle. The Moller-Trumbore test below keeps
// that function's operation order and constants (and so
// ray_triangle_comp_raw's: its t, u and v), and the build passes
// --fmad=false and keeps IEEE division, so a kernel's t, u and v equal the
// plain version's bit for bit on the same ray and triangle.
#pragma once

#include <cuda_runtime.h>

#define SVGF_F(x) ((float)(x))

namespace svgf {

constexpr float kMaxLength = 1e30f;  // ops/geometry.py MAX_LENGTH: the miss distance

struct Tri {
  float3 v0, e1, e2;
  int inst, prim, mat;
};

__device__ __forceinline__ Tri load_tri(const float4* __restrict__ tris, int col) {
  const float4 a = __ldg(tris + 3 * col), b = __ldg(tris + 3 * col + 1),
               c = __ldg(tris + 3 * col + 2);
  return Tri{make_float3(a.x, a.y, a.z), make_float3(b.x, b.y, b.z), make_float3(c.x, c.y, c.z),
             __float_as_int(a.w), __float_as_int(b.w), __float_as_int(c.w)};
}

struct Crossing {
  float t, u, v;
  bool hit;
};

// Moller-Trumbore (reference Common.cuh:509-536): the raw t, u, v of the
// ray against the triangle's plane, and whether it hits the triangle.
__device__ __forceinline__ Crossing mt_test(float3 o, float3 d, float3 v0, float3 e1, float3 e2) {
  const float hx = d.y * e2.z - d.z * e2.y;
  const float hy = d.z * e2.x - d.x * e2.z;
  const float hz = d.x * e2.y - d.y * e2.x;
  const float a = e1.x * hx + e1.y * hy + e1.z * hz;
  const bool parallel = fabsf(a) < SVGF_F(1e-8);
  const float f = 1.0f / (parallel ? 1.0f : a);
  const float sx = o.x - v0.x, sy = o.y - v0.y, sz = o.z - v0.z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1.z - sz * e1.y;
  const float qy = sz * e1.x - sx * e1.z;
  const float qz = sx * e1.y - sy * e1.x;
  const float v = f * (d.x * qx + d.y * qy + d.z * qz);
  const float t = f * (e2.x * qx + e2.y * qy + e2.z * qz);
  const bool hit = !parallel && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
                   t > SVGF_F(1e-8);
  return Crossing{t, u, v, hit};
}

// t of the hit, or kMaxLength when the ray misses the triangle.
__device__ __forceinline__ float mt_hit(float3 o, float3 d, float3 v0, float3 e1, float3 e2) {
  const Crossing c = mt_test(o, d, v0, e1, e2);
  return c.hit ? c.t : kMaxLength;
}

__device__ __forceinline__ float3 load3(const float* __restrict__ p, long i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

// The Hit record's six fields, (R,) each, and the winning column (-1 for
// none), which only a caller that recomputes t/u/v asks for (else null).
struct HitOut {
  float *dist, *u, *v;
  int *prim, *inst, *mat, *col;
};

__device__ __forceinline__ void write_hit(const HitOut& out, int i, float dist, float u, float v,
                                          int prim, int inst, int mat, int col) {
  out.dist[i] = dist;
  out.u[i] = u;
  out.v[i] = v;
  out.prim[i] = prim;
  out.inst[i] = inst;
  out.mat[i] = mat;
  if (out.col) out.col[i] = col;
}

// The Hit of a ray's search as ops/intersect.py hit_from_winner builds it:
// the winner's t (== best), its u, v from one more Moller-Trumbore test
// with the same arithmetic (bit for bit the torch recompute's) and its ids
// from the packed record; without a winner, dist = the start distance,
// u = v = 0 and ids 0.
__device__ __forceinline__ void write_winner(const HitOut& out, int i, const float4* __restrict__ tris,
                                             float3 o, float3 d, float best, float start,
                                             int col) {
  if (col < 0) {
    write_hit(out, i, start, 0.f, 0.f, 0, 0, 0, -1);
    return;
  }
  const Tri w = load_tri(tris, col);
  const Crossing c = mt_test(o, d, w.v0, w.e1, w.e2);  // c.t == best
  write_hit(out, i, best, c.u, c.v, w.prim, w.inst, w.mat, col);
}

}  // namespace svgf
