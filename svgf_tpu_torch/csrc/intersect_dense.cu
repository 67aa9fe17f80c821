// K5: nearest ray-triangle hit over the whole world soup, for scenes of at
// most 16,384 world triangles (the Cornell box's 36).
//
// Replaces svgf_tpu/kernels/intersect_pallas.py intersect_dense_pallas
// (_intersect_rays, kernel _kernel, Moller-Trumbore in _mt_rows). It makes
// the choice the plain svgf_tpu_torch/ops/intersect.py intersect_dense
// makes: every real column in ascending order, a later column wins only
// when strictly closer (argmin's first minimum), starting from the ray's
// t0 (MAX_LENGTH or a tmax), restricted to one instance's columns when
// only_instance >= 0. It writes the best t and the winning column (-1 for
// none; an inactive ray does not sweep and reports t0 and -1); the
// wrapper gathers the winner's vertices and ids and recomputes t/u/v
// differentiably, where the TPU kernel selected them in-kernel because
// gathers are slow there.
//
// Bound on the card: per ray 29 B read (origin, direction, t0, active)
// and 8 B written, against 55 FP32 operations (compares included) per
// ray-triangle test. At 36 triangles that is 1,980 operations per 37 B,
// above the card's 20 operations a byte, so the FP32 rate bounds it, not
// memory. Design: one thread per ray; the block stages the packed
// soup through shared memory in tiles of kTile triangles (a 16,384-triangle
// soup does not fit in 227 KB), and every thread sweeps the tile from
// shared memory, where all threads read the same triangle at once (a
// broadcast). A block whose rays are all inactive skips the sweep
// (__syncthreads_or), as the TPU kernel skips all-inactive ray tiles.
#include "intersect.cuh"

namespace svgf {

constexpr int kDenseThreads = 256;
constexpr int kTile = 512;  // triangles per shared-memory tile: 512 x 40 B

__global__ void __launch_bounds__(kDenseThreads)
intersect_dense_kernel(const float4* __restrict__ tris, int c0, int c1, int only_instance,
                       const float* __restrict__ ro, const float* __restrict__ rd,
                       const float* __restrict__ t0, const bool* __restrict__ active, int n_rays,
                       float* __restrict__ out_t, int* __restrict__ out_col) {
  __shared__ float3 s_v0[kTile], s_e1[kTile], s_e2[kTile];
  __shared__ bool s_ok[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n_rays;
  const bool act = in && active[i];
  const float start = in ? t0[i] : kMaxLength;
  if (!__syncthreads_or(act)) {
    if (in) {
      out_t[i] = start;
      out_col[i] = -1;
    }
    return;
  }
  const float3 o = in ? load3(ro, i) : make_float3(0.f, 0.f, 0.f);
  const float3 d = in ? load3(rd, i) : make_float3(0.f, 0.f, 1.f);
  float best = start;
  int col = -1;
  for (int base = c0; base < c1; base += kTile) {
    const int n = min(kTile, c1 - base);
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const Tri t = load_tri(tris, base + k);
      s_v0[k] = t.v0;
      s_e1[k] = t.e1;
      s_e2[k] = t.e2;
      s_ok[k] = only_instance < 0 || t.inst == only_instance;
    }
    __syncthreads();
    for (int k = 0; k < n && act; ++k) {  // an inactive ray only helps stage
      if (!s_ok[k]) continue;
      const float t = mt_hit(o, d, s_v0[k], s_e1[k], s_e2[k]);
      if (t < best) {
        best = t;
        col = base + k;
      }
    }
  }
  if (in) {
    out_t[i] = best;
    out_col[i] = col;
  }
}

}  // namespace svgf

extern "C" int svgf_intersect_dense(const float4* tris, const float* ro, const float* rd,
                                    const float* t0, const bool* active, float* out_t,
                                    int* out_col, int c0, int c1, int only_instance, int n_rays,
                                    void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + svgf::kDenseThreads - 1) / svgf::kDenseThreads;
  svgf::intersect_dense_kernel<<<blocks, svgf::kDenseThreads, 0, (cudaStream_t)stream>>>(
      tris, c0, c1, only_instance, ro, rd, t0, active, n_rays, out_t, out_col);
  return (int)cudaGetLastError();
}
