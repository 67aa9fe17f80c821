// K5: nearest ray-triangle hit over the whole world soup, for scenes of at
// most 16,384 world triangles (the Cornell box's 36), written as the whole
// Hit record.
//
// Replaces svgf_tpu/kernels/intersect_pallas.py intersect_dense_pallas
// (_intersect_rays, kernel _kernel, Moller-Trumbore in _mt_rows). It makes
// the choice the plain svgf_tpu_torch/ops/intersect.py intersect_dense
// makes: every real column in ascending order, a later column wins only
// when strictly closer (argmin's first minimum), starting from the ray's
// t0 (MAX_LENGTH or a tmax), restricted to one instance's columns when
// only_instance >= 0. It writes the Hit as ops/intersect.py
// hit_from_winner builds it from the winner: dist, u, v from the same
// Moller-Trumbore arithmetic (bit for bit the torch recompute's), prim,
// instance and material from the packed record's spare words; a ray
// without a hit reports dist = t0, u = v = 0 and ids 0, and an inactive
// ray does not sweep and reports the same. A null t0 stands for
// MAX_LENGTH everywhere, a null `active` for every ray active, so the
// wrapper fills no tensor for them. On request it also writes the
// winning column (-1 for none), from which the wrapper recomputes t/u/v
// in torch when autograd needs them, as the TPU kernel's wrapper does.
//
// Bound on the card: per ray 29 B read (origin, direction, t0, active)
// and 24 B written, against 55 FP32 operations (compares included) per
// ray-triangle test of an active ray. At 36 triangles that is 1,980
// operations per 53 B, above the card's 20 operations a byte, so the FP32
// rate bounds it, not memory. Design:
//   * the block stages the packed soup through shared memory in tiles of
//     kTile triangles (a 16,384-triangle soup does not fit in 227 KB);
//     all sweeping threads read the same triangle at once (a broadcast);
//   * the block first compacts its active rays into a shared list (a
//     ballot and popc prefix, in ray order) and its first n threads sweep
//     them, so the inactive rays leave whole warps idle instead of idling
//     lanes of busy ones; a block with no active ray skips the sweep, as
//     the TPU kernel skips all-inactive ray tiles;
//   * the winner's t, u, v are taken again from one more test of its
//     triangle after the sweep, and its ids from the record, so the sweep
//     keeps only the best t and column, and the torch gather and
//     recompute of the Hit (some 50 launches a call) are gone.
#include "intersect.cuh"

namespace svgf {

constexpr int kDenseThreads = 256;
constexpr int kWarps = kDenseThreads / 32;
constexpr int kTile = 512;  // triangles per shared-memory tile: 512 x 37 B

__global__ void __launch_bounds__(kDenseThreads)
intersect_dense_kernel(const float4* __restrict__ tris, int c0, int c1, int only_instance,
                       const float* __restrict__ ro, const float* __restrict__ rd,
                       const float* __restrict__ t0, const bool* __restrict__ active, int n_rays,
                       HitOut out) {
  __shared__ float3 s_v0[kTile], s_e1[kTile], s_e2[kTile];
  __shared__ bool s_ok[kTile];
  __shared__ int s_rays[kDenseThreads];
  __shared__ int s_count[kWarps];
  const int i = blockIdx.x * kDenseThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool act = i < n_rays && (active == nullptr || active[i]);
  if (i < n_rays && !act) write_hit(out, i, t0 ? t0[i] : kMaxLength, 0.f, 0.f, 0, 0, 0, -1);

  // compact the active rays: list slot = active rays of earlier warps +
  // active lanes below this one
  const unsigned ballot = __ballot_sync(0xffffffffu, act);
  if (lane == 0) s_count[warp] = __popc(ballot);
  __syncthreads();
  int slot = __popc(ballot & ((1u << lane) - 1u)), n_act = 0;
  for (int w = 0; w < kWarps; ++w) {
    slot += w < warp ? s_count[w] : 0;
    n_act += s_count[w];
  }
  if (act) s_rays[slot] = i;
  __syncthreads();
  if (n_act == 0) return;  // the same for every thread of the block

  const bool mine = threadIdx.x < n_act;
  const int ray = mine ? s_rays[threadIdx.x] : 0;
  const float3 o = mine ? load3(ro, ray) : make_float3(0.f, 0.f, 0.f);
  const float3 d = mine ? load3(rd, ray) : make_float3(0.f, 0.f, 1.f);
  float best = mine && t0 ? t0[ray] : kMaxLength;
  const float start = best;
  int col = -1;
  for (int base = c0; base < c1; base += kTile) {
    const int n = min(kTile, c1 - base);
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < n; k += kDenseThreads) {
      const Tri t = load_tri(tris, base + k);
      s_v0[k] = t.v0;
      s_e1[k] = t.e1;
      s_e2[k] = t.e2;
      s_ok[k] = only_instance < 0 || t.inst == only_instance;
    }
    __syncthreads();
    if (!mine) continue;  // a thread past the list only helps stage
    for (int k = 0; k < n; ++k) {
      if (!s_ok[k]) continue;
      const float t = mt_hit(o, d, s_v0[k], s_e1[k], s_e2[k]);
      if (t < best) {
        best = t;
        col = base + k;
      }
    }
  }
  if (mine) write_winner(out, ray, tris, o, d, best, start, col);
}

}  // namespace svgf

extern "C" int svgf_intersect_dense(const float4* tris, const float* ro, const float* rd,
                                    const float* t0, const bool* active, float* dist, float* u,
                                    float* v, int* prim, int* inst, int* mat, int* col, int c0,
                                    int c1, int only_instance, int n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + svgf::kDenseThreads - 1) / svgf::kDenseThreads;
  svgf::intersect_dense_kernel<<<blocks, svgf::kDenseThreads, 0, (cudaStream_t)stream>>>(
      tris, c0, c1, only_instance, ro, rd, t0, active, n_rays,
      svgf::HitOut{dist, u, v, prim, inst, mat, col});
  return (int)cudaGetLastError();
}
