// K2: spatial moments fallback (reference Filter.cuh:430-525), with the
// fallback pixels compacted and their taps read from shared memory.
//
// Replaces svgf_tpu/kernels/planar.py moments_planar (kernel
// _moments_planar_kernel); the same kernel serves K8
// (moments_pallas.py filter_moments_pallas) on a zero-halo band. It
// computes what the plain svgf_tpu_torch/render/svgf.py filter_moments
// computes: pixels with history < 4 and a valid depth get a 7x7
// cross-bilateral estimate of colour and moments with a 4/h variance
// boost; the others pass through.
//
// Bound on the card: memory, 40 B read (colour, history, depth; the
// fallback pixels' derivative and neighbourhoods besides) and 16 B written
// a pixel; the fallback pixels' 49 taps of ~46 FP32 operations are a
// fraction of that time even at 16% of the pixels. What held the
// one-thread-per-pixel design back is that a warp with a few scattered
// fallback lanes ran all 49 taps at a few lanes' occupancy, each tap
// loading 9 scalars and recomputing a neighbour's luminance and depth.
// Design:
//   * a block of 256 threads takes a 32 x 16 tile, two pixels a thread,
//     and first finds out (__syncthreads_or) whether any of its pixels
//     needs the fallback; a block with none only copies colour through
//     (the TPU kernel's per-cell gate);
//   * otherwise it stages the tile and its 3-pixel halo (38 x 22 points,
//     33 KB) in shared memory once: colour rgb and its luminance, moments,
//     get_depth(depth) and the normal. Taps outside the image are skipped
//     by their coordinates, as the plain version's zero weight skips them;
//   * the block compacts its fallback pixels into a shared list (a ballot
//     and popc prefix, in pixel order) and its threads run the 49 taps of
//     one listed pixel each, in full warps. Two pixels a thread make the
//     list of a scattered 16% twice as long as one a thread would (~80
//     pixels, 2.5 warps), so more warps of a block run taps, and the halo
//     staged a pixel shrinks; one and four pixels a thread were both
//     slower on the scattered test frame;
//   * the 7 squarings of the default phi_normal (128) are unrolled at
//     compile time (kSquarings = 7); any other phi_normal takes the
//     run-time loop or powf.
// A pixel's taps run in the plain version's (dy, dx) order, summed one
// after another by one thread, with the same per-tap arithmetic, so it
// rounds as before (within 5.6e-6 of the plain version: expf ulps).
#include "common.cuh"

namespace svgf {

constexpr int kRowsM = 2;  // pixels a thread: rows ty and ty + kBlockY of the tile
constexpr int kTileMY = kBlockY * kRowsM;
constexpr int kHaloM = 3;
constexpr int kStageMX = kBlockX + 2 * kHaloM, kStageMY = kTileMY + 2 * kHaloM;
constexpr int kStagedM = kStageMX * kStageMY;
constexpr int kMomentThreads = kBlockX * kBlockY;
constexpr int kMomentWarps = kMomentThreads / 32;
constexpr int kDefaultSquaringsM = 7;  // phi_normal 128, the SVGF default

// The 7x7 estimate of tile pixel (ty, tx) from the staged tile: the plain
// version's taps in its (dy, dx) order, summed one after another.
template <int kSquarings>
__device__ __forceinline__ void filter_pixel(int ty, int tx, int r0, int c0,
                                             const float4* s_col, const float4* s_nz,
                                             const float2* s_mom, const float* __restrict__ deriv,
                                             const int* __restrict__ hist, float* __restrict__ out,
                                             int h, int w, float phi_colour, float phi_normal,
                                             int squarings) {
  const int pr = r0 + ty, pc = c0 + tx;
  const long pp = (long)pr * w + pc;
  const int sc = (ty + kHaloM) * kStageMX + tx + kHaloM;
  const float4 cn = s_nz[sc];
  const float z = cn.w;
  const float l_center = s_col[sc].w;
  const float phi_depth = max_nan(deriv[pp], SVGF_F(1e-8)) * 3.f;

  float sum_w = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, sm0 = 0.f, sm1 = 0.f;
#pragma unroll
  for (int dy = -kHaloM; dy <= kHaloM; ++dy) {
    if ((unsigned)(pr + dy) >= (unsigned)h) continue;
#pragma unroll
    for (int dx = -kHaloM; dx <= kHaloM; ++dx) {
      if ((unsigned)(pc + dx) >= (unsigned)w) continue;
      const int sk = sc + dy * kStageMX + dx;
      const float dist = (float)sqrt((double)(dx * dx + dy * dy));
      const float4 qn = s_nz[sk];
      const float4 qc = s_col[sk];
      const float2 qm = s_mom[sk];
      const float ndot = cn.x * qn.x + cn.y * qn.y + cn.z * qn.z;
      const float wgt = compute_weight<kSquarings>(z, qn.w, phi_depth * dist, ndot, phi_normal,
                                                   squarings, l_center, qc.w, phi_colour);
      sum_w = sum_w + wgt;
      s0 = s0 + qc.x * wgt;
      s1 = s1 + qc.y * wgt;
      s2 = s2 + qc.z * wgt;
      sm0 = sm0 + qm.x * wgt;
      sm1 = sm1 + qm.y * wgt;
    }
  }
  sum_w = max_nan(sum_w, SVGF_F(1e-6));
  const float f_m0 = sm0 / sum_w;
  const float f_m1 = sm1 / sum_w;
  const float hh = max_nan((float)hist[pp], 1.f);
  reinterpret_cast<float4*>(out)[pp] =
      make_float4(s0 / sum_w, s1 / sum_w, s2 / sum_w, (f_m1 - f_m0 * f_m0) * (4.f / hh));
}

// compact = 0 runs the same staged kernel without the gate and the list:
// every block stages, and each thread filters its own fallback pixels in
// place (a warp at its fallback lanes' occupancy). The wrappers pass 1;
// chip_smoke.py times both on real frames.
template <int kSquarings>
__global__ void __launch_bounds__(kMomentThreads)
moments_kernel(const float* __restrict__ color, const float* __restrict__ moments,
               const float* __restrict__ depth, const float* __restrict__ deriv,
               const float* __restrict__ normal, const int* __restrict__ hist,
               float* __restrict__ out, int h, int w, float phi_colour, float phi_normal,
               int squarings, int compact) {
  __shared__ float4 s_col[kStagedM];  // rgb and luminance
  __shared__ float4 s_nz[kStagedM];   // normal and get_depth(depth)
  __shared__ float2 s_mom[kStagedM];
  __shared__ int s_list[kMomentThreads * kRowsM];  // tile pixels, row-major
  __shared__ int s_count[kRowsM * kMomentWarps];   // fallback pixels of each tile row

  // warp ty holds tile rows ty and ty + kBlockY, one pixel of each a lane
  const int t = threadIdx.y * kBlockX + threadIdx.x;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int c0 = blockIdx.x * kBlockX, r0 = blockIdx.y * kTileMY;
  bool fallback[kRowsM];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kRowsM; ++j) {
    const int r = r0 + threadIdx.y + j * kBlockY, c = c0 + threadIdx.x;
    fallback[j] = false;
    if (r < h && c < w) {
      const long p = (long)r * w + c;
      fallback[j] = hist[p] < 4 && get_depth(depth[p]) < kInvalidDepth;
      if (!fallback[j])
        reinterpret_cast<float4*>(out)[p] = reinterpret_cast<const float4*>(color)[p];
    }
    any = any || fallback[j];
  }
  // `compact` is the same for every thread, so all or none reach the barrier
  if (compact && !__syncthreads_or(any)) return;

  for (int k = t; k < kStagedM; k += kMomentThreads) {
    const int rr = r0 + k / kStageMX - kHaloM, cc = c0 + k % kStageMX - kHaloM;
    if (rr < 0 || rr >= h || cc < 0 || cc >= w) continue;  // out of the image: never read
    const long q = (long)rr * w + cc;
    const float4 col = reinterpret_cast<const float4*>(color)[q];
    s_col[k] = make_float4(col.x, col.y, col.z, luminance(col.x, col.y, col.z));
    s_nz[k] = make_float4(normal[q * 3 + 0], normal[q * 3 + 1], normal[q * 3 + 2],
                          get_depth(depth[q]));
    s_mom[k] = reinterpret_cast<const float2*>(moments)[q];
  }
  if (!compact) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsM; ++j)
      if (fallback[j])
        filter_pixel<kSquarings>(threadIdx.y + j * kBlockY, threadIdx.x, r0, c0, s_col, s_nz,
                                 s_mom, deriv, hist, out, h, w, phi_colour, phi_normal, squarings);
    return;
  }
  // compact the fallback pixels in pixel order: list slot = fallback
  // pixels of earlier tile rows + fallback lanes below this one
  unsigned ballot[kRowsM];
#pragma unroll
  for (int j = 0; j < kRowsM; ++j) {
    ballot[j] = __ballot_sync(0xffffffffu, fallback[j]);
    if (lane == 0) s_count[j * kBlockY + warp] = __popc(ballot[j]);
  }
  __syncthreads();
  int n_fb = 0;
  for (int k = 0; k < kRowsM * kMomentWarps; ++k) n_fb += s_count[k];
#pragma unroll
  for (int j = 0; j < kRowsM; ++j) {
    int slot = __popc(ballot[j] & ((1u << lane) - 1u));
    for (int k = 0; k < j * kBlockY + warp; ++k) slot += s_count[k];
    if (fallback[j]) s_list[slot] = t + j * kMomentThreads;
  }
  __syncthreads();

  for (int i = t; i < n_fb; i += kMomentThreads) {
    const int tp = s_list[i];
    filter_pixel<kSquarings>(tp / kBlockX, tp % kBlockX, r0, c0, s_col, s_nz, s_mom, deriv, hist,
                             out, h, w, phi_colour, phi_normal, squarings);
  }
}

}  // namespace svgf

extern "C" int svgf_moments(const float* color, const float* moments, const float* depth,
                            const float* deriv, const float* normal, const int* hist, float* out,
                            int h, int w, float phi_colour, float phi_normal, int squarings,
                            int compact, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  auto kernel = squarings == svgf::kDefaultSquaringsM ? svgf::moments_kernel<svgf::kDefaultSquaringsM>
                                                      : svgf::moments_kernel<-1>;
  const dim3 grid((w + svgf::kBlockX - 1) / svgf::kBlockX, (h + svgf::kTileMY - 1) / svgf::kTileMY);
  kernel<<<grid, dim3(svgf::kBlockX, svgf::kBlockY), 0, (cudaStream_t)stream>>>(
      color, moments, depth, deriv, normal, hist, out, h, w, phi_colour, phi_normal, squarings,
      compact);
  return (int)cudaGetLastError();
}
