// K2: spatial moments fallback (reference Filter.cuh:430-525).
//
// Replaces svgf_tpu/kernels/planar.py moments_planar (kernel
// _moments_planar_kernel). It computes what the plain
// svgf_tpu_torch/render/svgf.py filter_moments computes: pixels with
// history < 4 and a valid depth get a 7x7 cross-bilateral estimate of
// colour and moments with a 4/h variance boost; the others pass through.
//
// Bound on the card: memory for the pass-through pixels (16 B colour +
// 4 B history + 4 B depth read, 16 B written); the fallback pixels, a
// disoccluded minority in steady state, read 49 taps of 40 B each, which
// neighbouring threads share through L1/L2. One thread per pixel; taps
// outside the image are skipped, which is what the plain version's zero
// weight does.
#include "common.cuh"

namespace svgf {

__global__ void moments_kernel(const float* __restrict__ color, const float* __restrict__ moments,
                               const float* __restrict__ depth, const float* __restrict__ deriv,
                               const float* __restrict__ normal, const int* __restrict__ hist,
                               float* __restrict__ out, int h, int w, float phi_colour,
                               float phi_normal, int squarings) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const long p = (long)r * w + c;

  const float z = get_depth(depth[p]);
  const int hl = hist[p];
  if (!(hl < 4 && z < kInvalidDepth)) {
    for (int k = 0; k < 4; ++k) out[p * 4 + k] = color[p * 4 + k];
    return;
  }
  const float l_center = luminance(color[p * 4 + 0], color[p * 4 + 1], color[p * 4 + 2]);
  const float phi_depth = max_nan(deriv[p], SVGF_F(1e-8)) * 3.f;
  const float* n = normal + p * 3;

  float sum_w = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, sm0 = 0.f, sm1 = 0.f;
  #pragma unroll
  for (int dy = -3; dy <= 3; ++dy) {
    const int rr = r + dy;
    if (rr < 0 || rr >= h) continue;
    #pragma unroll
    for (int dx = -3; dx <= 3; ++dx) {
      const int cc = c + dx;
      if (cc < 0 || cc >= w) continue;
      const long q = (long)rr * w + cc;
      const float dist = (float)sqrt((double)(dx * dx + dy * dy));
      const float ir = color[q * 4 + 0], ig = color[q * 4 + 1], ib = color[q * 4 + 2];
      const float wgt =
          compute_weight(z, get_depth(depth[q]), phi_depth * dist, dot3(n, normal + q * 3),
                         phi_normal, squarings, l_center, luminance(ir, ig, ib), phi_colour);
      sum_w = sum_w + wgt;
      s0 = s0 + ir * wgt;
      s1 = s1 + ig * wgt;
      s2 = s2 + ib * wgt;
      sm0 = sm0 + moments[q * 2 + 0] * wgt;
      sm1 = sm1 + moments[q * 2 + 1] * wgt;
    }
  }
  sum_w = max_nan(sum_w, SVGF_F(1e-6));
  const float f_m0 = sm0 / sum_w;
  const float f_m1 = sm1 / sum_w;
  const float hh = max_nan((float)hl, 1.f);
  out[p * 4 + 0] = s0 / sum_w;
  out[p * 4 + 1] = s1 / sum_w;
  out[p * 4 + 2] = s2 / sum_w;
  out[p * 4 + 3] = (f_m1 - f_m0 * f_m0) * (4.f / hh);
}

}  // namespace svgf

extern "C" int svgf_moments(const float* color, const float* moments, const float* depth,
                            const float* deriv, const float* normal, const int* hist, float* out,
                            int h, int w, float phi_colour, float phi_normal, int squarings,
                            void* stream) {
  svgf::moments_kernel<<<svgf::grid_for(h, w), dim3(svgf::kBlockX, svgf::kBlockY), 0,
                         (cudaStream_t)stream>>>(color, moments, depth, deriv, normal, hist, out,
                                                 h, w, phi_colour, phi_normal, squarings);
  return (int)cudaGetLastError();
}
