// K3: one a-trous wavelet step (reference Filter.cuh:527-624).
//
// Replaces svgf_tpu/kernels/planar.py atrous_chain_planar_v2 (kernel
// _atrous_planar_kernel, one pallas_call per step). It computes what the
// plain svgf_tpu_torch/render/svgf.py atrous_iteration computes: a 5x5
// edge-stopping filter dilated by `step`, taps [1, 2/3, 1/6], variance
// through squared weights over sumW^2, the centre pre-added at weight 1,
// and invalid-depth pixels passed through. The wrapper launches it once
// per step and ping-pongs two buffers, keeping iteration 0's output.
//
// Bound on the card: memory and L2. A pixel reads 25 taps of 32 B
// (colour, depth, normal) and writes 16 B, with ~40 flops per tap. One
// thread per pixel; the taps of neighbouring threads are neighbours too,
// so a warp's tap reads coalesce and the 5 rows of a block stay in cache.
#include "common.cuh"

namespace svgf {

__global__ void atrous_kernel(const float* __restrict__ in, const float* __restrict__ depth,
                              const float* __restrict__ deriv, const float* __restrict__ normal,
                              float* __restrict__ out, int h, int w, int step, float phi_colour,
                              float phi_normal, int squarings) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const long p = (long)r * w + c;

  float center[4];
  for (int k = 0; k < 4; ++k) center[k] = clamp01(in[p * 4 + k]);  // imageLoad clamps (:543)
  const float z = get_depth(depth[p]);
  if (z >= kInvalidDepth) {  // invalid depth -> pass-through (:554-558)
    for (int k = 0; k < 4; ++k) out[p * 4 + k] = center[k];
    return;
  }
  const float l_center = luminance(center[0], center[1], center[2]);
  const float phi_l = phi_colour * sqrtf(max_nan(SVGF_F(1e-10) + center[3], 0.f));
  const float phi_depth = max_nan(deriv[p], SVGF_F(1e-6)) * (float)step;
  const float* n = normal + p * 3;
  const double kernel_1d[3] = {1.0, 2.0 / 3.0, 1.0 / 6.0};  // Filter.cuh:540

  // centre pre-accumulated with weight 1 (:565-568)
  float sum_w = 1.f;
  float s0 = center[0], s1 = center[1], s2 = center[2], s3 = center[3];
#pragma unroll
  for (int dy = -2; dy <= 2; ++dy) {
#pragma unroll
    for (int dx = -2; dx <= 2; ++dx) {
      if (dx == 0 && dy == 0) continue;
      const int rr = r + dy * step, cc = c + dx * step;
      if (rr < 0 || rr >= h || cc < 0 || cc >= w) continue;
      const long q = (long)rr * w + cc;
      const float kern = (float)(kernel_1d[dx < 0 ? -dx : dx] * kernel_1d[dy < 0 ? -dy : dy]);
      const float dist = (float)sqrt((double)(dx * dx + dy * dy));
      const float pr = clamp01(in[q * 4 + 0]), pg = clamp01(in[q * 4 + 1]);
      const float pb = clamp01(in[q * 4 + 2]), pa = clamp01(in[q * 4 + 3]);
      const float wgt =
          compute_weight(z, get_depth(depth[q]), phi_depth * dist, dot3(n, normal + q * 3),
                         phi_normal, squarings, l_center, luminance(pr, pg, pb), phi_l) *
          kern;
      sum_w = sum_w + wgt;
      s0 = s0 + wgt * pr;
      s1 = s1 + wgt * pg;
      s2 = s2 + wgt * pb;
      s3 = s3 + (wgt * wgt) * pa;  // variance uses squared weights (:606-608)
    }
  }
  out[p * 4 + 0] = s0 / sum_w;
  out[p * 4 + 1] = s1 / sum_w;
  out[p * 4 + 2] = s2 / sum_w;
  out[p * 4 + 3] = s3 / (sum_w * sum_w);
}

}  // namespace svgf

extern "C" int svgf_atrous_step(const float* in, const float* depth, const float* deriv,
                                const float* normal, float* out, int h, int w, int step,
                                float phi_colour, float phi_normal, int squarings, void* stream) {
  svgf::atrous_kernel<<<svgf::grid_for(h, w), dim3(svgf::kBlockX, svgf::kBlockY), 0,
                        (cudaStream_t)stream>>>(in, depth, deriv, normal, out, h, w, step,
                                                phi_colour, phi_normal, squarings);
  return (int)cudaGetLastError();
}
