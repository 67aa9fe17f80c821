// K4: TAA + sRGB, the main path's tonemap (reference Filter.cuh:288-357).
//
// Replaces svgf_tpu/kernels/planar.py taa_planar (kernel
// _taa_planar_kernel). It computes what the plain
// svgf_tpu_torch/render/svgf.py taa computes: a 0.5 mix with the history
// in squared space, clamped to a 3x3 PAL-YUV neighbourhood box (the cross
// and the full 3x3 blended) with edge-clamped borders, decoded, converted
// to sRGB and clipped to [0, 1]. The history is read at its stored type.
//
// Bound on the card: memory. A pixel reads 9 taps of 16 B (shared with
// its neighbours through L1) plus 8 B of fp16 history, and writes 16 B,
// with ~150 flops. One thread per pixel.
#include "common.cuh"

namespace svgf {

__device__ __forceinline__ void encode_pal_yuv(const float* rgb_in, float* yuv) {
  float rgb[3];
  for (int k = 0; k < 3; ++k) {
    const float x = max_nan(rgb_in[k], 0.f);
    rgb[k] = x * x;
  }
  yuv[0] = SVGF_F(0.299) * rgb[0] + SVGF_F(0.587) * rgb[1] + SVGF_F(0.114) * rgb[2];
  yuv[1] = SVGF_F(-0.14713) * rgb[0] + SVGF_F(-0.28886) * rgb[1] + SVGF_F(0.436) * rgb[2];
  yuv[2] = SVGF_F(0.615) * rgb[0] + SVGF_F(-0.51499) * rgb[1] + SVGF_F(-0.10001) * rgb[2];
}

__device__ __forceinline__ void decode_pal_yuv(const float* yuv, float* rgb) {
  rgb[0] = SVGF_F(1.0) * yuv[0] + SVGF_F(0.0) * yuv[1] + SVGF_F(1.13983) * yuv[2];
  rgb[1] = SVGF_F(1.0) * yuv[0] + SVGF_F(-0.39465) * yuv[1] + SVGF_F(-0.58060) * yuv[2];
  rgb[2] = SVGF_F(1.0) * yuv[0] + SVGF_F(2.03211) * yuv[1] + SVGF_F(0.0) * yuv[2];
  for (int k = 0; k < 3; ++k) rgb[k] = sqrtf(max_nan(rgb[k], SVGF_F(1e-12)));
}

// sRGB transfer (Filter.cuh:145-148).
__device__ __forceinline__ float to_srgb(float c) {
  c = max_nan(c, 0.f);
  const float safe = max_nan(c, SVGF_F(0.0031308));
  return c <= SVGF_F(0.0031308) ? SVGF_F(12.92) * c
                                : SVGF_F(1.055) * powf(safe, SVGF_F(1.0 / 2.4)) - SVGF_F(0.055);
}

template <typename S>
__global__ void taa_kernel(const float* __restrict__ filtered, const S* __restrict__ history,
                           float* __restrict__ out, int h, int w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const long p = (long)r * w + c;

  float last[4], in0[3];
  for (int k = 0; k < 4; ++k) last[k] = clamp01(load(history, p * 4 + k));
  for (int k = 0; k < 3; ++k) in0[k] = clamp01(filtered[p * 4 + k]);

  const float mix_rate = fminf(last[3], 0.5f);
  float aa[3];
  for (int k = 0; k < 3; ++k) {
    const float a2 = last[k] * last[k];
    aa[k] = sqrtf(max_nan(a2 + (in0[k] * in0[k] - a2) * mix_rate, SVGF_F(1e-12)));
  }

  // taps in the plain version's order: the cross first, then the diagonals
  const int taps[8][2] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0}, {1, 1}, {1, -1}, {-1, 1}, {-1, -1}};
  float min_c[3], max_c[3], min_r[3], max_r[3], yuv[3];
  encode_pal_yuv(in0, min_c);
  for (int k = 0; k < 3; ++k) max_c[k] = min_c[k];
  #pragma unroll
  for (int t = 0; t < 8; ++t) {
    // border: clamped point sampling (imageLoad coordinate clamp :73-74)
    const int rr = min(max(r + taps[t][0], 0), h - 1);
    const int cc = min(max(c + taps[t][1], 0), w - 1);
    const long q = (long)rr * w + cc;
    const float nb[3] = {clamp01(filtered[q * 4 + 0]), clamp01(filtered[q * 4 + 1]),
                         clamp01(filtered[q * 4 + 2])};
    encode_pal_yuv(nb, yuv);
    for (int k = 0; k < 3; ++k) {
      if (t < 4) {
        min_c[k] = fminf(min_c[k], yuv[k]);
        max_c[k] = fmaxf(max_c[k], yuv[k]);
      } else if (t == 4) {
        min_r[k] = yuv[k];
        max_r[k] = yuv[k];
      } else {
        min_r[k] = fminf(min_r[k], yuv[k]);
        max_r[k] = fmaxf(max_r[k], yuv[k]);
      }
    }
  }
  float aa_yuv[3], rgb[3];
  encode_pal_yuv(aa, aa_yuv);
  for (int k = 0; k < 3; ++k) {
    const float lo = 0.5f * min_c[k] + 0.5f * fminf(min_r[k], min_c[k]);
    const float hi = 0.5f * max_c[k] + 0.5f * fmaxf(max_r[k], max_c[k]);
    aa_yuv[k] = fminf(fmaxf(aa_yuv[k], lo), hi);
  }
  decode_pal_yuv(aa_yuv, rgb);
  const bool finite = isfinite(rgb[0]) && isfinite(rgb[1]) && isfinite(rgb[2]);
  for (int k = 0; k < 3; ++k) out[p * 4 + k] = clamp01(to_srgb(finite ? rgb[k] : 0.f));
  out[p * 4 + 3] = 1.f;
}

template <typename S>
cudaError_t launch_taa(const float* filtered, const S* history, float* out, int h, int w,
                       cudaStream_t stream) {
  taa_kernel<S><<<grid_for(h, w), dim3(kBlockX, kBlockY), 0, stream>>>(filtered, history, out,
                                                                       h, w);
  return cudaGetLastError();
}

}  // namespace svgf

extern "C" int svgf_taa_f32(const float* filtered, const float* history, float* out, int h, int w,
                            void* stream) {
  return (int)svgf::launch_taa<float>(filtered, history, out, h, w, (cudaStream_t)stream);
}

extern "C" int svgf_taa_f16(const float* filtered, const __half* history, float* out, int h,
                            int w, void* stream) {
  return (int)svgf::launch_taa<__half>(filtered, history, out, h, w, (cudaStream_t)stream);
}
