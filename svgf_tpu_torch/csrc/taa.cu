// K4 and K10: TAA + sRGB, the main path's tonemap (reference
// Filter.cuh:288-357).
//
// K4 replaces svgf_tpu/kernels/planar.py taa_planar (kernel
// _taa_planar_kernel); K10, the same kernel on a band extended by one edge
// row on each side, replaces svgf_tpu/kernels/taa_pallas.py taa_pallas. It
// computes what the plain svgf_tpu_torch/render/svgf.py taa computes: a 0.5
// mix with the history in squared space, clamped to a 3x3 PAL-YUV
// neighbourhood box (the cross and the full 3x3 blended) with edge-clamped
// borders, decoded, converted to sRGB and clipped to [0, 1]. The history is
// read at its stored type (fp16, bf16 or fp32).
//
// Bound on the card: memory. A pixel reads 16 B of colour and 8 B of fp16
// or bf16 history (16 B fp32) and writes 16 B. What holds it above that
// bound is its instruction count (three powf and six IEEE sqrtf a pixel,
// which keep the plain version's bits), whose execution overlaps the
// loads only in part. Design:
//   * a block of 256 threads stages a tile of kRows x kCols pixels and its
//     1-pixel edge-clamped halo once: one 16-byte load a pixel, coalesced
//     along the row. Each staged pixel is clamped to [0, 1] and encoded to
//     PAL-YUV once, and the 3 floats go to shared memory, so the 9 taps of
//     a pixel read encoded values instead of encoding 9 times;
//   * a thread then takes kRows / 8 x kCols / 32 pixels, columns 32 apart
//     (a warp reads consecutive shared words: no bank conflicts); each
//     pixel's history is one 8- or 16-byte load and its output one float4
//     store;
//   * the taps keep the plain version's order (the cross first, then the
//     diagonals) and the clamped coordinates, so every min/max sees the
//     operands of the plain version in its order, and the encodes their
//     inputs; min and max propagate NaN as torch's do (nan_min/nan_max),
//     so a NaN colour blacks out its neighbourhood as in the plain version;
//   * the output is a streaming store (nothing in the launch reads it).
// The tile is 16 x 32 (kernels/filter.py TAA_TILE): alone at 1080p it
// took 0.04763 ms against 8 x 64 0.04775, 16 x 64 0.05034 and 8 x 32
// 0.05183 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
#include "common.cuh"

namespace svgf {

constexpr int kTaaThreads = 256;  // 8 warps
constexpr int kRows = 16, kCols = 32;  // the tile a block stages

// PAL-YUV of the squared colour. The plain version clamps the colour at 0
// first; every caller here passes a colour that cannot be below 0 (a
// clamp01 output, NaN or -0 included, or a square root of at least 1e-6),
// on which that clamp returns its input bit for bit, so it is left out.
__device__ __forceinline__ void encode_pal_yuv(const float* rgb_in, float* yuv) {
  float rgb[3];
  for (int k = 0; k < 3; ++k) rgb[k] = rgb_in[k] * rgb_in[k];
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

// sRGB transfer (Filter.cuh:145-148) and the [0, 1] clip after it, on a
// decoded colour: 0, or a finite square root of at least 1e-6. The plain
// version's clamp of c at 0 returns such a c bit for bit, and its result
// is finite and at least 0 (0.0408 past the linear segment), so the clip
// is its upper bound alone; both are left out.
__device__ __forceinline__ float to_srgb01(float c) {
  const float safe = max_nan(c, SVGF_F(0.0031308));
  return fminf(c <= SVGF_F(0.0031308) ? SVGF_F(12.92) * c
                                      : SVGF_F(1.055) * powf(safe, SVGF_F(1.0 / 2.4)) - SVGF_F(0.055),
               1.f);
}

// clamp01 in two NaN-propagating instructions. It may return +0 for -0,
// where clamp01 returns -0; every value clamped here is squared, or mixed
// with +0, before it counts, so the output bits are the same.
__device__ __forceinline__ float unit(float x) { return nan_min(nan_max(x, 0.f), 1.f); }

// A pixel's 4 history channels, widened exactly to f32, in one load.
__device__ __forceinline__ float4 load4(const float* p, long i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}
__device__ __forceinline__ float4 load4(const __half* p, long i) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + i);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, long i) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + i);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename S>
__global__ void __launch_bounds__(kTaaThreads)
taa_kernel(const float4* __restrict__ filtered, const S* __restrict__ history,
           float4* __restrict__ out, int h, int w) {
  static_assert(kRows % 8 == 0 && kCols % 32 == 0, "a tile is whole warps of 32 x 8");
  constexpr int kSH = kRows + 2, kSW = kCols + 2;
  __shared__ float yuv_s[3][kSH][kSW];
  const int r0 = blockIdx.y * kRows, c0 = blockIdx.x * kCols;

  // stage: the tile and its halo, each pixel clamped (imageLoad coordinate
  // clamp :73-74, and the value clamp) and encoded once
  for (int i = threadIdx.x; i < kSH * kSW; i += kTaaThreads) {
    const int sy = i / kSW, sx = i - sy * kSW;
    const int rr = min(max(r0 - 1 + sy, 0), h - 1);
    const int cc = min(max(c0 - 1 + sx, 0), w - 1);
    const float4 v = __ldg(filtered + (long)rr * w + cc);
    const float rgb[3] = {unit(v.x), unit(v.y), unit(v.z)};
    float yuv[3];
    encode_pal_yuv(rgb, yuv);
    for (int k = 0; k < 3; ++k) yuv_s[k][sy][sx] = yuv[k];
  }
  __syncthreads();

  // taps in the plain version's order: the cross first, then the diagonals
  constexpr int taps[8][2] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0}, {1, 1}, {1, -1}, {-1, 1}, {-1, -1}};
  const int lx = threadIdx.x % 32, ly = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
    for (int i = 0; i < kCols / 32; ++i) {
      const int ty = ly + 8 * j, tx = lx + 32 * i;
      const int r = r0 + ty, c = c0 + tx;
      if (r >= h || c >= w) continue;
      const long p = (long)r * w + c;
      const float4 f = __ldg(filtered + p);
      const float4 hs = load4(history, p);
      const float last[4] = {unit(hs.x), unit(hs.y), unit(hs.z), unit(hs.w)};
      const float in0[3] = {unit(f.x), unit(f.y), unit(f.z)};

      const float mix_rate = nan_min(last[3], 0.5f);
      float aa[3];
      for (int k = 0; k < 3; ++k) {
        const float a2 = last[k] * last[k];
        aa[k] = sqrtf(max_nan(a2 + (in0[k] * in0[k] - a2) * mix_rate, SVGF_F(1e-12)));
      }

      float min_c[3], max_c[3], min_r[3], max_r[3];
      for (int k = 0; k < 3; ++k) min_c[k] = max_c[k] = yuv_s[k][ty + 1][tx + 1];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int sy = ty + 1 + taps[t][0], sx = tx + 1 + taps[t][1];
        for (int k = 0; k < 3; ++k) {
          const float y = yuv_s[k][sy][sx];
          if (t < 4) {
            min_c[k] = nan_min(min_c[k], y);
            max_c[k] = nan_max(max_c[k], y);
          } else if (t == 4) {
            min_r[k] = y;
            max_r[k] = y;
          } else {
            min_r[k] = nan_min(min_r[k], y);
            max_r[k] = nan_max(max_r[k], y);
          }
        }
      }
      float aa_yuv[3], rgb[3];
      encode_pal_yuv(aa, aa_yuv);
      for (int k = 0; k < 3; ++k) {
        const float lo = 0.5f * min_c[k] + 0.5f * nan_min(min_r[k], min_c[k]);
        const float hi = 0.5f * max_c[k] + 0.5f * nan_max(max_r[k], max_c[k]);
        aa_yuv[k] = nan_min(nan_max(aa_yuv[k], lo), hi);
      }
      decode_pal_yuv(aa_yuv, rgb);
      const bool finite = isfinite(rgb[0]) && isfinite(rgb[1]) && isfinite(rgb[2]);
      // a streaming store: nothing in this launch reads the output again
      __stcs(out + p, make_float4(to_srgb01(finite ? rgb[0] : 0.f), to_srgb01(finite ? rgb[1] : 0.f),
                                  to_srgb01(finite ? rgb[2] : 0.f), 1.f));
    }
  }
}

template <typename S>
cudaError_t launch_taa(const float* filtered, const S* history, float* out, int h, int w,
                       cudaStream_t stream) {
  const dim3 grid((w + kCols - 1) / kCols, (h + kRows - 1) / kRows);
  taa_kernel<S><<<grid, kTaaThreads, 0, stream>>>(reinterpret_cast<const float4*>(filtered),
                                                  history, reinterpret_cast<float4*>(out), h, w);
  return cudaGetLastError();
}

}  // namespace svgf

#define SVGF_TAA_ENTRY(NAME, S)                                                          \
  extern "C" int NAME(const float* filtered, const S* history, float* out, int h, int w, \
                      void* stream) {                                                    \
    return (int)svgf::launch_taa<S>(filtered, history, out, h, w, (cudaStream_t)stream);  \
  }

SVGF_TAA_ENTRY(svgf_taa_f32, float)
SVGF_TAA_ENTRY(svgf_taa_f16, __half)
SVGF_TAA_ENTRY(svgf_taa_bf16, __nv_bfloat16)
