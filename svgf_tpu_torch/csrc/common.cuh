// Shared device helpers of the SVGF filter kernels.
//
// Every helper keeps the operation order of its plain torch version in
// svgf_tpu_torch/render/svgf.py (which keeps svgf_tpu's), and the build
// passes --fmad=false, so a kernel rounds like the plain version it is
// checked against. Constants are written as (float)(double literal): the
// double-then-float rounding that Python floats get in torch and JAX.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define SVGF_F(x) ((float)(x))

namespace svgf {

constexpr float kInvalidDepth = 1e30f;

__device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load(const __half* p, long i) { return __half2float(p[i]); }
// bf16 is f32 with its low 16 bits cut: widening it is exact.
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

// torch.minimum / torch.maximum (and amin / amax): NaN if either operand
// is NaN, one PTX instruction each (min.NaN.f32 / max.NaN.f32, sm_80 and
// later) where fminf / fmaxf would drop the NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// torch.clamp(x, 0, 1): NaN passes through.
__device__ __forceinline__ float clamp01(float x) { return x < 0.f ? 0.f : (x > 1.f ? 1.f : x); }
// torch.clamp_min(x, lo): NaN passes through.
__device__ __forceinline__ float max_nan(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return SVGF_F(0.2126) * r + SVGF_F(0.7152) * g + SVGF_F(0.0722) * b;
}

// GetDepth (Filter.cuh:199-207): depth 0 marks an invalid pixel.
__device__ __forceinline__ float get_depth(float d) { return d == 0.f ? kInvalidDepth : d; }

// x^phi_normal: `squarings` >= 0 when phi_normal is 2^squarings (the
// default 128 is 7 squarings, as the TPU kernels compute it), else powf.
// A kernel that knows the count when it is compiled passes it as
// kSquarings >= 0, and the squarings unroll: a loop of run-time length
// costs a tap of the a-trous filter more than its 7 multiplies.
template <int kSquarings = -1>
__device__ __forceinline__ float pow_normal(float x, float phi_normal, int squarings) {
  if (kSquarings >= 0) {
#pragma unroll
    for (int i = 0; i < kSquarings; ++i) x = x * x;
    return x;
  }
  if (squarings < 0) return powf(x, phi_normal);
  for (int i = 0; i < squarings; ++i) x = x * x;
  return x;
}

// Edge-stopping weight (Filter.cuh:407-427); `ndot` is dot(n_c, n_p).
template <int kSquarings = -1>
__device__ __forceinline__ float compute_weight(float z_c, float z_p, float phi_depth, float ndot,
                                                float phi_normal, int squarings, float l_c,
                                                float l_p, float phi_l) {
  float w_normal = pow_normal<kSquarings>(clamp01(ndot), phi_normal, squarings);
  float w_z = phi_depth == 0.f ? 0.f : fabsf(z_c - z_p) / phi_depth;
  float w_l = fabsf(l_c - l_p) / phi_l;
  return expf(-max_nan(w_l, 0.f) - max_nan(w_z, 0.f)) * w_normal;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// One thread per pixel on 2-D blocks.
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

inline dim3 grid_for(int h, int w) {
  return dim3((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
}

}  // namespace svgf
