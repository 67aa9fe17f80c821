// K1 and K7: temporal reprojection + EMA (reference Filter.cuh:359-404,
// 225-258).
//
// K1 replaces svgf_tpu/kernels/planar.py temporal_planar (kernel
// _temporal_planar_kernel_full). It computes what the plain
// svgf_tpu_torch/render/svgf.py temporal_filter computes, on (H, W, C)
// tensors: the previous frame is gathered at pixel + trunc(motion) with no
// bound on the motion, and the previous-frame state is read at its stored
// type (fp16, bf16 or fp32).
//
// K7 replaces svgf_tpu/kernels/temporal_pallas.py temporal_filter_pallas
// on the row-sharded route; plain version svgf.temporal_filter_band. The
// same thread computes one pixel of a band whose first row is global
// `row0` of an `h_total`-row image, from a window of the previous state
// that starts at global row `prev_row0` (row0 - BOUND_Y: the band and the
// BOUND_Y halo rows its neighbours sent). A target is gathered only when
// it is on the screen and |my| <= bound_y, |mx| <= bound_x; other motion
// is a disocclusion. The window is read in place at its stored type: no
// packed planes, no padding pass.
//
// Bound on the card: memory. A pixel reads 40 B of the current frame and
// 28 B (fp16 or bf16 state) of the previous one, and writes 29 B, with ~60
// flops.
// One thread per pixel; neighbouring threads read neighbouring pixels, and
// the reprojected reads stay coalesced where motion is smooth.
#include "common.cuh"

namespace svgf {

template <typename S>
__global__ void temporal_kernel(const float* __restrict__ cur, const float* __restrict__ depth,
                                const float* __restrict__ normal, const int* __restrict__ inst,
                                const float* __restrict__ motion, const S* __restrict__ prev_color,
                                const S* __restrict__ prev_depth, const S* __restrict__ prev_normal,
                                const int* __restrict__ prev_inst, const S* __restrict__ prev_moments,
                                const int* __restrict__ prev_hist, float* __restrict__ out_color,
                                float* __restrict__ out_moments, int* __restrict__ out_hist,
                                unsigned char* __restrict__ out_valid, int h, int w,
                                float depth_threshold, float normal_threshold, int hist_base,
                                int row0, int h_total, int prev_row0, int prev_rows, int bound_y,
                                int bound_x) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const long p = (long)r * w + c;

  const float cr = clamp01(cur[p * 3 + 0]);
  const float cg = clamp01(cur[p * 3 + 1]);
  const float cb = clamp01(cur[p * 3 + 2]);

  // ivec2 cast truncates toward zero (Filter.cuh:232); motion is (x, y)
  const int mx = (int)motion[p * 2 + 0];
  const int my = (int)motion[p * 2 + 1];
  const int px = c + mx;
  const int gy = row0 + r + my;  // the target's global row
  const int py = gy - prev_row0;  // its row in the prev window
  bool on_screen = px >= 0 && px < w && gy >= 0 && gy < h_total && py >= 0 && py < prev_rows;
  if (bound_y >= 0)  // K7's motion bound (temporal_pallas.py:87)
    on_screen = on_screen && my >= -bound_y && my <= bound_y && mx >= -bound_x && mx <= bound_x;
  const long q = (long)min(max(py, 0), prev_rows - 1) * w + min(max(px, 0), w - 1);

  const float z_cur = get_depth(depth[p]);
  const float z_prev = get_depth(load(prev_depth, q));
  const bool depth_ok = fabsf(z_prev - z_cur) <= depth_threshold;
  const bool mesh_ok = (float)inst[p] == (float)prev_inst[q];
  const float n_prev[3] = {load(prev_normal, q * 3 + 0), load(prev_normal, q * 3 + 1),
                           load(prev_normal, q * 3 + 2)};
  const bool normal_ok = dot3(normal + p * 3, n_prev) >= normal_threshold;
  const bool valid = on_screen && depth_ok && mesh_ok && normal_ok;

  const int history = valid ? min(prev_hist[q] + 1, hist_base) : 1;
  const float alpha = valid ? 1.f / (float)history : 1.f;

  const float lum = luminance(cr, cg, cb);
  const float m0p = valid ? load(prev_moments, q * 2 + 0) : 0.f;
  const float m1p = valid ? load(prev_moments, q * 2 + 1) : 0.f;
  const float m0 = m0p + (lum - m0p) * alpha;
  const float m1 = m1p + (lum * lum - m1p) * alpha;
  const float variance = max_nan(m1 - m0 * m0, 0.f);

  const float pr = valid ? clamp01(load(prev_color, q * 4 + 0)) : 0.f;
  const float pg = valid ? clamp01(load(prev_color, q * 4 + 1)) : 0.f;
  const float pb = valid ? clamp01(load(prev_color, q * 4 + 2)) : 0.f;

  out_color[p * 4 + 0] = clamp01(pr + (cr - pr) * alpha);
  out_color[p * 4 + 1] = clamp01(pg + (cg - pg) * alpha);
  out_color[p * 4 + 2] = clamp01(pb + (cb - pb) * alpha);
  out_color[p * 4 + 3] = clamp01(variance);
  out_moments[p * 2 + 0] = m0;
  out_moments[p * 2 + 1] = m1;
  out_hist[p] = history;
  out_valid[p] = valid ? 1 : 0;
}

template <typename S>
cudaError_t launch_temporal(const float* cur, const float* depth, const float* normal,
                            const int* inst, const float* motion, const S* prev_color,
                            const S* prev_depth, const S* prev_normal, const int* prev_inst,
                            const S* prev_moments, const int* prev_hist, float* out_color,
                            float* out_moments, int* out_hist, unsigned char* out_valid, int h,
                            int w, float depth_threshold, float normal_threshold, int hist_base,
                            int row0, int h_total, int prev_row0, int prev_rows, int bound_y,
                            int bound_x, cudaStream_t stream) {
  temporal_kernel<S><<<grid_for(h, w), dim3(kBlockX, kBlockY), 0, stream>>>(
      cur, depth, normal, inst, motion, prev_color, prev_depth, prev_normal, prev_inst,
      prev_moments, prev_hist, out_color, out_moments, out_hist, out_valid, h, w,
      depth_threshold, normal_threshold, hist_base, row0, h_total, prev_row0, prev_rows,
      bound_y, bound_x);
  return cudaGetLastError();
}

}  // namespace svgf

#define SVGF_TEMPORAL_ARGS(S)                                                                 \
  const float *cur, const float *depth, const float *normal, const int *inst,                \
      const float *motion, const S *prev_color, const S *prev_depth, const S *prev_normal,   \
      const int *prev_inst, const S *prev_moments, const int *prev_hist, float *out_color,   \
      float *out_moments, int *out_hist, unsigned char *out_valid, int h, int w,             \
      float depth_threshold, float normal_threshold, int hist_base

#define SVGF_TEMPORAL_PASS                                                                    \
  cur, depth, normal, inst, motion, prev_color, prev_depth, prev_normal, prev_inst,           \
      prev_moments, prev_hist, out_color, out_moments, out_hist, out_valid, h, w,             \
      depth_threshold, normal_threshold, hist_base

// K1: the whole frame, the previous state the whole frame, no motion bound.
#define SVGF_TEMPORAL_ENTRY(NAME, S)                                                          \
  extern "C" int NAME(SVGF_TEMPORAL_ARGS(S), void* stream) {                                  \
    return (int)svgf::launch_temporal<S>(SVGF_TEMPORAL_PASS, 0, h, 0, h, -1, -1,              \
                                         (cudaStream_t)stream);                               \
  }

// K7: a band of an h_total-row image and its prev window, under the bound.
#define SVGF_TEMPORAL_BAND_ENTRY(NAME, S)                                                     \
  extern "C" int NAME(SVGF_TEMPORAL_ARGS(S), int row0, int h_total, int prev_row0,            \
                      int prev_rows, int bound_y, int bound_x, void* stream) {                \
    return (int)svgf::launch_temporal<S>(SVGF_TEMPORAL_PASS, row0, h_total, prev_row0,        \
                                         prev_rows, bound_y, bound_x, (cudaStream_t)stream);  \
  }

SVGF_TEMPORAL_ENTRY(svgf_temporal_f32, float)
SVGF_TEMPORAL_ENTRY(svgf_temporal_f16, __half)
SVGF_TEMPORAL_ENTRY(svgf_temporal_bf16, __nv_bfloat16)
SVGF_TEMPORAL_BAND_ENTRY(svgf_temporal_band_f32, float)
SVGF_TEMPORAL_BAND_ENTRY(svgf_temporal_band_f16, __half)
SVGF_TEMPORAL_BAND_ENTRY(svgf_temporal_band_bf16, __nv_bfloat16)
