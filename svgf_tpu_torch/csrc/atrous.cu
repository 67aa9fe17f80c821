// K3: one a-trous wavelet step (reference Filter.cuh:527-624), staged
// through shared memory on the dilated lattice.
//
// Replaces svgf_tpu/kernels/planar.py atrous_chain_planar_v2 (kernel
// _atrous_planar_kernel, one pallas_call per step); the same kernel serves
// K9b (atrous_pallas.py atrous_iteration_pallas) on a zero-halo band. It
// computes what the plain svgf_tpu_torch/render/svgf.py atrous_iteration
// computes: a 5x5 edge-stopping filter dilated by `step`, taps
// [1, 2/3, 1/6], variance through squared weights over sumW^2, the centre
// pre-added at weight 1, out-of-frame taps skipped, and invalid-depth
// pixels passed through. The wrapper launches it once per step and
// ping-pongs two buffers, keeping iteration 0's output.
//
// Bound on the card: per pixel 32 B read (colour, depth, derivative,
// normal) and 16 B written, against 24 taps of ~52 FP32 operations (an
// expf and two IEEE divisions among them) for a valid-depth pixel: ~26
// operations a byte, above the card's 20, so the FP32 rate bounds it; the
// divisions' and expf's instruction sequences make instruction issue,
// not memory, the limit in practice. Design:
//   * pixel (r, c) reads only pixels (r + i*step, c + j*step), so a step
//     of width `step` is step^2 independent step-1 filters, one on each
//     lattice img[a::step, b::step] (phi_depth keeps its factor `step`);
//   * a block takes a 32 x 16 tile of one lattice and stages the tile and
//     its 2-point halo (36 x 20 points) into shared memory once: the
//     clamped colour, its luminance, get_depth(depth) and the normal. The
//     24 taps then read shared memory, and a neighbour's clamp and
//     luminance are computed once per staged point instead of by each of
//     the 24 threads that read it. The halo costs the same at step 16 as
//     at step 1, where a plain 2-D tile would need a 2*step halo;
//   * each thread filters two points of the tile (rows ti and ti + 8),
//     so a staged point serves 1.41 outputs' worth of loads, not 1.69;
//   * blocks take the residues (a, b) fastest, so the blocks in flight
//     together stage neighbouring pixels, and the sectors one lattice's
//     strided loads leave unread serve its neighbours' from L2;
//   * the 7 squarings of the default phi_normal (128) are unrolled at
//     compile time (kSquarings = 7); any other phi_normal takes the
//     run-time loop or powf.
// The per-tap arithmetic and the tap order are the plain version's, so a
// tap rounds as there.
#include "common.cuh"

namespace svgf {

constexpr int kLatX = 32, kLatY = 16;  // lattice points a block filters
constexpr int kRowsPerThread = 2;
constexpr int kHalo = 2;
constexpr int kStageX = kLatX + 2 * kHalo, kStageY = kLatY + 2 * kHalo;
constexpr int kStaged = kStageX * kStageY;
constexpr int kAtrousThreads = kLatX * kLatY / kRowsPerThread;
constexpr int kDefaultSquarings = 7;  // phi_normal 128, the SVGF default

template <int kSquarings>
__global__ void __launch_bounds__(kAtrousThreads)
atrous_kernel(const float* __restrict__ in, const float* __restrict__ depth,
              const float* __restrict__ deriv, const float* __restrict__ normal,
              float* __restrict__ out, int h, int w, int step, float phi_colour,
              float phi_normal, int squarings, int res_w, int tiles_x, int n_res) {
  __shared__ float4 s_col[kStaged];  // clamped colour (imageLoad clamps, :543)
  __shared__ float s_lum[kStaged], s_z[kStaged], s_nx[kStaged], s_ny[kStaged], s_nz[kStaged];

  // block -> (tile, residue); lattice point (i, j) of residue (a, b) is
  // pixel (a + i * step, b + j * step)
  const int res = blockIdx.x % n_res, tile = blockIdx.x / n_res;
  const int a = res / res_w, b = res % res_w;
  const int h_lat = (h - a + step - 1) / step, w_lat = (w - b + step - 1) / step;
  const int i0 = tile / tiles_x * kLatY, j0 = tile % tiles_x * kLatX;

  for (int k = threadIdx.x; k < kStaged; k += kAtrousThreads) {
    const int li = i0 + k / kStageX - kHalo, lj = j0 + k % kStageX - kHalo;
    if (li < 0 || li >= h_lat || lj < 0 || lj >= w_lat) continue;  // out of frame: never read
    const long q = (long)(a + li * step) * w + (b + lj * step);
    const float4 col = make_float4(clamp01(in[q * 4 + 0]), clamp01(in[q * 4 + 1]),
                                   clamp01(in[q * 4 + 2]), clamp01(in[q * 4 + 3]));
    s_col[k] = col;
    s_lum[k] = luminance(col.x, col.y, col.z);
    s_z[k] = get_depth(depth[q]);
    s_nx[k] = normal[q * 3 + 0];
    s_ny[k] = normal[q * 3 + 1];
    s_nz[k] = normal[q * 3 + 2];
  }
  __syncthreads();

  const int tj = threadIdx.x % kLatX;
#pragma unroll 1
  for (int row = 0; row < kRowsPerThread; ++row) {
    const int ti = threadIdx.x / kLatX + row * (kLatY / kRowsPerThread);
    const int li = i0 + ti, lj = j0 + tj;
    if (li >= h_lat || lj >= w_lat) continue;
    const long p = (long)(a + li * step) * w + (b + lj * step);
    const int sc = (ti + kHalo) * kStageX + tj + kHalo;
    const float4 center = s_col[sc];
    const float z = s_z[sc];
    if (z >= kInvalidDepth) {  // invalid depth -> pass-through (:554-558)
      out[p * 4 + 0] = center.x;
      out[p * 4 + 1] = center.y;
      out[p * 4 + 2] = center.z;
      out[p * 4 + 3] = center.w;
      continue;
    }
    const float l_center = s_lum[sc];
    const float phi_l = phi_colour * sqrtf(max_nan(SVGF_F(1e-10) + center.w, 0.f));
    const float phi_depth = max_nan(deriv[p], SVGF_F(1e-6)) * (float)step;
    const float nx = s_nx[sc], ny = s_ny[sc], nz = s_nz[sc];
    const double kernel_1d[3] = {1.0, 2.0 / 3.0, 1.0 / 6.0};  // Filter.cuh:540

    // centre pre-accumulated with weight 1 (:565-568)
    float sum_w = 1.f;
    float s0 = center.x, s1 = center.y, s2 = center.z, s3 = center.w;
#pragma unroll
    for (int dy = -2; dy <= 2; ++dy) {
#pragma unroll
      for (int dx = -2; dx <= 2; ++dx) {
        if (dx == 0 && dy == 0) continue;
        // out of the lattice is out of the frame
        if ((unsigned)(li + dy) >= (unsigned)h_lat || (unsigned)(lj + dx) >= (unsigned)w_lat)
          continue;
        const int sk = sc + dy * kStageX + dx;
        const float kern = (float)(kernel_1d[dx < 0 ? -dx : dx] * kernel_1d[dy < 0 ? -dy : dy]);
        const float dist = (float)sqrt((double)(dx * dx + dy * dy));
        const float ndot = nx * s_nx[sk] + ny * s_ny[sk] + nz * s_nz[sk];
        const float wgt =
            compute_weight<kSquarings>(z, s_z[sk], phi_depth * dist, ndot, phi_normal, squarings,
                                       l_center, s_lum[sk], phi_l) *
            kern;
        const float4 pc = s_col[sk];
        sum_w = sum_w + wgt;
        s0 = s0 + wgt * pc.x;
        s1 = s1 + wgt * pc.y;
        s2 = s2 + wgt * pc.z;
        s3 = s3 + (wgt * wgt) * pc.w;  // variance uses squared weights (:606-608)
      }
    }
    out[p * 4 + 0] = s0 / sum_w;
    out[p * 4 + 1] = s1 / sum_w;
    out[p * 4 + 2] = s2 / sum_w;
    out[p * 4 + 3] = s3 / (sum_w * sum_w);
  }
}

}  // namespace svgf

// The grid (blocks, res_w, tiles_x, n_res) comes from the wrapper
// (kernels/filter.py atrous_lattice_grid): n_res residues of res_w a row,
// each lattice cut into tiles of kLatY x kLatX points, tiles_x a row.
extern "C" int svgf_atrous_step(const float* in, const float* depth, const float* deriv,
                                const float* normal, float* out, int h, int w, int step,
                                float phi_colour, float phi_normal, int squarings, int blocks,
                                int res_w, int tiles_x, int n_res, void* stream) {
  if (blocks <= 0) return 0;
  auto kernel = squarings == svgf::kDefaultSquarings ? svgf::atrous_kernel<svgf::kDefaultSquarings>
                                                     : svgf::atrous_kernel<-1>;
  kernel<<<blocks, svgf::kAtrousThreads, 0, (cudaStream_t)stream>>>(
      in, depth, deriv, normal, out, h, w, step, phi_colour, phi_normal, squarings, res_w,
      tiles_x, n_res);
  return (int)cudaGetLastError();
}
