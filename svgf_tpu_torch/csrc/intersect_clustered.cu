// K6: nearest ray-triangle hit for scenes over 16,384 world triangles (the
// 104,884-triangle stress terrain), by a per-thread walk of the stitched
// world-space scene BVH.
//
// Replaces svgf_tpu/kernels/intersect_pallas.py intersect_clustered_pallas
// (_intersect_rays_clustered, kernel _kernel_clustered, _slab_hits,
// _mt_rows). The TPU kernel culls 4,096-ray tiles against supercluster and
// cluster boxes and runs dense Moller-Trumbore on the clusters left,
// because divergent pointer chasing does not map to its vector unit. On
// Hopper a thread can chase pointers, so this is the reference's own GPU
// design (PathTrace.cuh:90-142) in svgf_tpu's stackless form: the walk of
// svgf_tpu_torch/ops/intersect.py traverse_scene_bvh, one ray per thread,
// state = one node index and the running best. At a node: the slab test
// of ray_aabb_comp (NaN-propagating min/max, as torch.minimum/maximum)
// against the best so far; on a hit descend to node + 1 or test the
// leaf's triangle, else follow the skip link. On equal t the lower soup
// column wins, the choice of the dense sweep and of the TPU kernel. Same
// output contract as K5: best t and winning column (-1 for none); an
// inactive ray does not walk.
//
// Bound on the card: the rays' I/O (29 B read, 8 B written a ray) and the
// scene (32 B a node, 48 B a triangle) read once, against 28 FP32
// operations a node visit and 55 a triangle test; the visits depend on
// the data (chip_smoke.py counts them on a sample through `stats`). The
// 6.7 MB node array and 5.1 MB soup of the stress terrain stay in the
// 50 MB L2. Design: a node is one 32-byte record, two 16-byte loads
// (lo.xyz + skip, hi.xyz + leaf), and a triangle three 16-byte loads;
// rays come in 64x64-pixel blocks (render/pathtrace.py make_block_order),
// so the threads of a warp walk nearly the same nodes.
#include "intersect.cuh"

namespace svgf {

constexpr int kWalkThreads = 128;

// torch.minimum / torch.maximum: NaN if either operand is NaN (fminf and
// fmaxf would return the other operand).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__global__ void __launch_bounds__(kWalkThreads)
intersect_bvh_kernel(const float4* __restrict__ nodes, int n_nodes,
                     const float4* __restrict__ tris, int only_instance,
                     const float* __restrict__ ro, const float* __restrict__ rd,
                     const float* __restrict__ t0, const bool* __restrict__ active, int n_rays,
                     float* __restrict__ out_t, int* __restrict__ out_col,
                     int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  float best = t0[i];
  int col = -1, visits = 0, tests = 0;
  if (active[i]) {
    const float3 o = load3(ro, i), d = load3(rd, i);
    const float3 inv = make_float3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
    int node = 0;
    while (node < n_nodes) {
      ++visits;
      const float4 a = __ldg(nodes + 2 * node), b = __ldg(nodes + 2 * node + 1);
      // ray_aabb_comp (ops/geometry.py), axis by axis in its order
      float tn = -kMaxLength, tf = kMaxLength;
      float t1 = (a.x - o.x) * inv.x, t2 = (b.x - o.x) * inv.x;
      tn = nan_max(tn, nan_min(t1, t2));
      tf = nan_min(tf, nan_max(t1, t2));
      t1 = (a.y - o.y) * inv.y;
      t2 = (b.y - o.y) * inv.y;
      tn = nan_max(tn, nan_min(t1, t2));
      tf = nan_min(tf, nan_max(t1, t2));
      t1 = (a.z - o.z) * inv.z;
      t2 = (b.z - o.z) * inv.z;
      tn = nan_max(tn, nan_min(t1, t2));
      tf = nan_min(tf, nan_max(t1, t2));
      const bool box = tf >= tn && tn < best && tf > 0.f && tn < kMaxLength;
      const int leaf = __float_as_int(b.w);
      if (box && leaf >= 0) {
        const Tri tri = load_tri(tris, leaf);
        if (only_instance < 0 || tri.inst == only_instance) {
          ++tests;
          const float t = mt_hit(o, d, tri.v0, tri.e1, tri.e2);
          if (t < best || (t == best && col >= 0 && leaf < col)) {
            best = t;
            col = leaf;
          }
        }
      }
      node = (box && leaf < 0) ? node + 1 : __float_as_int(a.w);
    }
  }
  out_t[i] = best;
  out_col[i] = col;
  if (stats != nullptr) {
    stats[2 * i] = visits;
    stats[2 * i + 1] = tests;
  }
}

}  // namespace svgf

extern "C" int svgf_intersect_bvh(const float4* nodes, const float4* tris, const float* ro,
                                  const float* rd, const float* t0, const bool* active,
                                  float* out_t, int* out_col, int* stats, int n_nodes,
                                  int only_instance, int n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + svgf::kWalkThreads - 1) / svgf::kWalkThreads;
  svgf::intersect_bvh_kernel<<<blocks, svgf::kWalkThreads, 0, (cudaStream_t)stream>>>(
      nodes, n_nodes, tris, only_instance, ro, rd, t0, active, n_rays, out_t, out_col, stats);
  return (int)cudaGetLastError();
}
