// K6: nearest ray-triangle hit for scenes over 16,384 world triangles (the
// 104,884-triangle stress terrain), by a per-thread nearest-first walk of
// the stitched world-space scene BVH, written as the whole Hit record.
//
// Replaces svgf_tpu/kernels/intersect_pallas.py intersect_clustered_pallas
// (_intersect_rays_clustered, kernel _kernel_clustered, _slab_hits,
// _mt_rows). The TPU kernel culls 4,096-ray tiles against supercluster and
// cluster boxes and runs dense Moller-Trumbore on the clusters left,
// because divergent pointer chasing does not map to its vector unit. On
// Hopper a thread chases pointers: one ray a thread walks the scene BVH,
// the reference's own GPU design (PathTrace.cuh:90-142). It finds the hit
// the plain svgf_tpu_torch/ops/intersect.py traverse_scene_bvh finds: the
// slab test of ray_aabb_comp (in its operation order, NaN-propagating
// min/max as torch.minimum/maximum) against the best t so far, the same
// Moller-Trumbore arithmetic, `only_instance` as a leaf filter, and on
// equal t the lower soup column. Only the order of the visits differs, so
// the winner may differ on an exact tie alone.
//
// Output: the Hit as ops/intersect.py hit_from_winner builds it (see
// intersect.cuh write_winner), so the wrapper runs no torch work after the
// launch; on request also the winning column, from which the wrapper
// recomputes t/u/v in torch when autograd needs them. A null t0 stands for
// MAX_LENGTH, a null `active` for every ray active. An inactive ray does
// not walk and reports dist = t0.
//
// Bound on the card: the rays' I/O (29 B read, 24 B written a ray) and the
// scene read once, against 28 FP32 operations a box test and 55 a
// triangle test; the visits depend on the data (`stats` counts them). The
// tree (6.7 MB) and the soup (5.1 MB) of the terrain stay in the 50 MB L2,
// so a walk is a chain of dependent L2 loads and the instructions around
// them, and it ends with the warp's longest walk. Design:
//   * the tree is repacked once per scene (kernels/intersect.py
//     packed_scene) into child-pair records of 64 B: both children's boxes
//     and references, four 16-byte loads issued together. Record 0 is a
//     virtual parent holding the root's box beside an empty (NaN) box, so
//     the root's box is tested as the skip-link walk tests it. A child
//     that is a one-triangle leaf is referenced by ~(its soup column), so
//     a leaf costs no node fetch;
//   * the walk tests both children of a record, goes to the nearer child
//     that is hit and pushes the other with its entry distance on a
//     per-thread stack; a popped entry whose entry distance is no longer
//     below the best is skipped. Nearest first, the first hit found is
//     usually the nearest, and the `tn < best` cull prunes the rest (the
//     skip-link walk visits children in build order and prunes only after
//     a hit in whichever subtree came first);
//   * the walk pushes at most one entry for each level it descends, so a
//     stack of the tree's depth (internal nodes on its longest root-to-leaf
//     path) always suffices. The per-thread stack holds kStack = 64 entries
//     (kernels/intersect.py BVH_STACK; the terrain's tree is 21 deep): the
//     CUDA runtime reserves it for every thread the card holds (132 SMs x
//     2,048 threads x 8 B an entry: 138 MB). A deeper tree runs the kSpill
//     instantiation, which keeps the entries past the stack in a global
//     scratch of (depth - kStack) entries a ray that the wrapper sizes from
//     the depth ([entry][ray], so a warp's spills coalesce); only a ray
//     whose stack grows that deep touches it;
//   * torch.minimum/maximum's NaN rule is one PTX instruction each
//     (min.NaN.f32 / max.NaN.f32, sm_80 and later) instead of two compares,
//     an or and a select around fminf/fmaxf;
//   * the winner's t/u/v are taken from one more test of its triangle after
//     the walk and its ids from the packed record (intersect.cuh).
#include "common.cuh"
#include "intersect.cuh"

namespace svgf {

constexpr int kWalkThreads = 128;
constexpr int kStack = 64;  // entries of the per-thread stack

// ray_aabb_comp (ops/geometry.py), axis by axis in its order: the entry t,
// and in `hit` the plain walk's verdict against the best so far.
__device__ __forceinline__ float slab(float4 lo, float4 hi, float3 o, float3 inv, float best,
                                      bool& hit) {
  float tn = -kMaxLength, tf = kMaxLength;
  float t1 = (lo.x - o.x) * inv.x, t2 = (hi.x - o.x) * inv.x;
  tn = nan_max(tn, nan_min(t1, t2));
  tf = nan_min(tf, nan_max(t1, t2));
  t1 = (lo.y - o.y) * inv.y;
  t2 = (hi.y - o.y) * inv.y;
  tn = nan_max(tn, nan_min(t1, t2));
  tf = nan_min(tf, nan_max(t1, t2));
  t1 = (lo.z - o.z) * inv.z;
  t2 = (hi.z - o.z) * inv.z;
  tn = nan_max(tn, nan_min(t1, t2));
  tf = nan_min(tf, nan_max(t1, t2));
  hit = tf >= tn && tn < best && tf > 0.f && tn < kMaxLength;
  return tn;
}

// A record: (lo0.xyz, ref0), (hi0.xyz, ref1), (lo1.xyz, -), (hi1.xyz, -);
// a reference >= 0 is a record, < 0 the soup column ~ref of a leaf.
// kStack entries live in the thread's stack; with kSpill, entry e >= kStack
// lives at spill[(e - kStack) * n_rays + ray] as (reference, entry t bits).
template <bool kSpill>
__global__ void __launch_bounds__(kWalkThreads)
intersect_bvh_kernel(const float4* __restrict__ nodes, const float4* __restrict__ tris,
                     int only_instance, const float* __restrict__ ro,
                     const float* __restrict__ rd, const float* __restrict__ t0,
                     const bool* __restrict__ active, int n_rays, HitOut out,
                     int* __restrict__ stats, int2* __restrict__ spill) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float start = t0 ? t0[i] : kMaxLength;
  if (active && !active[i]) {
    write_hit(out, i, start, 0.f, 0.f, 0, 0, 0, -1);
    if (stats) stats[2 * i] = stats[2 * i + 1] = 0;
    return;
  }
  const float3 o = load3(ro, i), d = load3(rd, i);
  const float3 inv = make_float3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  float best = start;
  int col = -1, visits = 0, tests = 0;
  int stack_ref[kStack];
  float stack_t[kStack];
  int sp = 0, node = 0;
  for (;;) {
    ++visits;
    const float4* rec = nodes + 4 * node;
    const float4 lo0 = __ldg(rec), hi0 = __ldg(rec + 1), lo1 = __ldg(rec + 2),
                 hi1 = __ldg(rec + 3);
    bool h0, h1;
    const float tn0 = slab(lo0, hi0, o, inv, best, h0);
    const float tn1 = slab(lo1, hi1, o, inv, best, h1);
    // the nearer child that is hit first; on equal entry, the first child
    const bool swap = h1 && (!h0 || tn1 < tn0);
    const int near = __float_as_int(swap ? hi0.w : lo0.w);
    if (h0 && h1) {  // sp < the tree's depth: the stack, or past it the spill
      const int ref = __float_as_int(swap ? lo0.w : hi0.w);
      const float tn = swap ? tn0 : tn1;
      if (!kSpill || sp < kStack) {
        stack_ref[sp] = ref;
        stack_t[sp] = tn;
      } else {
        spill[(long)(sp - kStack) * n_rays + i] = make_int2(ref, __float_as_int(tn));
      }
      ++sp;
    }
    // the next record to visit: the near child, else the stack's top
    // entry still nearer than the best; leaves on the way are tested
    int next = near;
    bool have = h0 || h1;
    for (;;) {
      if (!have) {
        while (sp > 0) {
          --sp;
          if (kSpill && sp >= kStack) {
            const int2 e = spill[(long)(sp - kStack) * n_rays + i];
            if (__int_as_float(e.y) < best) {
              next = e.x;
              have = true;
              break;
            }
          } else if (stack_t[sp] < best) {
            next = stack_ref[sp];
            have = true;
            break;
          }
        }
        if (!have) break;
      }
      if (next >= 0) break;
      const int leaf = ~next;
      const Tri tri = load_tri(tris, leaf);
      if (only_instance < 0 || tri.inst == only_instance) {
        ++tests;
        const float t = mt_hit(o, d, tri.v0, tri.e1, tri.e2);
        if (t < best || (t == best && col >= 0 && leaf < col)) {
          best = t;
          col = leaf;
        }
      }
      have = false;
    }
    if (!have) break;
    node = next;
  }
  write_winner(out, i, tris, o, d, best, start, col);
  if (stats) {
    stats[2 * i] = visits;
    stats[2 * i + 1] = tests;
  }
}

template <bool kSpill>
cudaError_t launch_bvh(const float4* nodes, const float4* tris, const float* ro, const float* rd,
                       const float* t0, const bool* active, HitOut out, int* stats,
                       int only_instance, int n_rays, int2* spill, cudaStream_t stream) {
  const int blocks = (n_rays + kWalkThreads - 1) / kWalkThreads;
  intersect_bvh_kernel<kSpill><<<blocks, kWalkThreads, 0, stream>>>(
      nodes, tris, only_instance, ro, rd, t0, active, n_rays, out, stats, spill);
  return cudaGetLastError();
}

}  // namespace svgf

// `spill`: null for a tree no deeper than the stack, else the scratch of
// (depth - kStack) entries a ray (kernels/intersect.py spill_entries).
extern "C" int svgf_intersect_bvh(const float4* nodes, const float4* tris, const float* ro,
                                  const float* rd, const float* t0, const bool* active,
                                  float* dist, float* u, float* v, int* prim, int* inst, int* mat,
                                  int* col, int* stats, int only_instance, int n_rays,
                                  int2* spill, void* stream) {
  if (n_rays <= 0) return 0;
  const svgf::HitOut out{dist, u, v, prim, inst, mat, col};
  return (int)(spill ? svgf::launch_bvh<true>(nodes, tris, ro, rd, t0, active, out, stats,
                                              only_instance, n_rays, spill, (cudaStream_t)stream)
                     : svgf::launch_bvh<false>(nodes, tris, ro, rd, t0, active, out, stats,
                                               only_instance, n_rays, nullptr,
                                               (cudaStream_t)stream));
}
