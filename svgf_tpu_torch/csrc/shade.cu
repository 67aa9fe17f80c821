// The MIS bounce's shading: two kernels a bounce, one on each side of the
// bounce's one batched intersect (K5 or K6, or the plain sweep).
//
// Replaces no Pallas kernel: svgf_tpu's bounce (render/pathtrace.py
// _bounce_mis) is plain jnp, and so is the port's plain route
// (svgf_tpu_torch/render/pathtrace.py _bounce_mis), which launches some 870
// small kernels a bounce, one torch operation at a time over every lane,
// and held 80% of the 1080p Cornell frame. These kernels compute the same
// bounce for the scenes that ask for nothing they lack
// (svgf_tpu_torch/kernels/shade.py scene_fits: matte materials, instance
// lights, no environment, media, opacity or textures):
//
//   shade_pre   the miss, the shading point, the NEE light direction
//               (sample_lights: a uniform light, sample_discrete over its
//               triangles' CDF, a uniform point of the triangle) and the
//               cosine-hemisphere BSDF direction, each evaluated; writes
//               the shadow and BSDF rays (origin, direction, active flag)
//               into the (2R, 3) and (2R,) buffers the intersect takes,
//               and adds the rays it traces to a device counter (a warp
//               sum and one atomic a block);
//   shade_post  the shading point again, the light pdfs from the
//               intersect's shadow and BSDF hits, the power-heuristic
//               weights, the emission at both hits, the radiance and
//               weight, the new state, Russian roulette after bounce 3,
//               the dead-lane test and, after the last bounce, the final
//               finite-and-clamp step.
//
// Every value is the plain route's on the card bit for bit. The draws are
// svgf_tpu's lowbias32 hashes (ops/sampling.py RngStream) at the plain
// route's sites: 1 the light, 2 its triangle, 3-4 the point, 5 the lobe
// (unused by matte), 6-7 the BSDF direction, 8 the delta lobe (unused),
// 9 the roulette. Every expression keeps the plain route's operation order
// as torch runs it on the card: a sum over a last axis of 3 (`dot`, the
// transforms' rows) is ((x0 + x2) + 0) + (x1 + 0), as torch's reduction
// kernel takes it (two threads an output, the first summing elements 0
// and 2, each from the identity 0); a tensor divided by a Python number is
// a multiply by the number's float reciprocal, and a number divided by a
// tensor the tensor's reciprocal times the number, as torch computes
// both; sqrtf, cosf and sinf are CUDA's, as torch's are; the build passes
// --fmad=false.
//
// Bound on the card: bytes. Per lane and bounce, shade_pre reads the hit
// (24 B), the active flag (1), the direction (12) and the lane id (8), and
// writes two rays (48) and their flags (2): 95 B. shade_post reads the hit
// (24), the intersect's shadow and BSDF hits (48), the two rays (48), the
// state's radiance, weight, direction and flags (38) and writes the new
// state (50): 208 B (the origin, 12 B more, only where a lane is
// inactive; the lane id only for the roulette). 303 B a lane: 0.63 GB a
// bounce at 1080p, 0.19 ms at 3.35 TB/s. The shading point is computed
// again in shade_post from the hit instead of being stored: the hit's
// 24 B against the 32 B a normal and a material index would move out and
// back. The scene tables (1.3 KB of triangles, transforms and materials
// at the Cornell box's 36 triangles) are read through the read-only
// cache. One thread a lane, 256 a block; no shared memory but the count's.
#include <stdint.h>

#include "common.cuh"

namespace svgf {
namespace shade {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLights = 8;          // kernels/shade.py MAX_LIGHTS
constexpr float kMaxLength = 1e30f;    // ops/geometry.py MAX_LENGTH
constexpr float kPi = SVGF_F(3.14159);  // ops/geometry.py PI
constexpr int kGlass = 3;              // ops/bsdf.py GLASS
constexpr uint32_t kGolden = 0x9E3779B9u;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 make(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 zero3() { return make(0.f, 0.f, 0.f); }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return make(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return make(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return make(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return make(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 div(V3 a, float s) { return make(a.x / s, a.y / s, a.z / s); }
__device__ __forceinline__ V3 neg(V3 a) { return make(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 pick(bool c, V3 a, V3 b) { return c ? a : b; }
// (v == 0).all(-1) and (v != 0).any(-1): NaN is no zero
__device__ __forceinline__ bool all_zero(V3 a) { return a.x == 0.f && a.y == 0.f && a.z == 0.f; }
__device__ __forceinline__ bool any_nonzero(V3 a) { return !all_zero(a); }
__device__ __forceinline__ bool finite3(V3 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
}
// amax(-1): NaN wins
__device__ __forceinline__ float max3(V3 a) { return nan_max(nan_max(a.x, a.y), a.z); }
// torch.clamp_max(x, hi): NaN passes
__device__ __forceinline__ float min_nan(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// x.sum(-1) over 3 elements as torch's reduction kernel sums them on the card
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return ((x0 + x2) + 0.f) + (x1 + 0.f);
}
__device__ __forceinline__ float dot(V3 a, V3 b) { return sum3(a.x * b.x, a.y * b.y, a.z * b.z); }

// ops/geometry.py normalize: v / clamp_min(sqrt((v * v).sum(-1)), 1e-30)
__device__ __forceinline__ V3 normalize(V3 v) {
  return div(v, max_nan(sqrtf(dot(v, v)), SVGF_F(1e-30)));
}

__device__ __forceinline__ V3 load3(const float* __restrict__ p, long i) {
  return make(__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2));
}
__device__ __forceinline__ void store3(float* __restrict__ p, long i, V3 a) {
  p[3 * i] = a.x;
  p[3 * i + 1] = a.y;
  p[3 * i + 2] = a.z;
}

// ops/geometry.py transform_point / transform_vector on a row-major 4x4
__device__ __forceinline__ float row(const float* __restrict__ m, int r, V3 p) {
  return sum3(__ldg(m + 4 * r) * p.x, __ldg(m + 4 * r + 1) * p.y, __ldg(m + 4 * r + 2) * p.z);
}
__device__ __forceinline__ V3 transform_vector(const float* __restrict__ m, V3 d) {
  return make(row(m, 0, d), row(m, 1, d), row(m, 2, d));
}
__device__ __forceinline__ V3 transform_point(const float* __restrict__ m, V3 p) {
  return make(row(m, 0, p) + __ldg(m + 3), row(m, 1, p) + __ldg(m + 7),
              row(m, 2, p) + __ldg(m + 11));
}

// ops/lights.py interp: a1 * u + a2 * v + a0 * (1 - u - v) of a (T, 3, 3) table
__device__ __forceinline__ V3 interp(const float* __restrict__ attr, int prim, float u, float v) {
  const long base = 3L * prim;
  const V3 a0 = load3(attr, base), a1 = load3(attr, base + 1), a2 = load3(attr, base + 2);
  const float w0 = (1.f - u) - v;
  return add(add(scale(a1, u), scale(a2, v)), scale(a0, w0));
}

// RngStream: draw `site` of a stream with seed `seed` for a lane whose
// hash input is `lane_h` = lane * golden + 1
__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ float draw(uint32_t seed, uint32_t site, uint32_t lane_h) {
  const uint32_t s = lowbias32(site * kGolden ^ seed);
  return (float)(lowbias32(lane_h ^ s) >> 8) * SVGF_F(1.0 / 16777216.0);
}
__device__ __forceinline__ uint32_t lane_hash(long long lane) {
  return (uint32_t)lane * kGolden + 1u;
}

struct Scene {
  const float* tri_pos;                // (T, 3, 3)
  const float* tri_nrm;                // (T, 3, 3)
  const float* inst_transform;         // (I, 4, 4)
  const float* inst_normal_transform;  // (I, 4, 4)
  const float* mat_colour;             // (M, 3)
  const float* mat_emission;           // (M, 3)
  const int* mat_type;                 // (M,)
  const float* lights_cdf;             // (C,)
  const float* light_area;             // (L,)
  int n_tris, n_inst, n_mat, n_cdf, search_iters;
  int n_lights;
  // per light: instance, CDF start, CDF count, first global triangle
  int light_inst[kMaxLights], cdf_start[kMaxLights], cdf_count[kMaxLights],
      tri_start[kMaxLights];
};

struct HitIn {
  const float *dist, *u, *v;
  const int *prim, *inst, *mat;
};

struct Surface {
  V3 pos, n, out;
  int mat;
};

// pathtrace.py _shading_point without textures: the position, the normal
// flipped toward the outgoing direction (glass keeps it), the material
__device__ __forceinline__ Surface surface(const Scene& s, const HitIn& h, int i, V3 rd) {
  const int prim = clampi(h.prim[i], 0, s.n_tris - 1);
  const int inst = clampi(h.inst[i], 0, s.n_inst - 1);
  const int mat = clampi(h.mat[i], 0, s.n_mat - 1);
  const float u = h.u[i], v = h.v[i];
  Surface sf;
  sf.pos = transform_point(s.inst_transform + 16 * inst, interp(s.tri_pos, prim, u, v));
  V3 n = normalize(transform_vector(s.inst_normal_transform + 16 * inst,
                                    interp(s.tri_nrm, prim, u, v)));
  sf.out = neg(rd);
  const bool flip = dot(n, sf.out) < 0.f && __ldg(s.mat_type + mat) != kGlass;
  sf.n = pick(flip, neg(n), n);
  sf.mat = mat;
  return sf;
}

// bsdf.py eval_matte: colour / PI * |cos|, 0 across the surface
__device__ __forceinline__ V3 eval_matte(V3 colour, V3 n, V3 out, V3 in) {
  const bool ok = dot(n, in) * dot(n, out) > 0.f;
  const V3 val = scale(scale(colour, 1.f / kPi), fabsf(dot(n, in)));
  return pick(ok, val, zero3());
}

// bsdf.py _up_normal
__device__ __forceinline__ V3 up_normal(V3 n, V3 out) { return pick(dot(n, out) <= 0.f, neg(n), n); }

// bsdf.py sample_matte_pdf (sampling.py sample_hemisphere_cosine_pdf)
__device__ __forceinline__ float matte_pdf(V3 n, V3 out, V3 in) {
  const bool ok = dot(n, in) * dot(n, out) > 0.f;
  const float cosw = dot(up_normal(n, out), in);
  return ok ? (cosw <= 0.f ? 0.f : cosw * (1.f / kPi)) : 0.f;
}

// bsdf.py sample_matte: sampling.py sample_hemisphere_cosine about the up
// normal in geometry.py basis_from_z's frame
__device__ __forceinline__ V3 sample_matte(V3 n, V3 out, float r0, float r1) {
  const float z = sqrtf(r1);
  const float r = sqrtf(max_nan(1.f - z * z, 0.f));
  const float phi = SVGF_F(2.0 * 3.14159) * r0;
  const float lx = r * cosf(phi), ly = r * sinf(phi);
  const V3 bz = normalize(up_normal(n, out));
  const float sign = bz.z > 0.f ? 1.f : -1.f;
  const float a = (1.f / (sign + bz.z)) * -1.f;
  const float b = (bz.x * bz.y) * a;
  const V3 bx = make(1.f + (sign * (bz.x * bz.x)) * a, sign * b, -sign * bz.x);
  const V3 by = make(b, sign + (bz.y * bz.y) * a, -bz.y);
  return normalize(add(add(scale(bx, lx), scale(by, ly)), scale(bz, z)));
}

// pathtrace.py _offset_origin
__device__ __forceinline__ V3 offset_origin(V3 pos, V3 n, V3 dir) {
  const float side = dot(n, dir) > 0.f ? 1.f : -1.f;
  return add(pos, scale(scale(n, side), SVGF_F(1e-3)));
}

// ops/lights.py sample_lights over instance lights: the direction from
// `pos` toward a point sampled on a uniformly chosen light, 0 without lights
__device__ __forceinline__ V3 sample_lights(const Scene& s, V3 pos, float rand_l, float rand_el,
                                            float ru, float rv) {
  if (s.n_lights == 0) return zero3();
  const int l = clampi((int)(rand_l * (float)s.n_lights), 0, s.n_lights - 1);
  // sampling.py sample_discrete: a fixed-count lockstep upper_bound
  const int start = s.cdf_start[l], count = s.cdf_count[l], n = s.n_cdf;
  const float last = __ldg(s.lights_cdf + min(max(start + count - 1, 0), n - 1));
  const float x = nan_min(max_nan(rand_el * last, 0.f), last - SVGF_F(1e-5));
  int lo = start, hi = start + count;
  for (int it = 0; it < s.search_iters; ++it) {
    const bool live = lo < hi;
    const int mid = (lo + hi) >> 1;
    const bool right = live && x >= __ldg(s.lights_cdf + clampi(mid, 0, n - 1));
    const int lo2 = right ? mid + 1 : lo;
    hi = live && !right ? mid : hi;
    lo = lo2;
  }
  if (lo < start + count && __ldg(s.lights_cdf + clampi(lo, 0, n - 1)) <= x) lo += 1;
  const int elem = clampi(lo - start, 0, count - 1);
  float u = ru, v = rv;
  if (count > 0) {  // sampling.py sample_triangle_uv
    const float q = sqrtf(ru);
    u = 1.f - q;
    v = rv * q;
  }
  const V3 lp = transform_point(s.inst_transform + 16 * s.light_inst[l],
                                interp(s.tri_pos, s.tri_start[l] + elem, u, v));
  return normalize(sub(lp, pos));
}

// ops/lights.py sample_lights_pdf_from_hit: the light sampler's pdf of
// `dir` from `pos`, read off the full-scene hit `j` along that ray
__device__ __forceinline__ float lights_pdf(const Scene& s, V3 pos, V3 dir, const HitIn& h, int j) {
  if (s.n_lights == 0) return 0.f;
  const bool any = h.dist[j] < kMaxLength;
  const int hinst = h.inst[j];
  float pdf = 0.f;
  for (int l = 0; l < s.n_lights; ++l) {
    float term = 0.f;  // where(ok, d2, 0) / where(ok, denom, 1)
    if (any && hinst == s.light_inst[l]) {
      const int prim = clampi(h.prim[j], 0, s.n_tris - 1);
      const float u = h.u[j], v = h.v[j];
      const float* m = s.inst_transform + 16 * s.light_inst[l];
      const V3 lp = transform_point(m, interp(s.tri_pos, prim, u, v));
      // the light normal through Transform, as the reference (Common.cuh:675)
      const V3 ln = normalize(transform_vector(m, interp(s.tri_nrm, prim, u, v)));
      const V3 d = sub(lp, pos);
      const float d2 = dot(d, d);
      term = d2 / (fabsf(dot(ln, dir)) * __ldg(s.light_area + l) + SVGF_F(1e-18));
    }
    pdf = pdf + term;
  }
  return pdf * (1.f / (float)s.n_lights);
}

// pathtrace.py _emission_at_hit without textures, along `out` at hit `j`
__device__ __forceinline__ V3 emission_at(const Scene& s, const HitIn& h, int j, V3 out) {
  const int prim = clampi(h.prim[j], 0, s.n_tris - 1);
  const int inst = clampi(h.inst[j], 0, s.n_inst - 1);
  const int mat = clampi(h.mat[j], 0, s.n_mat - 1);
  V3 n = normalize(transform_vector(s.inst_normal_transform + 16 * inst,
                                    interp(s.tri_nrm, prim, h.u[j], h.v[j])));
  const bool flip = dot(n, out) < 0.f && __ldg(s.mat_type + mat) != kGlass;
  n = pick(flip, neg(n), n);
  return pick(dot(n, out) >= 0.f, load3(s.mat_emission, mat), zero3());
}

// sampling.py power_heuristic
__device__ __forceinline__ float power_heuristic(float p0, float p1) {
  const bool ok = p0 > 0.f;
  float r = (ok ? p1 : 0.f) / (ok ? max_nan(p0, SVGF_F(1e-18)) : 1.f);
  r = min_nan(r, SVGF_F(1e9));
  const float ph = 1.f / (1.f + r * r);
  return ok ? ph : 0.f;
}

// misw = where(safe, power_heuristic(p0, p1), 0) / where(safe, clamp_min(p0, 1e-18), 1)
__device__ __forceinline__ float mis_weight(float p0, float p1) {
  const bool safe = p0 > 0.f;
  return (safe ? power_heuristic(p0, p1) : 0.f) / (safe ? max_nan(p0, SVGF_F(1e-18)) : 1.f);
}

__global__ void __launch_bounds__(kThreads)
shade_pre_kernel(const Scene s, const HitIn hit, const bool* __restrict__ active,
                 const float* __restrict__ rd, const long long* __restrict__ lane,
                 float* __restrict__ ro2, float* __restrict__ rd2, bool* __restrict__ act2,
                 unsigned long long* __restrict__ nrays, uint32_t seed, int n) {
  __shared__ unsigned s_count[kWarps];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  unsigned count = 0;
  if (i < n) {
    // the miss: active lanes whose hit is none stop here
    const bool act = active[i] && !(hit.dist[i] >= kMaxLength);
    bool pre_l = false, trace_b = false;
    if (act) {
      const Surface sf = surface(s, hit, i, load3(rd, i));
      const V3 colour = load3(s.mat_colour, sf.mat);
      const uint32_t lh = lane_hash(lane[i]);
      // NEE direction (draws 1-4)
      const V3 dir_l = sample_lights(s, sf.pos, draw(seed, 1, lh), draw(seed, 2, lh),
                                     draw(seed, 3, lh), draw(seed, 4, lh));
      const bool l_zero = all_zero(dir_l);
      pre_l = !l_zero && any_nonzero(eval_matte(colour, sf.n, sf.out, dir_l));
      // BSDF direction (draws 6-7; 5, the lobe's, and 8, the delta's, unused)
      const V3 dir_b = sample_matte(sf.n, sf.out, draw(seed, 6, lh), draw(seed, 7, lh));
      trace_b = !l_zero && !all_zero(dir_b);
      store3(ro2, i, offset_origin(sf.pos, sf.n, dir_l));
      store3(rd2, i, dir_l);
      store3(ro2, (long)n + i, offset_origin(sf.pos, sf.n, dir_b));
      store3(rd2, (long)n + i, dir_b);
    }
    act2[i] = pre_l;
    act2[(long)n + i] = trace_b;
    count = (unsigned)pre_l + (unsigned)trace_b;
  }
  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
  if ((threadIdx.x & 31) == 0) s_count[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_count[w];
    if (total) atomicAdd(nrays, (unsigned long long)total);
  }
}

struct StateIn {
  const float *radiance, *weight, *ro, *rd;
  const bool *active, *use_mis;
};

struct StateOut {
  float *radiance, *weight, *ro, *rd;
  bool *active, *use_mis;
};

__global__ void __launch_bounds__(kThreads)
shade_post_kernel(const Scene s, const HitIn hit, const HitIn hit2, const float* __restrict__ ro2,
                  const float* __restrict__ rd2, const StateIn in,
                  const long long* __restrict__ lane, const StateOut out, uint32_t seed,
                  int roulette, int final_clamp, float clamp, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const bool act = in.active[i] && !(hit.dist[i] >= kMaxLength);
  const V3 w = load3(in.weight, i);
  V3 rad = load3(in.radiance, i);
  const bool use_mis = in.use_mis[i];
  V3 emitted = zero3(), nee = zero3(), mis = zero3();
  V3 weight = w, ro, rd;
  bool alive = false, use_mis_out = use_mis;
  if (act) {
    const Surface sf = surface(s, hit, i, load3(in.rd, i));
    const V3 colour = load3(s.mat_colour, sf.mat);
    // the surface's emission, unless the last bounce's BSDF branch counted it
    const V3 emit = pick(dot(sf.n, sf.out) >= 0.f, load3(s.mat_emission, sf.mat), zero3());
    if (!use_mis) emitted = mul(w, emit);

    // NEE branch: the shadow ray's hit gives the light pdf and the emission
    const V3 org_l = load3(ro2, i), dir_l = load3(rd2, i);
    const bool l_zero = all_zero(dir_l);
    const V3 bsdf_l = eval_matte(colour, sf.n, sf.out, dir_l);
    const bool pre_l = !l_zero && any_nonzero(bsdf_l);
    const float lpdf_l = lights_pdf(s, org_l, dir_l, hit2, i);
    const float misw_l = mis_weight(lpdf_l, matte_pdf(sf.n, sf.out, dir_l));
    if (pre_l && lpdf_l > 0.f && misw_l != 0.f) {
      const V3 emis = hit2.dist[i] >= kMaxLength ? zero3() : emission_at(s, hit2, i, neg(dir_l));
      nee = scale(mul(mul(w, bsdf_l), emis), misw_l);
    }

    // BSDF branch: the sampled ray's hit, the next bounce's, gives its light pdf
    const long j = (long)n + i;
    const V3 org_b = load3(ro2, j), dir_b = load3(rd2, j);
    const bool b_zero = all_zero(dir_b);
    const V3 bsdf_b = eval_matte(colour, sf.n, sf.out, dir_b);
    const float bpdf_b = matte_pdf(sf.n, sf.out, dir_b);
    const bool safe_b = bpdf_b > 0.f;
    const float misw_b = mis_weight(bpdf_b, lights_pdf(s, org_b, dir_b, hit2, (int)j));
    const bool pre_b = !l_zero && !b_zero && safe_b && any_nonzero(bsdf_b);
    const bool mis_cond = pre_b && misw_b != 0.f;
    if (mis_cond) {
      const V3 emis_b = hit2.dist[j] >= kMaxLength
                            ? zero3()
                            : load3(s.mat_emission, clampi(hit2.mat[j], 0, s.n_mat - 1));
      mis = scale(mul(mul(w, bsdf_b), emis_b), misw_b);
      weight = div(mul(w, bsdf_b), max_nan(bpdf_b, SVGF_F(1e-18)));
    }
    alive = !(b_zero || l_zero);
    use_mis_out = mis_cond;
    ro = org_b;
    rd = dir_b;
  } else {
    ro = load3(in.ro, i);
    rd = load3(in.rd, i);
  }
  rad = add(add(add(rad, emitted), nee), mis);

  const uint32_t lh = roulette ? lane_hash(lane[i]) : 0u;
  if (roulette && alive) {  // pathtrace.py: after bounce 3
    const float rr = min_nan(max3(weight), SVGF_F(0.99));
    alive = !(draw(seed, 9, lh) >= rr);
    if (alive) weight = div(weight, max_nan(rr, SVGF_F(1e-6)));
  }
  // dead lanes: no weight left, or not finite
  alive = alive && !(max3(weight) <= 0.f || !finite3(weight));

  if (final_clamp) {  // pathtrace.py's last step
    if (!finite3(rad)) rad = zero3();
    const float m = max3(rad);
    rad = scale(rad, m > clamp ? (1.f / max_nan(m, clamp)) * clamp : 1.f);
  }
  store3(out.radiance, i, rad);
  store3(out.weight, i, weight);
  store3(out.ro, i, ro);
  store3(out.rd, i, rd);
  out.active[i] = alive;
  out.use_mis[i] = use_mis_out;
}

inline Scene scene(const float* tri_pos, const float* tri_nrm, const float* inst_transform,
                   const float* inst_normal_transform, const float* mat_colour,
                   const float* mat_emission, const int* mat_type, const float* lights_cdf,
                   const float* light_area, const int* lights, int n_lights, int n_tris,
                   int n_inst, int n_mat, int n_cdf, int search_iters) {
  Scene s{tri_pos, tri_nrm, inst_transform, inst_normal_transform, mat_colour, mat_emission,
          mat_type, lights_cdf, light_area, n_tris, n_inst, n_mat, n_cdf, search_iters,
          n_lights};
  for (int l = 0; l < n_lights; ++l) {
    s.light_inst[l] = lights[4 * l];
    s.cdf_start[l] = lights[4 * l + 1];
    s.cdf_count[l] = lights[4 * l + 2];
    s.tri_start[l] = lights[4 * l + 3];
  }
  return s;
}

}  // namespace shade
}  // namespace svgf

#define SHADE_SCENE_PARAMS                                                                     \
  const float *tri_pos, const float *tri_nrm, const float *inst_transform,                     \
      const float *inst_normal_transform, const float *mat_colour, const float *mat_emission, \
      const int *mat_type, const float *lights_cdf, const float *light_area,                  \
      const int *lights, int n_lights, int n_tris, int n_inst, int n_mat, int n_cdf,          \
      int search_iters
#define SHADE_SCENE_ARGS                                                                      \
  tri_pos, tri_nrm, inst_transform, inst_normal_transform, mat_colour, mat_emission, mat_type, \
      lights_cdf, light_area, lights, n_lights, n_tris, n_inst, n_mat, n_cdf, search_iters

// `lights`: a host array of 4 ints a light (instance, CDF start, CDF count,
// first global triangle), at most kMaxLights lights.
extern "C" int svgf_shade_pre(SHADE_SCENE_PARAMS, const float* dist, const float* u,
                              const float* v, const int* prim, const int* inst, const int* mat,
                              const bool* active, const float* rd, const long long* lane,
                              float* ro2, float* rd2, bool* act2, unsigned long long* nrays,
                              unsigned seed, int n_rays, void* stream) {
  using namespace svgf::shade;
  if (n_lights > kMaxLights) return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  shade_pre_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      scene(SHADE_SCENE_ARGS), HitIn{dist, u, v, prim, inst, mat}, active, rd, lane, ro2, rd2,
      act2, nrays, seed, n_rays);
  return (int)cudaGetLastError();
}

// hit2: the intersect's 2R-lane Hit (shadow rays, then BSDF rays); the
// state's six fields in, then out (fresh tensors); roulette != 0 after
// bounce 3; final_clamp != 0 on the last bounce, with `clamp`.
extern "C" int svgf_shade_post(SHADE_SCENE_PARAMS, const float* dist, const float* u,
                               const float* v, const int* prim, const int* inst, const int* mat,
                               const float* dist2, const float* u2, const float* v2,
                               const int* prim2, const int* inst2, const int* mat2,
                               const float* ro2, const float* rd2, const float* radiance,
                               const float* weight, const bool* active, const bool* use_mis,
                               const float* ro, const float* rd, const long long* lane,
                               float* radiance_out, float* weight_out, bool* active_out,
                               bool* use_mis_out, float* ro_out, float* rd_out, unsigned seed,
                               int roulette, int final_clamp, float clamp, int n_rays,
                               void* stream) {
  using namespace svgf::shade;
  if (n_lights > kMaxLights) return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  shade_post_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      scene(SHADE_SCENE_ARGS), HitIn{dist, u, v, prim, inst, mat},
      HitIn{dist2, u2, v2, prim2, inst2, mat2}, ro2, rd2,
      StateIn{radiance, weight, ro, rd, active, use_mis}, lane,
      StateOut{radiance_out, weight_out, ro_out, rd_out, active_out, use_mis_out}, seed,
      roulette, final_clamp, clamp, n_rays);
  return (int)cudaGetLastError();
}
