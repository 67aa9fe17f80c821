"""Sampling utilities: counter-based RNG fields, discrete CDF sampling and
the MIS heuristic (svgf_tpu/ops/sampling.py; reference Common.cuh:256-295,
348-459, 1571-1574).

Every random draw is lowbias32(hash of lane id ^ hash of (site, seed)) on
uint32 that wraps modulo 2^32, bit-identical to svgf_tpu. Torch has no
wrapping uint32 arithmetic on every device, so the hash runs on int64
tensors holding values in [0, 2^32) and masks after each step.
"""

from __future__ import annotations

import math

import torch

from svgf_tpu_torch.ops.geometry import PI, basis_from_z, dot, normalize, sqrt

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x, c: int):
    """x * c mod 2^32 for x in [0, 2^32) (int64 tensor or int), without
    overflowing int64: the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _lowbias32(x):
    """Wellons' lowbias32 integer hash (public domain), on int64 tensors or
    Python ints holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def key_to_seed32(key: tuple[int, int]) -> int:
    """Collapse a key's two uint32 words to a stream seed (svgf_tpu
    key_to_seed32: lowbias32(data[0] ^ lowbias32(data[-1])))."""
    return _lowbias32(key[0] ^ _lowbias32(key[1]))


class RngStream:
    """Hands out one uniform field per call site, hashed per global lane id.
    The call counter is the site, so the order of `uniform` calls must be
    the JAX tracer's order, draws that a scene's lobes leave unused
    included."""

    def __init__(self, key: tuple[int, int], lane_ids: torch.Tensor):
        self.seed = key_to_seed32(key)
        self.lane = lane_ids.to(torch.int64)
        self._n = 0

    def uniform(self) -> torch.Tensor:
        self._n += 1
        site = _lowbias32(_mul32(self._n, _GOLDEN) ^ self.seed)
        h = _lowbias32(((_mul32(self.lane, _GOLDEN) + 1) & _M32) ^ site)
        # top 24 bits -> mantissa-exact [0, 1)
        return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))

    def uniform2(self) -> torch.Tensor:
        return torch.stack([self.uniform(), self.uniform()], dim=-1)


def power_heuristic(pdf0, pdf1):
    """(Common.cuh:1571-1574) in the overflow-stable ratio form
    1/(1+(pdf1/pdf0)^2), with pdf0 <= 0 lanes giving 0."""
    ok = pdf0 > 0.0
    r = torch.where(ok, pdf1, 0.0) / torch.where(ok, torch.clamp_min(pdf0, 1e-18), 1.0)
    r = torch.clamp_max(r, 1e9)
    ph = 1.0 / (1.0 + r * r)
    return torch.where(ok, ph, 0.0)


def sample_uniform_index(size: int, rand):
    """clamp(int(rand*size), 0, size-1) (Common.cuh:235-239)."""
    return torch.clamp((rand * size).to(torch.int32), 0, size - 1)


def sample_triangle_uv(ruv):
    """Uniform triangle barycentrics (Common.cuh:229-234)."""
    s = sqrt(ruv[..., 0])
    return torch.stack([1.0 - s, ruv[..., 1] * s], dim=-1)


def sample_sphere(ruv):
    """(Common.cuh:399-405)."""
    z = 2.0 * ruv[..., 1] - 1.0
    r = sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    phi = 2.0 * PI * ruv[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def sample_hemisphere_cosine(normal, ruv):
    """(Common.cuh:721-729)."""
    z = sqrt(ruv[..., 1])
    r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * ruv[..., 0]
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    bx, by, bz = basis_from_z(normal)
    return normalize(
        local[..., 0:1] * bx + local[..., 1:2] * by + local[..., 2:3] * bz
    )


def sample_hemisphere_cosine_pdf(normal, direction):
    """(Common.cuh:731-738)."""
    cosw = dot(normal, direction)
    return torch.where(cosw <= 0, 0.0, cosw / PI)


def upper_bound_segment(cdf, start: int, count: int, x):
    """Vectorized std::upper_bound over cdf[start:start+count]
    (Common.cuh:348-371): a fixed-iteration lockstep binary search. Returns
    indices into the whole `cdf`."""
    n = cdf.shape[0]
    lo = torch.full(x.shape, start, dtype=torch.int32, device=x.device)
    hi = lo + count
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))) + 1)):
        live = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = cdf[torch.clamp(mid, 0, n - 1)]
        right = live & (x >= v)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(live & ~right, mid, hi)
    # reference post-adjust (:365-367)
    v_lo = cdf[torch.clamp(lo, 0, n - 1)]
    return torch.where((lo < start + count) & (v_lo <= x), lo + 1, lo)


def sample_discrete(cdf, start: int, count: int, rand):
    """SampleDiscrete (Common.cuh:374-387): an index in [0, count)."""
    n = cdf.shape[0]
    last = cdf[min(max(start + count - 1, 0), n - 1)]
    r = torch.minimum(torch.clamp_min(rand * last, 0.0), last - 1e-5)
    idx = upper_bound_segment(cdf, start, count, r) - start
    return torch.clamp(idx, 0, count - 1)


def sample_discrete_pdf(cdf, start: int, count: int, idx):
    """(Common.cuh:407-411): the probability mass of element `idx`."""
    n = cdf.shape[0]
    hi = cdf[torch.clamp(start + idx, 0, n - 1)]
    lo = torch.where(idx == 0, 0.0, cdf[torch.clamp(start + idx - 1, 0, n - 1)])
    last = cdf[min(max(start + count - 1, 0), n - 1)]
    return (hi - lo) / last
