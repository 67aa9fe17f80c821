"""The renderer's random numbers: host threefry2x32 keys bit-equal to
jax.random.key / fold_in, and counter-based lowbias32 uniforms hashed per
global lane id, one field per call site in the tracer's call order."""

from __future__ import annotations

import math

import torch

from portbench.reference.geometry import PI, basis_from_z, dot, normalize

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry(key, x0: int, x1: int):
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int):
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is outside int32")
    return 0, seed & _M32


def fold_in(k, data: int):
    return _threefry(k, 0, data & _M32)


def _mul32(x, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _lowbias32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


class Stream:
    """One uniform field a call, hashed per lane id (int64 lanes)."""

    def __init__(self, k, lane_ids):
        self.seed = _lowbias32(k[0] ^ _lowbias32(k[1]))
        self.lane = lane_ids.to(torch.int64)
        self.n = 0

    def uniform(self):
        self.n += 1
        site = _lowbias32(_mul32(self.n, _GOLDEN) ^ self.seed)
        h = _lowbias32(((_mul32(self.lane, _GOLDEN) + 1) & _M32) ^ site)
        return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))

    def uniform2(self):
        return torch.stack([self.uniform(), self.uniform()], dim=-1)


def power_heuristic(pdf0, pdf1):
    ok = pdf0 > 0.0
    r = torch.where(ok, pdf1, 0.0) / torch.where(ok, torch.clamp_min(pdf0, 1e-18), 1.0)
    r = torch.clamp_max(r, 1e9)
    return torch.where(ok, 1.0 / (1.0 + r * r), 0.0)


def triangle_uv(ruv):
    s = torch.sqrt(ruv[..., 0])
    return torch.stack([1.0 - s, ruv[..., 1] * s], dim=-1)


def hemisphere_cosine(normal, ruv):
    z = torch.sqrt(ruv[..., 1])
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * ruv[..., 0]
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    bx, by, bz = basis_from_z(normal)
    return normalize(local[..., 0:1] * bx + local[..., 1:2] * by + local[..., 2:3] * bz)


def hemisphere_cosine_pdf(normal, direction):
    cosw = dot(normal, direction)
    return torch.where(cosw <= 0, 0.0, cosw / PI)


def sample_discrete(cdf, count: int, rand):
    """An index in [0, count) of the cumulative table `cdf` (count entries):
    a lockstep upper_bound with the renderer's post-adjust."""
    n = cdf.shape[0]
    last = cdf[count - 1]
    x = torch.minimum(torch.clamp_min(rand * last, 0.0), last - 1e-5)
    lo = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    hi = lo + count
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))) + 1)):
        live = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        right = live & (x >= cdf[torch.clamp(mid, 0, n - 1)])
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(live & ~right, mid, hi)
    lo = torch.where((lo < count) & (cdf[torch.clamp(lo, 0, n - 1)] <= x), lo + 1, lo)
    return torch.clamp(lo, 0, count - 1)
