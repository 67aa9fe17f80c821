"""Vector and ray primitives on batched (..., 3) tensors, in the operation
order of svgf_tpu_torch/ops/geometry.py on a card, so that equal inputs
round alike."""

from __future__ import annotations

import torch

MAX_LENGTH = 1e30
PI = 3.14159  # the renderer's PI_F, not math.pi


def dot(a, b):
    return (a * b).sum(-1)


def normalize(v):
    n = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / torch.clamp_min(n, 1e-30)


def transform_point(m, p):
    return (m[..., :3, :3] * p[..., None, :]).sum(-1) + m[..., :3, 3]


def transform_vector(m, d):
    return (m[..., :3, :3] * d[..., None, :]).sum(-1)


def transform_direction(m, d):
    return normalize(transform_vector(m, d))


def basis_from_z(z):
    """Pixar orthonormal basis; returns (x, y, z) unit vectors."""
    z = normalize(z)
    sign = torch.where(z[..., 2] > 0, 1.0, -1.0)
    a = -1.0 / (sign + z[..., 2])
    b = z[..., 0] * z[..., 1] * a
    x = torch.stack([1.0 + sign * z[..., 0] ** 2 * a, sign * b, -sign * z[..., 0]], dim=-1)
    y = torch.stack([b, sign + z[..., 1] ** 2 * a, -z[..., 1]], dim=-1)
    return x, y, z


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def ray_triangle(ro, rd, v0, v1, v2):
    """Moller-Trumbore on component tuples: (t, u, v, hit), t = MAX_LENGTH
    where the ray misses."""
    e1 = _sub3(v1, v0)
    e2 = _sub3(v2, v0)
    h = _cross3(rd, e2)
    a = _dot3(e1, h)
    parallel = torch.abs(a) < 1e-8
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = _sub3(ro, v0)
    u = f * _dot3(s, h)
    q = _cross3(s, e1)
    v = f * _dot3(rd, q)
    t = f * _dot3(e2, q)
    hit = (~parallel) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-8)
    return torch.where(hit, t, MAX_LENGTH), u, v, hit


def ray_box(ro, inv_rd, lo, hi, tmax):
    """Slab test on component tuples: the entry t, or MAX_LENGTH."""
    tn = torch.full_like(ro[0], -MAX_LENGTH)
    tf = torch.full_like(ro[0], MAX_LENGTH)
    for k in range(3):
        t1 = (lo[k] - ro[k]) * inv_rd[k]
        t2 = (hi[k] - ro[k]) * inv_rd[k]
        tn = torch.maximum(tn, torch.minimum(t1, t2))
        tf = torch.minimum(tf, torch.maximum(t1, t2))
    hit = (tf >= tn) & (tn < tmax) & (tf > 0)
    return torch.where(hit, tn, MAX_LENGTH)


def luminance(rgb):
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def to_srgb(c):
    c = torch.clamp(c, 0.0)
    safe = torch.clamp(c, 0.0031308)
    return torch.where(c <= 0.0031308, 12.92 * c, 1.055 * torch.pow(safe, 1.0 / 2.4) - 0.055)
