"""Geometry primitives on batched tensors (svgf_tpu/ops/geometry.py).

Rays and vectors are (..., 3). Each function keeps the operation order of
its JAX counterpart, so the two packages round alike. On the CPU two
roundings follow XLA's CPU backend, which the tests hold the port to:
`sqrt` is correctly rounded (torch's CPU sqrt is not always), and a
vector's norm is x0*x0 followed by two fused multiply-adds, as XLA
compiles svgf_tpu's jnp.linalg.norm. Reference device library:
Moller-Trumbore Common.cuh:509-536, transforms Common.cuh:299-329.
"""

from __future__ import annotations

import torch

MAX_LENGTH = 1e30
PI = 3.14159  # the reference uses PI_F = 3.14159 (Common.cuh:22), not math.pi


def dot(a, b):
    return (a * b).sum(-1)


def sqrt(x):
    """Correctly rounded sqrt: on a card torch's own (CUDA's sqrtf is);
    for float32 on the CPU the float64 sqrt rounded to float32, which is
    the correctly rounded float32 sqrt."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _norm(v):
    """|v| over the last axis, keepdim. On the CPU in float32 the sum of
    squares is rounded as XLA's CPU backend fuses it: x0*x0, then
    fma(x1, x1, .), then fma(x2, x2, .), each step rounded once to float32
    (float64 holds each product of float32 inputs exactly)."""
    if v.device.type == "cpu" and v.dtype == torch.float32:
        d = v.double()
        s = (d[..., 0] * d[..., 0]).float()
        s = (d[..., 1] * d[..., 1] + s.double()).float()
        s = (d[..., 2] * d[..., 2] + s.double()).float()
        return sqrt(s)[..., None]
    return torch.sqrt((v * v).sum(-1, keepdim=True))


class _SafeSqrt(torch.autograd.Function):
    """sqrt(max(x, 0)) with a clamped derivative: 0.5/sqrt(max(x, 1e-12))
    for x > 0 and 0 for clamped lanes, so a downstream mask never meets
    the inf derivative of sqrt at 0 (svgf_tpu/ops/geometry.py:23-41)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return sqrt(torch.clamp_min(x, 0.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        d = torch.where(x > 0.0, 0.5 / torch.sqrt(torch.clamp_min(x, 1e-12)), 0.0)
        return g * d


class _Unit(torch.autograd.Function):
    """v/|v| whose Jacobian is zero on degenerate lanes (|v| <= 1e-9): a
    zero direction is always a masked lane, and its ~1/|v| cotangent would
    overflow upstream (svgf_tpu/ops/geometry.py:44-62)."""

    @staticmethod
    def forward(ctx, v):
        n = _norm(v)
        y = v / torch.clamp_min(n, 1e-30)
        ctx.save_for_backward(y, n)
        return y

    @staticmethod
    def backward(ctx, g):
        y, n = ctx.saved_tensors
        ok = n > 1e-9
        ns = torch.where(ok, n, 1.0)
        return torch.where(ok, (g - y * (y * g).sum(-1, keepdim=True)) / ns, 0.0)


def safe_sqrt(x):
    return _SafeSqrt.apply(x)


def _needs_grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Clip(torch.autograd.Function):
    """torch.clamp whose derivative at a bound is 1/2, as jnp.clip's,
    jnp.maximum's and jnp.minimum's are (torch.clamp gives it all to x)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = torch.ones_like(x, dtype=torch.bool)
        tie = torch.zeros_like(inside)
        for b, beyond in ((lo, x > lo if lo is not None else None),
                          (hi, x < hi if hi is not None else None)):
            if b is not None:
                inside = inside & beyond
                tie = tie | (x == b)
        # selects, not products: a NaN cotangent of a clamped lane stays out
        return torch.where(inside, g, torch.where(tie, 0.5 * g, 0.0)), None, None


def clip(x, lo=None, hi=None):
    """torch.clamp(x, lo, hi) with svgf_tpu's derivative: 1/2 at a tie
    with a bound (jnp.clip, or jnp.maximum/jnp.minimum with a constant).
    Without autograd it is torch.clamp itself."""
    if _needs_grad(x):
        return _Clip.apply(x, lo, hi)
    return torch.clamp(x, lo, hi)


class _Abs(torch.autograd.Function):
    """|x| whose derivative at 0 is 1, as jnp.abs's (torch.abs's is 0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_(x):
    """torch.abs(x) with svgf_tpu's derivative (1 at 0). Without autograd
    it is torch.abs itself."""
    return _Abs.apply(x) if _needs_grad(x) else torch.abs(x)


class _Div(torch.autograd.Function):
    """x / y with the derivative in jax.lax.div's order: -g * x * y^-2.
    torch's (-g * (x / y)) / y overflows to inf, and a zero cotangent then
    gives NaN, where x is huge (the 1e30 depth sentinel) and y tiny."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return x / y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        gx = (g / y).sum_to_size(x.shape) if ctx.needs_input_grad[0] else None
        gy = ((-g * x) * torch.reciprocal(y * y)).sum_to_size(y.shape) \
            if ctx.needs_input_grad[1] else None
        return gx, gy


def div(x, y):
    """x / y with svgf_tpu's derivative. Without autograd it is x / y."""
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        return _Div.apply(x, y)
    return x / y


def normalize(v, eps=0.0):
    if eps != 0.0:
        return v / torch.clamp_min(_norm(v), eps)
    return _Unit.apply(v)


def take_rows(table, idx):
    """table[idx]: the rows of a small table (the materials) for an integer
    index per lane. index_select's backward adds with atomics, where the
    backward of table[idx] (index_put_ with accumulate) sorts the lanes'
    indices and adds each row's serially: 124 ms a call over 1080p's lanes
    on the H100 (chip_smoke.py phase 14), the whole train step's backward."""
    return table.index_select(0, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])


def transform_point(m, p):
    """(...,4,4) @ (...,3) -> (...,3), w=1, no perspective divide (Common.cuh:299)."""
    return (m[..., :3, :3] * p[..., None, :]).sum(-1) + m[..., :3, 3]


def transform_vector(m, d):
    """w=0 transform, NO normalize (Common.cuh:627)."""
    return (m[..., :3, :3] * d[..., None, :]).sum(-1)


def transform_direction(m, d):
    """w=0 transform + normalize (Common.cuh:305-309)."""
    return normalize(transform_vector(m, d))


def basis_from_z(z):
    """Pixar orthonormal basis (Common.cuh:317-329). Returns (x, y, z) unit vecs."""
    z = normalize(z)
    sign = torch.where(z[..., 2] > 0, 1.0, -1.0)
    a = -1.0 / (sign + z[..., 2])
    b = z[..., 0] * z[..., 1] * a
    x = torch.stack(
        [1.0 + sign * z[..., 0] ** 2 * a, sign * b, -sign * z[..., 0]], dim=-1
    )
    y = torch.stack([b, sign + z[..., 1] ** 2 * a, -z[..., 1]], dim=-1)
    return x, y, z


def reflect(d, n):
    """GLSL reflect: d - 2*dot(n,d)*n."""
    return d - 2.0 * dot(n, d)[..., None] * n


def refract(d, n, eta):
    """GLSL refract(I, N, eta); 0 on total internal reflection. `eta` is a
    number or a per-lane (...,) tensor."""
    eta = torch.as_tensor(eta, dtype=d.dtype, device=d.device)
    cosi = dot(n, d)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    refr = eta[..., None] * d - (eta * cosi + safe_sqrt(k))[..., None] * n
    return torch.where((k < 0.0)[..., None], 0.0, refr)


# Componentwise variants: every operand is a tuple of three tensors.


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def ray_triangle_comp_raw(ro, rd, v0, v1, v2):
    """Moller-Trumbore on component tuples, UNMASKED: the raw (t, u, v)
    even outside the triangle or behind the origin. It re-derives
    differentiable hit parameters for a triangle a kernel already chose;
    the kernel's hit verdict stays authoritative (svgf_tpu/ops/geometry.py:185)."""
    e1 = sub3(v1, v0)
    e2 = sub3(v2, v0)
    h = cross3(rd, e2)
    a = dot3(e1, h)
    parallel = torch.abs(a) < 1e-8
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = sub3(ro, v0)
    u = f * dot3(s, h)
    q = cross3(s, e1)
    v = f * dot3(rd, q)
    t = f * dot3(e2, q)
    return t, u, v


def ray_aabb_comp(ro, inv_rd, lo, hi, tmax):
    """Slab test on component tuples (svgf_tpu/ops/geometry.py:222).
    Returns the entry t, or MAX_LENGTH on a miss. torch.maximum/minimum
    propagate NaN, as jnp's do: an axis where (lo - ro) * inv_rd is 0 * inf
    misses the box."""
    tn = torch.full_like(ro[0], -MAX_LENGTH)
    tf = torch.full_like(ro[0], MAX_LENGTH)
    for k in range(3):
        t1 = (lo[k] - ro[k]) * inv_rd[k]
        t2 = (hi[k] - ro[k]) * inv_rd[k]
        tn = torch.maximum(tn, torch.minimum(t1, t2))
        tf = torch.minimum(tf, torch.maximum(t1, t2))
    hit = (tf >= tn) & (tn < tmax) & (tf > 0)
    return torch.where(hit, tn, MAX_LENGTH)


def ray_triangle_comp(ro, rd, v0, v1, v2):
    """Moller-Trumbore on component tuples. Returns (t, u, v, hit), with
    t = MAX_LENGTH where missed."""
    e1 = sub3(v1, v0)
    e2 = sub3(v2, v0)
    h = cross3(rd, e2)
    a = dot3(e1, h)
    parallel = torch.abs(a) < 1e-8
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = sub3(ro, v0)
    u = f * dot3(s, h)
    q = cross3(s, e1)
    v = f * dot3(rd, q)
    t = f * dot3(e2, q)
    hit = (~parallel) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-8)
    return torch.where(hit, t, MAX_LENGTH), u, v, hit


def luminance(rgb):
    """Rec.709 (Filter.cuh:260-263)."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def to_srgb(c):
    """sRGB transfer (Filter.cuh:145-148); the power branch's base is
    clamped away from 0 so the untaken branch's gradient stays finite."""
    c = clip(c, 0.0)
    safe = clip(c, 0.0031308)
    return torch.where(c <= 0.0031308, 12.92 * c, 1.055 * torch.pow(safe, 1.0 / 2.4) - 0.055)


def from_srgb(c):
    """Common.cuh ToLinear (inverse sRGB)."""
    safe = clip(c, 1e-4)
    return torch.where(c <= 0.04045, c / 12.92, torch.pow((safe + 0.055) / 1.055, 2.4))


def is_finite3(v):
    return torch.isfinite(v).all(-1)
