"""Closest-hit intersection of world-space rays with the world soup.

Up to DENSE_MAX triangles every ray tests every triangle, a later column
winning only when strictly nearer. Larger soups take a linear BVH: the
triangles sorted by the Morton code of their centroids, four a leaf, a
complete binary tree over the leaves in heap order, walked nearest
child first with a per-lane stack, lanes compacted as they finish. Either way the Hit is the nearest triangle's, with t, u, v
from one Moller-Trumbore formula."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.geometry import MAX_LENGTH, ray_box, ray_triangle

DENSE_MAX = 16384
_RAY_BLOCK = 1 << 19     # rays a step of the dense sweep
_COMPACT_EVERY = 8       # walk steps between two compactions of the live lanes


class Hit(NamedTuple):
    dist: torch.Tensor      # (R,) MAX_LENGTH = miss
    u: torch.Tensor
    v: torch.Tensor
    prim: torch.Tensor      # (R,) i32 global triangle id
    instance: torch.Tensor  # (R,) i32
    material: torch.Tensor  # (R,) i32


def _comp(x):
    return x[..., 0], x[..., 1], x[..., 2]


def _hit_of(world9, inst, prim, mat, ro, rd, col, active):
    """The Hit of the winning soup column per ray (-1: none)."""
    ok = col >= 0
    c = torch.clamp_min(col, 0).long()
    w = world9[:, c]
    t, u, v, _ = ray_triangle(_comp(ro), _comp(rd), (w[0], w[1], w[2]), (w[3], w[4], w[5]),
                              (w[6], w[7], w[8]))
    zero = torch.zeros_like(col, dtype=torch.int32)
    dist = torch.where(ok, t, MAX_LENGTH)
    if active is not None:
        dist = torch.where(active, dist, MAX_LENGTH)
    return Hit(dist=dist, u=torch.where(ok, u, 0.0), v=torch.where(ok, v, 0.0),
               prim=torch.where(ok, prim[c], zero), instance=torch.where(ok, inst[c], zero),
               material=torch.where(ok, mat[c], zero))


def _dense_cols(world9, ro, rd, active):
    cols = torch.full((ro.shape[0],), -1, dtype=torch.int64, device=ro.device)
    for r0 in range(0, ro.shape[0], _RAY_BLOCK):
        sl = slice(r0, r0 + _RAY_BLOCK)
        roc = tuple(x[:, None] for x in _comp(ro[sl]))
        rdc = tuple(x[:, None] for x in _comp(rd[sl]))
        row = lambda k: world9[k][None, :]
        t, _, _, m = ray_triangle(roc, rdc, (row(0), row(1), row(2)), (row(3), row(4), row(5)),
                                  (row(6), row(7), row(8)))
        t = torch.where(m, t, MAX_LENGTH)
        j = torch.argmin(t, dim=-1)                      # the first minimum
        tb = torch.gather(t, 1, j[:, None])[:, 0]
        c = torch.where(tb < MAX_LENGTH, j, -1)
        if active is not None:
            c = torch.where(active[sl], c, -1)
        cols[sl] = c
    return cols


def _morton3(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of (n, 3) points in [0, 1]."""
    q = np.clip((c * 1023.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


LEAF = 4  # triangles a leaf


class LBVH(NamedTuple):
    lo: torch.Tensor     # (3, 2L-1) node boxes
    hi: torch.Tensor
    leaf_cols: torch.Tensor  # (L, LEAF) soup columns of each leaf, -1 for padding
    n_leaves: int


def build_lbvh(world9: torch.Tensor) -> LBVH:
    w = world9.detach().cpu().numpy().astype(np.float64)
    tris = w.T.reshape(-1, 3, 3)
    t_lo, t_hi = tris.min(1), tris.max(1)
    cen = 0.5 * (t_lo + t_hi)
    span = np.maximum(cen.max(0) - cen.min(0), 1e-12)
    order = np.argsort(_morton3((cen - cen.min(0)) / span), kind="stable")
    n = tris.shape[0]
    L = 1 << max(int(np.ceil(np.log2(max(-(-n // LEAF), 2)))), 1)
    cols = np.full(L * LEAF, -1, np.int64)
    cols[:n] = order
    cols = cols.reshape(L, LEAF)
    # padding leaves, and subtrees of nothing but padding, get NaN boxes,
    # which no slab test hits
    lo = np.full((2 * L - 1, 3), np.nan)
    hi = np.full((2 * L - 1, 3), np.nan)
    real = cols >= 0
    big = np.where(real[..., None], t_lo[np.clip(cols, 0, None)], np.nan)
    small = np.where(real[..., None], t_hi[np.clip(cols, 0, None)], np.nan)
    with np.errstate(all="ignore"):
        lo[L - 1:] = np.fmin.reduce(big, axis=1)
        hi[L - 1:] = np.fmax.reduce(small, axis=1)
    first = L - 1
    while first > 0:                       # parents of one level from their children
        parents = np.arange((first - 1) // 2, first)
        lo[parents] = np.fmin(lo[2 * parents + 1], lo[2 * parents + 2])
        hi[parents] = np.fmax(hi[2 * parents + 1], hi[2 * parents + 2])
        first = (first - 1) // 2
    # boxes in float32, widened outward by two ulps so rounding never culls a hit
    lo32 = np.nextafter(np.nextafter(lo.astype(np.float32), np.float32(-np.inf)),
                        np.float32(-np.inf))
    hi32 = np.nextafter(np.nextafter(hi.astype(np.float32), np.float32(np.inf)),
                        np.float32(np.inf))
    dev = world9.device
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x.T), dtype=torch.float32, device=dev)
    return LBVH(lo=f(lo32), hi=f(hi32), leaf_cols=torch.as_tensor(cols, device=dev), n_leaves=L)


@torch.no_grad()
def _walk_cols(bvh: LBVH, world9, ro, rd, active):
    """Each lane walks nearest child first with a stack of the farther
    children: at a node whose box the ray enters before its nearest hit so
    far, an internal node descends to the child box it enters first
    (pushing the other if it enters both), a leaf tests its triangles (those
    lanes only); otherwise, and after a leaf, the lane pops its stack."""
    L = bvh.n_leaves
    end = 2 * L - 1
    depth = L.bit_length() + 1
    R, dev = ro.shape[0], ro.device
    cols = torch.full((R,), -1, dtype=torch.int64, device=dev)
    lanes = torch.arange(R, device=dev)
    if active is not None:
        lanes = lanes[active]
    n = lanes.shape[0]
    roc, rdc = _comp(ro[lanes]), _comp(rd[lanes])
    inv = tuple(1.0 / d for d in rdc)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, depth), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    tb = torch.full((n,), MAX_LENGTH, device=dev)
    col = torch.full_like(node, -1)
    box = lambda i: ray_box(roc, inv, _comp(bvh.lo[:, i].T), _comp(bvh.hi[:, i].T), tb)
    step = 0
    while lanes.numel():
        step += 1
        live = node < end
        g = torch.clamp_max(node, end - 1)
        hit = live & (box(g) < MAX_LENGTH)
        is_leaf = g >= L - 1
        at = torch.nonzero(hit & is_leaf).flatten()
        if at.numel():
            lc = bvh.leaf_cols[g[at] - (L - 1)]                    # (m, LEAF)
            v = world9[:, torch.clamp_min(lc, 0)]                  # (9, m, LEAF)
            o = tuple(x[at][:, None] for x in roc)
            d = tuple(x[at][:, None] for x in rdc)
            t, _, _, m = ray_triangle(o, d, (v[0], v[1], v[2]), (v[3], v[4], v[5]),
                                      (v[6], v[7], v[8]))
            t = torch.where(m & (lc >= 0), t, MAX_LENGTH)
            tba, cola = tb[at], col[at]
            for j in range(LEAF):                                  # strictly nearer wins
                closer = t[:, j] < tba
                tba = torch.where(closer, t[:, j], tba)
                cola = torch.where(closer, lc[:, j], cola)
            tb[at], col[at] = tba, cola
        inner = hit & ~is_leaf
        c0 = torch.clamp_max(2 * g + 1, end - 1)
        c1 = torch.clamp_max(2 * g + 2, end - 1)
        t0, t1 = box(c0), box(c1)
        h0, h1 = inner & (t0 < MAX_LENGTH), inner & (t1 < MAX_LENGTH)
        swap = t1 < t0
        both = h0 & h1
        descend = h0 | h1
        to = torch.where(both, torch.where(swap, c1, c0), torch.where(h0, c0, c1))
        far = torch.where(swap, c0, c1)
        slot = torch.clamp_max(sp, depth - 1)[:, None]
        stack.scatter_(1, slot, torch.where(both[:, None], far[:, None], stack.gather(1, slot)))
        sp = sp + both
        pop = live & ~descend
        top = stack.gather(1, torch.clamp_min(sp - 1, 0)[:, None])[:, 0]
        node = torch.where(descend, to, torch.where(pop, torch.where(sp > 0, top, end), node))
        sp = torch.where(pop & (sp > 0), sp - 1, sp)
        if step % _COMPACT_EVERY == 0:
            done = node >= end
            if bool(done.any()):
                cols[lanes[done]] = col[done]
                keep = ~done
                lanes, node, tb, col, sp = lanes[keep], node[keep], tb[keep], col[keep], sp[keep]
                stack = stack[keep]
                roc = tuple(x[keep] for x in roc)
                rdc = tuple(x[keep] for x in rdc)
                inv = tuple(x[keep] for x in inv)
    return cols


def make_intersector(world9, inst, prim, mat):
    """(ro, rd, active=None) -> Hit over the soup `world9` (9, T) with each
    column's instance, global triangle and material."""
    if world9.shape[1] <= DENSE_MAX:
        pick = lambda ro, rd, active: _dense_cols(world9, ro, rd, active)
    else:
        bvh = build_lbvh(world9)
        pick = lambda ro, rd, active: _walk_cols(bvh, world9, ro, rd, active)

    def intersect(ro, rd, active=None):
        col = pick(ro, rd, active)
        return _hit_of(world9, inst, prim, mat, ro, rd, col, active)

    return intersect
