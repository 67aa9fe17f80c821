"""Halo exchange for sharded image stencils (svgf_tpu/parallel/halo.py),
on a row mesh (RowMesh) or a 2-D tile mesh (TileMesh).

A band needs its neighbours' border rows before each stencil: 3 for the
moments fallback, 2*step for an a-trous step, 1 for TAA, BOUND_Y for the
motion-bounded reprojection; a tile needs their columns too. Rank i sends
its last rows to the neighbour below (they become that rank's top halo)
and its first rows to the one above; columns likewise to the right and
left. All tensors of one exchange go in one `dist.batch_isend_irecv` of
contiguous slices. The tile halo exchanges rows first and then columns of
the row-extended tile, so the corners travel with the second exchange.

Boundary policies, which make a band's stencil equal the whole frame's:
  * "zero": the image's border gets zero rows (columns). The weighted
    filters then weigh those taps 0 (a zero normal gives 0^phi_normal =
    0), as the whole frame's inside-masks do;
  * "edge": it gets the band's own edge row (column), repeated: the
    imageLoad coordinate clamp (Filter.cuh:73-74) that TAA reads.
With one rank along an axis nothing is sent: both halos are the boundary's.

Every exchange carries gradients (the transpose of svgf_tpu's ppermute):
its backward sends the gradient of each received halo back to the rank
that owns those rows or columns, which adds it into its edge rows or
columns, in one batched exchange; at an "edge" border the repeated rows'
gradient folds into the border row. Integer tensors carry none.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from svgf_tpu_torch.parallel.collectives import as_tiles


def _axis(mesh, dim: int):
    """(position along the axis of image dim `dim`, ranks on it, rank
    stride between neighbours) of this rank."""
    m = as_tiles(mesh)
    return (m.iy, m.rows, m.cols) if dim == 0 else (m.ix, m.cols, 1)


def _boundary(x, halo: int, boundary: str, dim: int, first: bool):
    if boundary == "zero":
        return torch.zeros_like(x.narrow(dim, 0, halo))
    if boundary == "edge":
        edge = x.narrow(dim, 0 if first else x.shape[dim] - 1, 1)
        shape = list(x.shape)
        shape[dim] = halo
        return edge.expand(shape).contiguous()
    raise ValueError(f"boundary must be 'zero' or 'edge', got {boundary!r}")


def _buffer(like):
    """A contiguous receive buffer (empty_like would keep a view's strides)."""
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def _swap(sends, recvs) -> None:
    """One batched exchange: sends [(tensor, peer)], recvs [(buffer, peer)]."""
    ops = [dist.P2POp(dist.isend, t, p) for t, p in sends]
    ops += [dist.P2POp(dist.irecv, b, p) for b, p in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _HaloExchange(torch.autograd.Function):
    """The tensors extended by `halo` rows (dim 0) or columns (dim 1) of
    the neighbours on each side."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        rank, pos, n, stride, halo, boundary, dim = spec
        ctx.spec = spec
        sends, recvs, out = [], [], []
        for x in tensors:
            if x.shape[dim] < halo:
                raise ValueError(f"a tile of {x.shape[dim]} along dim {dim} "
                                 f"cannot send a {halo}-wide halo")
            lo = (_boundary(x, halo, boundary, dim, True) if pos == 0
                  else _buffer(x.narrow(dim, 0, halo)))
            hi = (_boundary(x, halo, boundary, dim, False) if pos == n - 1
                  else _buffer(x.narrow(dim, 0, halo)))
            if pos > 0:
                sends.append((x.narrow(dim, 0, halo).contiguous(), rank - stride))
                recvs.append((lo, rank - stride))
            if pos < n - 1:
                sends.append((x.narrow(dim, x.shape[dim] - halo, halo).contiguous(), rank + stride))
                recvs.append((hi, rank + stride))
            out.append((lo, x, hi))
        _swap(sends, recvs)
        out = [torch.cat(parts, dim=dim) for parts in out]
        ctx.mark_non_differentiable(*[o for o in out if not o.is_floating_point()])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        rank, pos, n, stride, halo, boundary, dim = ctx.spec
        sends, recvs, mids, out = [], [], [], []
        for g, need in zip(grads, ctx.needs_input_grad[1:]):
            if not need:
                out.append(None)
                continue
            length = g.shape[dim] - 2 * halo
            g_lo = g.narrow(dim, 0, halo)
            g_hi = g.narrow(dim, halo + length, halo)
            mid = g.narrow(dim, halo, length).contiguous().clone()
            # the halo rows came from the neighbours: their gradient goes back
            if pos > 0:
                sends.append((g_lo.contiguous(), rank - stride))
                recvs.append((_buffer(g_lo), rank - stride))
            elif boundary == "edge":
                mid.narrow(dim, 0, 1).add_(g_lo.sum(dim, keepdim=True))
            if pos < n - 1:
                sends.append((g_hi.contiguous(), rank + stride))
                recvs.append((_buffer(g_hi), rank + stride))
            elif boundary == "edge":
                mid.narrow(dim, length - 1, 1).add_(g_hi.sum(dim, keepdim=True))
            mids.append((mid, pos > 0, pos < n - 1, len(recvs)))
            out.append(mid)
        _swap(sends, recvs)
        for mid, has_lo, has_hi, end in mids:
            length = mid.shape[dim]
            if has_hi:
                mid.narrow(dim, length - halo, halo).add_(recvs[end - 1][0])
            if has_lo:
                mid.narrow(dim, 0, halo).add_(recvs[end - 1 - has_hi][0])
        return (None, *out)


def _with_halos(tensors, halo: int, mesh, boundary: str, dim: int):
    if halo == 0:
        return list(tensors)
    pos, n, stride = _axis(mesh, dim)
    spec = (as_tiles(mesh).rank, pos, n, stride, halo, boundary, dim)
    return list(_HaloExchange.apply(spec, *tensors))


def with_row_halos(tensors, halo: int, mesh, boundary: str = "zero"):
    """Each (Hs, ...) band extended by `halo` rows from the bands above and
    below, (Hs + 2*halo, ...), in one batched exchange."""
    return _with_halos(tensors, halo, mesh, boundary, 0)


def with_row_halo(x, halo: int, mesh, boundary: str = "zero"):
    """The band extended with exchanged halos: (Hs + 2*halo, ...)."""
    return with_row_halos([x], halo, mesh, boundary)[0]


def exchange_row_halo(x, halo: int, mesh, boundary: str = "zero"):
    """(top_halo, bottom_halo) of the (Hs, ...) band x."""
    e = with_row_halo(x, halo, mesh, boundary)
    return e[:halo], e[e.shape[0] - halo:]


def with_col_halos(tensors, halo: int, mesh, boundary: str = "zero"):
    """Column twin of with_row_halos: (Hs, Ws + 2*halo, ...) tiles."""
    return _with_halos(tensors, halo, mesh, boundary, 1)


def with_col_halo(x, halo: int, mesh, boundary: str = "zero"):
    """The tile extended with exchanged column halos: (Hs, Ws + 2*halo, ...)."""
    return with_col_halos([x], halo, mesh, boundary)[0]


def exchange_col_halo(x, halo: int, mesh, boundary: str = "zero"):
    """(left_halo, right_halo) of the (Hs, Ws, ...) tile x, each `halo`
    columns wide."""
    e = with_col_halo(x, halo, mesh, boundary)
    return e[:, :halo], e[:, e.shape[1] - halo:]


def with_tile_halos(tensors, halo: int, mesh, boundary: str = "zero"):
    """2-D halos: rows first, then columns of the row-extended tiles, so the
    corner blocks arrive with the second exchange."""
    return with_col_halos(with_row_halos(tensors, halo, mesh, boundary), halo, mesh, boundary)


def with_tile_halo(x, halo: int, mesh, boundary: str = "zero"):
    """The tile extended by `halo` on all four sides: (Hs + 2h, Ws + 2h, ...)."""
    return with_tile_halos([x], halo, mesh, boundary)[0]


def crop_halo(x, halo: int):
    return x[halo:-halo] if halo > 0 else x


def crop_tile_halo(x, halo: int):
    return x[halo:-halo, halo:-halo] if halo > 0 else x
