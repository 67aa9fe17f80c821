"""The collectives of the sharded routes, each with its transpose as its
backward, so a gradient that crosses a band or tile edge reaches the rank
that owns the pixel, as shard_map's transpose of all_gather and
all_to_all carries it in svgf_tpu.

  * `gather_tiles`: every rank's tile of a mesh into the whole image; its
    backward sums the image's gradient over the ranks (an all-reduce,
    which gloo and NCCL both have, unlike a reduce-scatter) and keeps this
    rank's tile.
  * `all_to_all`: one equal-split all_to_all_single; with equal splits it
    is its own transpose.

Integer tensors pass through without a gradient. With one rank nothing
is sent.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from svgf_tpu_torch.parallel.distributed import RowMesh, TileMesh


def as_tiles(mesh) -> TileMesh:
    """A RowMesh is a TileMesh of one column."""
    if isinstance(mesh, RowMesh):
        return TileMesh(rank=mesh.rank, rows=mesh.size, cols=1)
    return mesh


def _assemble(parts, mesh: TileMesh):
    rows = [torch.cat(parts[r * mesh.cols:(r + 1) * mesh.cols], dim=1) for r in range(mesh.rows)]
    return torch.cat(rows, dim=0)


def _own_tile(full, shape, mesh: TileMesh):
    hs, ws = shape[:2]
    return full[mesh.iy * hs:(mesh.iy + 1) * hs, mesh.ix * ws:(mesh.ix + 1) * ws]


class _GatherTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *tiles):
        ctx.mesh = mesh
        ctx.shapes = [t.shape for t in tiles]
        out = []
        for t in tiles:
            t = t.contiguous()   # empty_like keeps a view's strides; the collective does not
            parts = [torch.empty_like(t) for _ in range(mesh.size)]
            dist.all_gather(parts, t)
            out.append(_assemble(parts, mesh))
        ctx.mark_non_differentiable(*[o for o in out if not o.is_floating_point()])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g, shape, need in zip(grads, ctx.shapes, ctx.needs_input_grad[1:]):
            if not need:
                out.append(None)
                continue
            g = g.contiguous().clone()
            dist.all_reduce(g)
            out.append(_own_tile(g, shape, ctx.mesh).contiguous())
        return (None, *out)


def gather_tiles(tiles, mesh):
    """Each (Hs, Ws, ...) tile of `tiles`, gathered from every rank of
    `mesh` (a RowMesh or a TileMesh) into the (H, W, ...) image."""
    mesh = as_tiles(mesh)
    if mesh.size == 1:
        return list(tiles)
    return list(_GatherTiles.apply(mesh, *tiles))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        v = v.contiguous()   # empty_like keeps a view's strides; the collective does not
        out = torch.empty_like(v)
        dist.all_to_all_single(out, v)
        if not v.is_floating_point():
            ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g)
        return out


def all_to_all(v):
    """all_to_all_single of `v` in equal splits over the default group."""
    return _AllToAll.apply(v)
