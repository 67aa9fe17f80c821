"""Row-halo exchange for row-sharded image stencils
(svgf_tpu/parallel/halo.py).

A row band needs its neighbours' border rows before each stencil: 3 for
the moments fallback, 2*step for an a-trous step, 1 for TAA, BOUND_Y for
the motion-bounded reprojection. Rank i sends its bottom rows down to
i+1 (they become i+1's top halo) and its top rows up to i-1, all tensors
of one exchange in one `dist.batch_isend_irecv` of contiguous row slices.

Boundary policies, which make a band's stencil equal the whole frame's:
  * "zero": the image's top and bottom get zero rows. The weighted filters
    then weigh those taps 0 (a zero normal gives 0^phi_normal = 0), as the
    whole frame's inside-masks do;
  * "edge": they get the band's own edge row, repeated: the imageLoad
    coordinate clamp (Filter.cuh:73-74) that TAA reads.
With one rank nothing is sent: both halos are the boundary's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from svgf_tpu_torch.parallel.distributed import RowMesh


def _boundary(x, halo: int, boundary: str, top: bool):
    if boundary == "zero":
        return torch.zeros_like(x[:halo])
    if boundary == "edge":
        row = x[:1] if top else x[-1:]
        return row.expand((halo,) + tuple(x.shape[1:])).contiguous()
    raise ValueError(f"boundary must be 'zero' or 'edge', got {boundary!r}")


def exchange_row_halos(tensors, halo: int, mesh: RowMesh, boundary: str = "zero"):
    """[(top, bottom), ...]: `halo` rows from the bands above and below,
    for each (Hs, ...) band tensor, in one batched exchange."""
    n, i = mesh.size, mesh.rank
    for x in tensors:
        if x.shape[0] < halo:
            raise ValueError(f"a band of {x.shape[0]} rows cannot send a {halo}-row halo")
    out = [[_boundary(x, halo, boundary, True) if i == 0 else torch.empty_like(x[:halo]),
            _boundary(x, halo, boundary, False) if i == n - 1 else torch.empty_like(x[:halo])]
           for x in tensors]
    ops = []
    for x, (top, bot) in zip(tensors, out):
        if i > 0:
            ops += [dist.P2POp(dist.isend, x[:halo].contiguous(), i - 1),
                    dist.P2POp(dist.irecv, top, i - 1)]
        if i < n - 1:
            ops += [dist.P2POp(dist.isend, x[-halo:].contiguous(), i + 1),
                    dist.P2POp(dist.irecv, bot, i + 1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [tuple(pair) for pair in out]


def exchange_row_halo(x, halo: int, mesh: RowMesh, boundary: str = "zero"):
    """(top_halo, bottom_halo) of the (Hs, ...) band x."""
    return exchange_row_halos([x], halo, mesh, boundary)[0]


def with_row_halo(x, halo: int, mesh: RowMesh, boundary: str = "zero"):
    """The band extended with exchanged halos: (Hs + 2*halo, ...)."""
    top, bot = exchange_row_halo(x, halo, mesh, boundary)
    return torch.cat([top, x, bot])


def with_row_halos(tensors, halo: int, mesh: RowMesh, boundary: str = "zero"):
    """with_row_halo of several bands in one exchange."""
    return [torch.cat([top, x, bot])
            for x, (top, bot) in zip(tensors, exchange_row_halos(tensors, halo, mesh, boundary))]


def crop_halo(x, halo: int):
    return x[halo:-halo] if halo > 0 else x
