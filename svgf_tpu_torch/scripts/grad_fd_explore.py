"""Finite differences against autograd for the camera, away from edges:
the port's copy of svgf_tpu's scripts/grad_fd_explore.py.

On the Cornell box at 40x32 (1 bounce, 1 a-trous step, float32 state),
the interior mask keeps the pixels at least 2 px from an instance or depth
edge at the base camera (`interior_mask`). Two masked losses of cam_frame:
the G-buffer depth's squared distance from 2 and the final image's
squared magnitude (`losses`). For each, the x and z translation of the
camera (cam_frame[0, comp, 3], comp 0 and 2) at steps 3e-3 and 1e-3: the
central difference `fd`, autograd's `an` and rel = |fd - an| /
max(|fd|, |an|, 1e-9) (`explore`). The mask and the depth loss intersect
with `timing.kernel_mode(device)`, K5 on the card, as svgf_tpu's script
runs its Pallas kernel there; the final loss renders on the configuration's
use_pallas="off" (svgf_tpu's trace order: its first render_frame sets
the intersector policy to the configuration's before the depth loss is
traced).

Usage: python -m svgf_tpu_torch.scripts.grad_fd_explore [height width]
(on the card; main(device="cpu") runs the plain versions on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from svgf_tpu_torch.scripts.grad_bisect import cornell_arrays, grad_config, parse_size

H, W = 32, 40
COMPS = (0, 2)
EPS = (3e-3, 1e-3)
# the intersects through `mode` of one evaluation of each loss (K5 launches
# on the card); `explore` evaluates a loss once under autograd and twice a
# comp and step, and the mask takes one more
K5_CALLS = {"depth": 1, "final": 0}
EVALUATIONS = 1 + 2 * len(COMPS) * len(EPS)


class FDRow(NamedTuple):
    name: str
    comp: int
    eps: float
    fd: float
    an: float
    rel: float

    def line(self) -> str:
        """svgf_tpu's printed line of the row."""
        return (f"{self.name} comp={self.comp} eps={self.eps:g}: fd={self.fd:+.5g} "
                f"an={self.an:+.5g} rel={self.rel:.3f}")


def interior_mask(arrays, h: int, w: int, mode: str):
    """Pixels at least 2 px from an instance or depth edge (a depth step
    over 0.1) at the base camera, as (h, w, 1) float32 on the arrays'
    device: 1 inside, 0 on and near an edge."""
    from svgf_tpu_torch.render.gbuffer import raster_gbuffer

    with torch.no_grad():
        g0 = raster_gbuffer(arrays, 0, h, w, mode=mode)
    inst, depth = g0.instance.cpu().numpy(), g0.depth.cpu().numpy()
    edge = np.zeros((h, w), bool)
    edge[:, 1:] |= inst[:, 1:] != inst[:, :-1]
    edge[:, :-1] |= inst[:, 1:] != inst[:, :-1]
    edge[1:, :] |= inst[1:, :] != inst[:-1, :]
    edge[:-1, :] |= inst[1:, :] != inst[:-1, :]
    edge[:, 1:] |= np.abs(depth[:, 1:] - depth[:, :-1]) > 0.1
    edge[1:, :] |= np.abs(depth[1:, :] - depth[:-1, :]) > 0.1
    for _ in range(2):   # dilate
        e2 = edge.copy()
        e2[1:, :] |= edge[:-1, :]
        e2[:-1, :] |= edge[1:, :]
        e2[:, 1:] |= edge[:, :-1]
        e2[:, :-1] |= edge[:, 1:]
        edge = e2
    return torch.as_tensor(~edge, dtype=torch.float32, device=arrays.cam_frame.device)[..., None]


def losses(arrays, config, mask, mode: str) -> dict:
    """svgf_tpu's two masked losses of cam_frame: "depth" (the G-buffer
    through `mode`) and "final" (render_frame on `config`)."""
    from svgf_tpu_torch.render.gbuffer import raster_gbuffer
    from svgf_tpu_torch.render.pipeline import render_frame
    from svgf_tpu_torch.render.types import TemporalState

    h, w = config.height, config.width
    target = torch.zeros((h, w, 3), device=mask.device)

    def loss_depth(cf):
        g = raster_gbuffer(dataclasses.replace(arrays, cam_frame=cf), 0, h, w, mode=mode)
        return (mask[..., 0] * (g.depth - 2.0) ** 2).sum() / mask.sum()

    def loss_final(cf):
        out, _ = render_frame(dataclasses.replace(arrays, cam_frame=cf),
                              TemporalState.initial(h, w, torch.float32, mask.device), config)
        return (mask * (out.final - target) ** 2).sum() / mask.sum()

    return {"depth": loss_depth, "final": loss_final}


def explore(named_losses: dict, cam_frame) -> list:
    """Each loss's FDRows (comp by COMPS, step by EPS), printed as
    svgf_tpu's script prints them."""
    rows = []
    for name, loss in named_losses.items():
        cf = cam_frame.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(cf), [cf])
        for comp in COMPS:
            for eps in EPS:
                with torch.no_grad():
                    fp, fm = cam_frame.clone(), cam_frame.clone()
                    fp[0, comp, 3] += eps
                    fm[0, comp, 3] -= eps
                    fd = (float(loss(fp)) - float(loss(fm))) / (2 * eps)
                an = float(g[0, comp, 3])
                rel = abs(fd - an) / max(abs(fd), abs(an), 1e-9)
                rows.append(FDRow(name, comp, eps, fd, an, rel))
                print(rows[-1].line(), flush=True)
    return rows


def main(argv=None, device="cuda", height: int = H, width: int = W) -> list:
    from svgf_tpu_torch.scripts.timing import kernel_mode, report

    h, w = parse_size(argv, height, width)
    arrays = cornell_arrays(h, w, device)
    mode = kernel_mode(device)
    mask = interior_mask(arrays, h, w, mode)
    print("interior pixels:", int(mask.sum()), "/", h * w, flush=True)
    rows = explore(losses(arrays, grad_config(h, w), mask, mode), arrays.cam_frame)
    report("grad_fd_explore", device, [r._asdict() for r in rows], height=h, width=w,
           interior=int(mask.sum()))
    return rows


if __name__ == "__main__":
    main()
