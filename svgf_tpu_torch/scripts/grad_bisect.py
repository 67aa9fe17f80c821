"""Where a non-finite camera gradient enters the pipeline: the port's copy
of svgf_tpu's scripts/grad_bisect.py.

The gradient with respect to `cam_frame` of six successively deeper
pipeline prefixes of the Cornell box at 24x16 (1 bounce, 1 a-trous step,
float32 state), each reported as finite or not with its largest finite
magnitude. svgf_tpu's script differentiates `intersect_scene` while its
intersector policy is still "auto", which on its chip is the Pallas
kernel: here the four G-buffer and trace rows take the intersector
`timing.kernel_mode(device)`, K5 on the card (it picks each winner and
torch recomputes t/u/v, which carry the gradient). The two frame rows run
`render_frame` on the configuration's use_pallas="off", as svgf_tpu's
pipeline does: the filter kernels refuse autograd.

Each row (`Row`): the name, whether every entry is finite, the largest
finite |g|, the gradient (a numpy array of cam_frame's shape), and the
gradient's ms (CUDA events on the card, the host clock on the CPU), the
peak device memory in MiB (None on the CPU) and the kernel wrappers'
launches during it. main prints svgf_tpu's table line by line, then the
card line and one JSON line of the rows without their gradients.

Usage: python -m svgf_tpu_torch.scripts.grad_bisect [height width]
(on the card; main(device="cpu") runs the plain versions on the CPU).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

H, W = 16, 24

# the intersects a row's loss makes through `mode` (K5 launches on the
# card): the G-buffer's, the trace's primary and its bounce's batched
# shadow and BSDF rays; the frame rows intersect on the configuration's
# plain route
K5_CALLS = {"gbuffer pos/normal/depth": 1, "gbuffer motion": 1, "trace (no hybrid)": 2,
            "trace (hybrid primary)": 2, "full frame 1": 0, "full frame 2 (temporal)": 0}


class Row(NamedTuple):
    name: str
    finite: bool
    gmax: float                # the largest finite |g| (nan where none is finite)
    grad: np.ndarray           # d loss / d cam_frame
    ms: float                  # forward + backward
    peak_mib: float | None     # peak device memory during it (None on the CPU)
    launches: dict             # kernel wrappers' launches during it

    def line(self, width: int) -> str:
        """svgf_tpu's printed line of the row, its name padded to `width`."""
        n_bad = self.grad.size - int(np.isfinite(self.grad).sum())
        return (f"{self.name:{width}s} finite={self.finite}  |g|max={self.gmax:.3g}"
                + ("" if self.finite else f"  n_nonfinite={n_bad}"))

    def summary(self) -> dict:
        """The row without its gradient, for the JSON line."""
        return {k: v for k, v in self._asdict().items() if k != "grad"}


def grad_or_zero(out, x):
    """d out / d x, x the only tensor that requires grad; zeros where out
    does not depend on x (as jax.grad gives: a stage such as the
    emission's is a constant of the camera)."""
    if not out.requires_grad:
        return torch.zeros_like(x)
    (g,) = torch.autograd.grad(out, [x])
    return g


def gradient_row(name: str, loss, cam_frame) -> Row:
    """d loss(cam_frame) / d cam_frame and its figures."""
    from svgf_tpu_torch.kernels.launch import LAUNCHES

    cuda = cam_frame.device.type == "cuda"
    cf = cam_frame.detach().clone().requires_grad_(True)
    before = dict(LAUNCHES)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    g = grad_or_zero(loss(cf), cf)
    if cuda:
        end.record()
        torch.cuda.synchronize()
        ms, peak = start.elapsed_time(end), torch.cuda.max_memory_allocated() / 2**20
    else:
        ms, peak = (time.perf_counter() - t0) * 1e3, None
    launches = {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]}
    g = g.cpu().numpy()
    ok = np.isfinite(g)
    gmax = float(np.abs(g[ok]).max()) if ok.any() else float("nan")
    return Row(name, bool(ok.all()), gmax, g, ms, peak, launches)


def cornell_arrays(h: int, w: int, device):
    """svgf_tpu's scripts' scene: the Cornell box, its camera at aspect w/h."""
    from svgf_tpu_torch.scenes.cornell import cornell_box

    scene = cornell_box()
    scene.cameras[0].aspect = w / h
    return scene.flatten(device=device)


def grad_config(h: int, w: int):
    """svgf_tpu's scripts' configuration: 1 bounce, 1 a-trous step, float32
    state, the plain filters."""
    from svgf_tpu_torch.config import RenderConfig, SVGFConfig, TracingConfig

    return RenderConfig(width=w, height=h, state_dtype="float32", use_pallas="off",
                        tracing=TracingConfig(bounces=1),
                        svgf=SVGFConfig(spatial_filter_steps=1))


def losses(arrays, config, h: int, w: int, mode: str) -> dict:
    """svgf_tpu's six losses of cam_frame, by row name, in its order. The
    G-buffer and trace rows intersect with `mode`; the frame rows with the
    configuration's policy."""
    from svgf_tpu_torch.ops.keys import key
    from svgf_tpu_torch.render.gbuffer import camera_rays, gbuffer_first_hit, raster_gbuffer
    from svgf_tpu_torch.render.pathtrace import pathtrace
    from svgf_tpu_torch.render.pipeline import render_frame
    from svgf_tpu_torch.render.types import TemporalState

    cam = 0
    dev = arrays.cam_frame.device
    lanes = torch.arange(h * w, device=dev)
    mk_scene = lambda cf: dataclasses.replace(arrays, cam_frame=cf)

    def loss_gbuffer(cf):
        g = raster_gbuffer(mk_scene(cf), cam, h, w, mode=mode)
        return (g.position ** 2).mean() + (g.normal ** 2).mean() + (g.depth ** 2).mean()

    def loss_gbuffer_motion(cf):
        return (raster_gbuffer(mk_scene(cf), cam, h, w, mode=mode).motion ** 2).mean()

    def loss_trace(cf, hybrid=False):
        sc = mk_scene(cf)
        fh = gbuffer_first_hit(raster_gbuffer(sc, cam, h, w, mode=mode)) if hybrid else None
        ro, rd = camera_rays(sc.cam_frame[cam], sc.cam_proj[cam], h, w)
        rad, _ = pathtrace(sc, ro, rd, key(0), lanes, bounces=1, first_hit=fh,
                           intersect_mode=mode)
        return (rad ** 2).mean()

    def loss_frame(cf, frames):
        state = TemporalState.initial(h, w, torch.float32, dev)
        for _ in range(frames):
            out, state = render_frame(mk_scene(cf), state, config)
        return (out.final ** 2).mean()

    return {
        "gbuffer pos/normal/depth": loss_gbuffer,
        "gbuffer motion": loss_gbuffer_motion,
        "trace (no hybrid)": loss_trace,
        "trace (hybrid primary)": lambda cf: loss_trace(cf, hybrid=True),
        "full frame 1": lambda cf: loss_frame(cf, 1),
        "full frame 2 (temporal)": lambda cf: loss_frame(cf, 2),
    }


def bisect(named_losses: dict, cam_frame, width: int = 32) -> list:
    """Each loss's Row, printed as svgf_tpu's script prints it."""
    rows = []
    for name, loss in named_losses.items():
        rows.append(gradient_row(name, loss, cam_frame))
        print(rows[-1].line(width), flush=True)
    return rows


def parse_size(argv, height: int, width: int) -> tuple[int, int]:
    """[height width] from the command line, else the keywords."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (0, 2):
        raise SystemExit("usage: [height width]")
    return (int(argv[0]), int(argv[1])) if argv else (height, width)


def main(argv=None, device="cuda", height: int = H, width: int = W) -> list:
    from svgf_tpu_torch.scripts.timing import kernel_mode, report

    h, w = parse_size(argv, height, width)
    arrays = cornell_arrays(h, w, device)
    rows = bisect(losses(arrays, grad_config(h, w), h, w, kernel_mode(device)),
                  arrays.cam_frame)
    report("grad_bisect", device, [r.summary() for r in rows], height=h, width=w)
    return rows


if __name__ == "__main__":
    main()
