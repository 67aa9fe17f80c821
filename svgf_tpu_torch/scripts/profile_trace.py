"""Where the trace stage's time goes: the port's copy of svgf_tpu's
scripts/profile_trace.py.

Sweeps `trace_chunks` (the sequential lane chunks of the wavefront) on a
trace-only frame of the Cornell box at 1080p (1 spp, 3 bounces, clamp 10,
no a-trous step, no TAA, fp16 state, no taps kept, the kernels), then
times the G-buffer pass alone at the last chunk count. Each row: the
frame's device and host ms (best of 3, the state carried from frame to
frame, as svgf_tpu's donated state is) and, on the card, the device kernels
of one frame (timing.timed). Lanes keep their global ids, so the radiance
of a frame does not depend on the chunk count: main returns the first
frame's radiance of every count beside the rows.

Usage: python -m svgf_tpu_torch.scripts.profile_trace [chunks ...]
(main also takes `height` / `width` and `device`, which the command line
does not expose.)
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple


class Sweep(NamedTuple):
    rows: list         # one per chunk count, then the G-buffer's
    radiance: dict     # chunk count -> the first frame's radiance (H, W, 3)


def trace_config(h: int, w: int, chunks: int, use_pallas: str):
    """svgf_tpu's trace-only configuration."""
    from svgf_tpu_torch.config import RenderConfig, SVGFConfig, TracingConfig

    return RenderConfig(
        width=w, height=h,
        tracing=TracingConfig(batch=1, bounces=3, clamp=10.0),
        svgf=SVGFConfig(spatial_filter_steps=0, enable_taa=False),
        trace_chunks=chunks, state_dtype="float16", keep_taps=False, use_pallas=use_pallas,
    )


def main(argv=None, device="cuda", height: int = 1080, width: int = 1920) -> Sweep:
    import torch

    from svgf_tpu_torch.render.gbuffer import raster_gbuffer
    from svgf_tpu_torch.render.pipeline import render_frame
    from svgf_tpu_torch.render.types import TemporalState
    from svgf_tpu_torch.scenes.cornell import cornell_box
    from svgf_tpu_torch.scripts.timing import fmt, kernel_mode, report, timed

    argv = sys.argv[1:] if argv is None else argv
    chunk_list = [int(a) for a in argv] or [32, 8, 4, 2, 1]
    h, w = height, width
    mode = kernel_mode(device)
    print(f"device: {device}  frame: {w}x{h}  kernels: {mode}", flush=True)
    scene = cornell_box()
    scene.cameras[0].aspect = w / h
    arrays = scene.flatten(device=device)

    rows, radiance = [], {}
    with torch.no_grad():
        for nc in chunk_list:
            cfg = trace_config(h, w, nc, mode)
            # frame 0 keeps its radiance tap: the same work, its output kept
            out, st = render_frame(arrays, TemporalState.initial(h, w, torch.float16, device),
                                   dataclasses.replace(cfg, keep_taps=True))
            radiance[nc] = out.radiance
            state = [st]

            def step(cfg=cfg, state=state):
                state[0] = render_frame(arrays, state[0], cfg)[1]

            rows.append(timed(step, 1, reps=3, device=device, warmup=0)
                        .row(f"trace_chunks={nc}", chunks=nc))
            print(fmt(rows[-1]), flush=True)

        nc = chunk_list[-1]
        gb = lambda: raster_gbuffer(arrays, 0, h, w, num_chunks=nc, mode=mode)
        rows.append(timed(gb, 1, reps=3, device=device)
                    .row(f"gbuffer alone (chunks={nc})", chunks=nc))
        print(fmt(rows[-1]), flush=True)
    report("profile_trace", device, rows, height=h, width=w)
    return Sweep(rows, radiance)


if __name__ == "__main__":
    main()
