"""Frame-level records: G-buffer, temporal state, metrics and outputs
(svgf_tpu/render/types.py), as NamedTuples of tensors.

The state keeps svgf_tpu's image layout (H, W, C) at the configured state
dtype (real torch.float16 by default, as the reference stores it,
App.cu:763-773). There is no PlanarState: the 128-lane planar layout and
its fp16 pairs exist only for the TPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svgf_tpu_torch.core.scene import target_device


class GBuffer(NamedTuple):
    """Primary-visibility targets (reference G-buffer, App.cu:746-778).

      depth == 0 marks an invalid/background pixel (GetDepth, Filter.cuh:199-207)
      instance == -1 marks background
    """

    position: torch.Tensor     # (H, W, 3) world-space hit position
    normal: torch.Tensor       # (H, W, 3) world-space shading-geometry normal
    motion: torch.Tensor       # (H, W, 2) pixel-space motion vector (prev - cur)
    depth: torch.Tensor        # (H, W) camera distance; 0 = invalid
    depth_deriv: torch.Tensor  # (H, W) max |screen-space depth derivative|
    uv: torch.Tensor           # (H, W, 2) barycentric (u, v) at the hit
    instance: torch.Tensor     # (H, W) i32; -1 = background
    prim: torch.Tensor         # (H, W) i32 global triangle id
    material: torch.Tensor     # (H, W) i32

    @staticmethod
    def zeros(h: int, w: int, dtype=torch.float32, device="cuda") -> "GBuffer":
        """An empty G-buffer on `device`: the card unless told otherwise
        (raises without one, as Renderer does)."""
        device = target_device(device)
        f = lambda *c: torch.zeros((h, w) + c, dtype=dtype, device=device)
        i = lambda: torch.full((h, w), -1, dtype=torch.int32, device=device)
        return GBuffer(
            position=f(3), normal=f(3), motion=f(2), depth=f(), depth_deriv=f(),
            uv=f(2), instance=i(), prim=i(), material=i(),
        )

    def to_dtype(self, dtype) -> "GBuffer":
        """Floating-point fields cast to `dtype`; integer fields unchanged."""
        return GBuffer(*(x.to(dtype) if x.is_floating_point() else x for x in self))


class TemporalState(NamedTuple):
    """Cross-frame state (the reference's ping-pong buffer set).

    color:       previous frame's RGB + variance; after a full frame this is
                 the iteration-0 a-trous output (Filter.cuh:619-622).
    moments:     first/second luminance moments.
    history_len: per-pixel EMA history length (int32).
    taa_history: previous TAA output.
    gbuffer:     previous frame's G-buffer (reprojection validity tests).
    frame_idx:   frame counter, a host int (feeds the RNG key chain).
    """

    color: torch.Tensor        # (H, W, 4) state dtype
    moments: torch.Tensor      # (H, W, 2) state dtype
    history_len: torch.Tensor  # (H, W) i32
    taa_history: torch.Tensor  # (H, W, 4) state dtype
    gbuffer: GBuffer
    frame_idx: int

    @staticmethod
    def initial(h: int, w: int, dtype=torch.float16, device="cuda") -> "TemporalState":
        """The state before frame 0, on `device`: the card unless told
        otherwise (raises without one, as Renderer does)."""
        device = target_device(device)
        return TemporalState(
            color=torch.zeros((h, w, 4), dtype=dtype, device=device),
            moments=torch.zeros((h, w, 2), dtype=dtype, device=device),
            history_len=torch.zeros((h, w), dtype=torch.int32, device=device),
            taa_history=torch.zeros((h, w, 4), dtype=dtype, device=device),
            gbuffer=GBuffer.zeros(h, w, dtype, device),
            frame_idx=0,
        )


class FrameMetrics(NamedTuple):
    """Per-frame observability (0-d device tensors; reading one syncs)."""

    disoccluded_pct: torch.Tensor  # % pixels failing reprojection
    mean_history: torch.Tensor     # mean temporal history length
    mean_variance: torch.Tensor    # mean per-pixel variance estimate
    coverage_pct: torch.Tensor     # % pixels with a primary hit
    rays_traced: torch.Tensor      # active lanes of every intersect call (int64)


class FrameOutputs(NamedTuple):
    """Everything a frame produces — the debug-tap surface (App.h:92-105)."""

    image: torch.Tensor            # selected tap (sRGB for FINAL)
    radiance: torch.Tensor | None  # raw path-traced radiance (H, W, 3)
    temporal: torch.Tensor | None  # after temporal accumulation (H, W, 4)
    moments_filtered: torch.Tensor | None  # after the moments fallback (H, W, 4)
    atrous: torch.Tensor | None    # after the wavelet chain (H, W, 4)
    final: torch.Tensor            # after TAA + sRGB (H, W, 3)
    gbuffer: GBuffer | None
    metrics: FrameMetrics | None = None
