"""Wrappers of the four SVGF filter kernels (svgf_tpu_torch/csrc).

Each wrapper has the signature of its plain version in render/svgf.py.
Given CUDA tensors it checks device, dtype, shape and contiguity, launches
its kernel on the current stream and raises if the launch fails; given CPU
tensors it runs the plain version. It never falls back from a CUDA tensor
to the plain version. `LAUNCHES` (kernels/launch.py) counts kernel
launches per wrapper.

| wrapper         | kernel           | replaces (svgf_tpu/kernels/planar.py)  |
|-----------------|------------------|----------------------------------------|
| temporal_filter | csrc/temporal.cu | temporal_planar (:454)                 |
| filter_moments  | csrc/moments.cu  | moments_planar (:721)                  |
| wavelet_filter  | csrc/atrous.cu   | atrous_chain_planar_v2 (:918)          |
| taa             | csrc/taa.cu      | taa_planar (:1153)                     |

All four are stencils or gathers over a few dozen bytes per pixel, so the
card's memory bandwidth bounds them; each source's header says what its
design does about that.
"""

from __future__ import annotations

import torch

from svgf_tpu_torch.kernels.build import library
from svgf_tpu_torch.kernels.launch import LAUNCHES, check, launch, on_cpu, ptr, reset_launches
from svgf_tpu_torch.render import svgf
from svgf_tpu_torch.render.svgf import TemporalResult
from svgf_tpu_torch.render.types import GBuffer

__all__ = ["LAUNCHES", "reset_launches", "temporal_filter", "filter_moments",
           "wavelet_filter", "taa"]

_STATE_TYPES = {torch.float16: "f16", torch.float32: "f32"}


def _normal_squarings(phi_normal: float) -> int:
    """k when phi_normal == 2^k for an integer k >= 1 (the kernel squares k
    times), else -1 (the kernel calls powf)."""
    p = int(phi_normal)
    if p == phi_normal and p > 1 and p & (p - 1) == 0:
        return p.bit_length() - 1
    return -1


def _check_gbuffer(gbuf: GBuffer, h: int, w: int, fields) -> None:
    shapes = {"depth": (h, w), "depth_deriv": (h, w), "normal": (h, w, 3),
              "instance": (h, w), "motion": (h, w, 2)}
    for f in fields:
        dtypes = (torch.int32,) if f == "instance" else (torch.float32,)
        check(getattr(gbuf, f), f"gbuf.{f}", shapes[f], dtypes)


def temporal_filter(current, prev_color, gbuf: GBuffer, prev_gbuf: GBuffer, prev_moments,
                    prev_history, depth_threshold: float, normal_threshold: float,
                    history_base_length: int) -> TemporalResult:
    """K1 (csrc/temporal.cu); plain version svgf.temporal_filter. The
    previous-frame state is fp16 or fp32, one type for all of it.

    Replaces svgf_tpu/kernels/planar.py temporal_planar. Memory-bound:
    ~68 B read (40 B current frame, 28 B fp16 state) and 29 B written per
    pixel; one thread per pixel reads the fp16 state where it lies, with
    no motion bound and no packed planes."""
    tensors = (current, prev_color, prev_moments, prev_history, *gbuf, *prev_gbuf)
    if on_cpu(*tensors):
        return svgf.temporal_filter(current, prev_color, gbuf, prev_gbuf, prev_moments,
                                    prev_history, depth_threshold, normal_threshold,
                                    history_base_length)
    h, w = current.shape[:2]
    st = prev_color.dtype
    if st not in _STATE_TYPES:
        raise ValueError(f"prev_color: dtype {st}, expected float16 or float32")
    check(current, "current", (h, w, 3), (torch.float32,))
    _check_gbuffer(gbuf, h, w, ("depth", "normal", "instance", "motion"))
    check(prev_color, "prev_color", (h, w, 4), (st,))
    check(prev_gbuf.depth, "prev_gbuf.depth", (h, w), (st,))
    check(prev_gbuf.normal, "prev_gbuf.normal", (h, w, 3), (st,))
    check(prev_gbuf.instance, "prev_gbuf.instance", (h, w), (torch.int32,))
    check(prev_moments, "prev_moments", (h, w, 2), (st,))
    check(prev_history, "prev_history", (h, w), (torch.int32,))
    dev = current.device
    color = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    moments = torch.empty((h, w, 2), dtype=torch.float32, device=dev)
    history = torch.empty((h, w), dtype=torch.int32, device=dev)
    valid = torch.empty((h, w), dtype=torch.bool, device=dev)
    fn = getattr(library(), f"svgf_temporal_{_STATE_TYPES[st]}")
    launch(fn, dev, *map(ptr, (
        current, gbuf.depth, gbuf.normal, gbuf.instance, gbuf.motion, prev_color,
        prev_gbuf.depth, prev_gbuf.normal, prev_gbuf.instance, prev_moments, prev_history,
        color, moments, history, valid)),
        h, w, depth_threshold, normal_threshold, history_base_length)
    LAUNCHES["temporal"] += 1
    return TemporalResult(color=color, moments=moments, history_len=history, reprojected=valid)


def filter_moments(color, moments, gbuf: GBuffer, history_len, phi_colour: float,
                   phi_normal: float):
    """K2 (csrc/moments.cu); plain version svgf.filter_moments.

    Replaces svgf_tpu/kernels/planar.py moments_planar. Memory-bound for
    the pass-through pixels (24 B read, 16 B written); a history < 4 pixel
    reads 49 taps of 40 B, shared with its neighbours through L1/L2; one
    thread per pixel, out-of-image taps skipped."""
    if on_cpu(color, moments, history_len, gbuf.depth, gbuf.depth_deriv, gbuf.normal):
        return svgf.filter_moments(color, moments, gbuf, history_len, phi_colour, phi_normal)
    h, w = color.shape[:2]
    check(color, "color", (h, w, 4), (torch.float32,))
    check(moments, "moments", (h, w, 2), (torch.float32,))
    check(history_len, "history_len", (h, w), (torch.int32,))
    _check_gbuffer(gbuf, h, w, ("depth", "depth_deriv", "normal"))
    out = torch.empty((h, w, 4), dtype=torch.float32, device=color.device)
    launch(library().svgf_moments, color.device, *map(ptr, (
        color, moments, gbuf.depth, gbuf.depth_deriv, gbuf.normal, history_len, out)),
        h, w, phi_colour, phi_normal, _normal_squarings(phi_normal))
    LAUNCHES["moments"] += 1
    return out


def wavelet_filter(img, gbuf: GBuffer, steps: int, phi_colour: float, phi_normal: float):
    """K3 (csrc/atrous.cu), launched once per step; plain version
    svgf.wavelet_filter. Returns (final, feedback, second_last), where
    feedback is iteration 0's output, kept in its own buffer while the
    later steps ping-pong between two others.

    Replaces svgf_tpu/kernels/planar.py atrous_chain_planar_v2. Bound by
    memory and L2: 25 taps of 32 B read and 16 B written per pixel and
    step; one thread per pixel, a warp's taps coalesce."""
    if on_cpu(img, gbuf.depth, gbuf.depth_deriv, gbuf.normal):
        return svgf.wavelet_filter(img, gbuf, steps, phi_colour, phi_normal)
    h, w = img.shape[:2]
    check(img, "img", (h, w, 4), (torch.float32,))
    _check_gbuffer(gbuf, h, w, ("depth", "depth_deriv", "normal"))
    fn = library().svgf_atrous_step
    squarings = _normal_squarings(phi_normal)
    bufs = [torch.empty_like(img) for _ in range(min(steps, 3))]
    feedback = prev = out = img
    for i in range(steps):
        prev = out
        out = bufs[0] if i == 0 else bufs[1 + (i - 1) % 2]
        launch(fn, img.device, *map(ptr, (prev, gbuf.depth, gbuf.depth_deriv, gbuf.normal, out)),
                h, w, 1 << i, phi_colour, phi_normal, squarings)
        LAUNCHES["atrous"] += 1
        if i == 0:
            feedback = out
    return out, feedback, prev


def taa(filtered, history):
    """K4 (csrc/taa.cu); plain version svgf.taa. `history` is fp16 or fp32.

    Replaces svgf_tpu/kernels/planar.py taa_planar. Memory-bound: 9 taps
    of 16 B (shared through L1) and 8 B of fp16 history read, 16 B written
    per pixel; one thread per pixel, edge-clamped taps."""
    if on_cpu(filtered, history):
        return svgf.taa(filtered, history)
    h, w = filtered.shape[:2]
    check(filtered, "filtered", (h, w, 4), (torch.float32,))
    check(history, "history", (h, w, 4), tuple(_STATE_TYPES))
    out = torch.empty((h, w, 4), dtype=torch.float32, device=filtered.device)
    fn = getattr(library(), f"svgf_taa_{_STATE_TYPES[history.dtype]}")
    launch(fn, filtered.device, ptr(filtered), ptr(history), ptr(out), h, w)
    LAUNCHES["taa"] += 1
    return out
