"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates): HBM3 3.35 TB/s, FP32 outside the tensor cores 67
TFLOP/s. FP32 operations are counted from the kernel sources: add, sub,
mul, div, min, max, abs, compare, sqrt, exp and pow one each."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(seconds, what bounds it): the larger of bytes over the memory rate
    and operations over the FP32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
