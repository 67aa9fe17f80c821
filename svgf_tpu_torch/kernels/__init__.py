"""Hand-written CUDA kernels for Hopper (sources in svgf_tpu_torch/csrc/).

`resolve_kernels(mode, device)` maps the RenderConfig kernel policy
(`use_pallas`, `use_pallas_intersect`) to a choice for tensors on `device`.
It is the counterpart of svgf_tpu/kernels/__init__.py `resolve_pallas`:

  "auto"      the kernels for CUDA tensors, the plain versions on the CPU
  "on"        the kernels; raises for CPU tensors
  "off"       the plain torch versions
  "interpret" raises: a CUDA kernel has no interpreter
"""

from __future__ import annotations

import torch


def resolve_kernels(mode: str, device) -> bool:
    """True when the kernels run for tensors on `device`."""
    cuda = torch.device(device).type == "cuda"
    if mode == "off":
        return False
    if mode == "auto":
        return cuda
    if mode == "on":
        if not cuda:
            raise ValueError(f"use_pallas='on' needs CUDA tensors, got device {device}")
        return True
    if mode == "interpret":
        raise ValueError("use_pallas='interpret' has no CUDA counterpart; use 'off' or 'auto'")
    raise ValueError(f"use_pallas must be auto/on/off/interpret, got {mode!r}")
