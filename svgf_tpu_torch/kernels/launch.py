"""What every kernel wrapper shares: the launch counts, the device policy
(CPU tensors take the plain version, CUDA tensors the kernel, anything
else raises), argument checks and the launch itself."""

from __future__ import annotations

import ctypes

import torch

# Kernel launches per wrapper, counted where the wrapper launches its
# kernel and nowhere else; chip_smoke.py reads them around the main path.
LAUNCHES = {"temporal": 0, "moments": 0, "atrous": 0, "taa": 0,
            "intersect_dense": 0, "intersect_clustered": 0,
            "temporal_band": 0, "moments_band": 0, "atrous_iteration": 0, "taa_band": 0,
            "shade_pre": 0, "shade_post": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU; False when every one is on one
    CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def check(t: torch.Tensor, name: str, shape: tuple, dtypes) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(fn, device, *args) -> None:
    """Call a launcher of the kernel library on the current stream of
    `device`; raises if the launch failed. A tensor among `args` goes as
    its pointer, and lives until the kernel is on the stream."""
    args = [ptr(a) if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: launch failed with CUDA error {err}")
