"""Build the CUDA sources of svgf_tpu_torch/csrc into one shared library
and load it with ctypes.

The sources have a plain C interface, so nvcc builds them in seconds
without PyTorch's headers. The library lands in build/svgf_tpu_torch/ at
the repository root, named by a hash of the sources and flags, and is
built at first use in a process; nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "svgf_tpu_torch"
# --fmad=false: no contraction into fused multiply-adds, so the kernels
# round like the plain torch versions they are checked against.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# every launcher takes (pointers..., ints/floats..., stream) and returns a cudaError_t
SIGNATURES = {
    "svgf_temporal_f32": [_P] * 15 + [_I, _I, _F, _F, _I, _P],
    "svgf_temporal_f16": [_P] * 15 + [_I, _I, _F, _F, _I, _P],
    "svgf_moments": [_P] * 7 + [_I, _I, _F, _F, _I, _P],
    "svgf_atrous_step": [_P] * 5 + [_I, _I, _I, _F, _F, _I, _P],
    "svgf_taa_f32": [_P] * 3 + [_I, _I, _P],
    "svgf_taa_f16": [_P] * 3 + [_I, _I, _P],
}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libsvgf_kernels_{digest.hexdigest()[:16]}.so"


def build(extra_flags=()) -> tuple[Path, str]:
    """Compile the sources if the library for their hash is missing.
    Returns (library path, nvcc's output; empty when nothing was built)."""
    out = library_path()
    if out.exists() and not extra_flags:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
