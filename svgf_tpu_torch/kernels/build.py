"""Build the CUDA sources of svgf_tpu_torch/csrc into one shared library
and load it with ctypes.

The sources have a plain C interface, so nvcc builds them in seconds
without PyTorch's headers: one nvcc per source, all started together,
then one link. The library lands in build/svgf_tpu_torch/ at the
repository root, named by a hash of the sources and flags, and is built at
first use in a process; nothing is built at import time.
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
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# the suffixes of the entries that read the SVGF state at its stored type
# (fp32, fp16, bf16); kernels/filter.py maps torch dtypes onto them
STATE_TYPES = ("f32", "f16", "bf16")
# every launcher takes (pointers..., ints/floats..., stream) and returns a cudaError_t
SIGNATURES = {
    **{f"svgf_temporal_{t}": [_P] * 15 + [_I, _I, _F, _F, _I, _P] for t in STATE_TYPES},
    **{f"svgf_temporal_band_{t}": [_P] * 15 + [_I, _I, _F, _F, _I] + [_I] * 6 + [_P]
       for t in STATE_TYPES},
    "svgf_moments": [_P] * 7 + [_I, _I, _F, _F, _I, _I, _P],
    "svgf_atrous_step": [_P] * 5 + [_I, _I, _I, _F, _F, _I] + [_I] * 4 + [_P],
    **{f"svgf_taa_{t}": [_P] * 3 + [_I, _I, _P] for t in STATE_TYPES},
    "svgf_intersect_dense": [_P] * 12 + [_I, _I, _I, _I, _P],
    "svgf_intersect_bvh": [_P] * 14 + [_I, _I, _P, _P],
    # the scene's 9 tables, the lights' host ints and 6 counts, then the rays
    "svgf_shade_pre": [_P] * 10 + [_I] * 6 + [_P] * 13 + [_U, _I, _P],
    "svgf_shade_post": [_P] * 10 + [_I] * 6 + [_P] * 27 + [_U, _I, _I, _F, _I, _P],
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
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    texts = [p.communicate()[0] for p in procs]
    steps = [(p.args[-1], p.returncode, text) for p, text in zip(procs, texts)]
    if all(rc == 0 for _, rc, _ in steps):
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        steps.append(("link", link.returncode, link.stdout))
    for obj in objs:
        obj.unlink(missing_ok=True)
    report = "".join(text for _, _, text in steps)
    failed = [name for name, rc, _ in steps if rc != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{report}")
    os.replace(tmp, out)
    return out, report


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
