"""ctypes bindings of the native (C++) build components, the port's copy of
svgf_tpu/accel/native.py over its own source, csrc_host/bvh_builder.cpp.

`build_blas_native` (binned-SAH BLAS) and `tangents_native` (Lengyel
tangents) take svgf_tpu's arguments and return its arrays. `accel/bvh.py
build_blas` and `core/scene.py Shape.preprocess` take them unless
SVGF_NATIVE=0, as svgf_tpu does.

The library is compiled with g++ (or $CXX) at its first use in a process,
with native/Makefile's flags, into build/svgf_tpu_torch/ at the repository
root, named by a hash of the source, the flags and the host CPU's feature
flags (-march=native code runs only where it was built): a temporary
file, then os.replace, so that processes may race to build it. ISO C++
(-std=c++17) keeps floating-point contraction off, so the port's tree and
tangents are bit-equal to svgf_tpu's native ones on one machine.

Where svgf_tpu finds no library it falls back to its NumPy builder; the
port builds its own library, and a build that fails raises
NativeBuildError with the compiler's output. SVGF_NATIVE=0 selects the
NumPy builder.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from svgf_tpu_torch.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "csrc_host" / "bvh_builder.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")   # native/Makefile's


class NativeBuildError(RuntimeError):
    """The host library did not build or load."""


def enabled() -> bool:
    """Whether the native builder is selected (SVGF_NATIVE != "0", svgf_tpu's switch)."""
    return os.environ.get("SVGF_NATIVE", "1") != "0"


def _cpu_flags() -> bytes:
    """The host CPU's feature flags, which -march=native compiles for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    digest.update(_cpu_flags())
    return BUILD_DIR / f"libsvgf_host_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source if the library for its hash is missing; returns
    its path. Raises NativeBuildError with the compiler's output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.so.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-shared", "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}\n"
                               "set SVGF_NATIVE=0 to build BVHs with the NumPy builder") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stdout}\n"
                               "set SVGF_NATIVE=0 to build BVHs with the NumPy builder")
    os.replace(tmp, out)
    return out


_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int32)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeBuildError(f"{path}: {e}\n"
                               "set SVGF_NATIVE=0 to build BVHs with the NumPy builder") from e
    lib.svgf_build_blas.restype = ctypes.c_int32
    lib.svgf_build_blas.argtypes = [_FP, ctypes.c_int32, _FP, _FP, _IP, _IP]
    lib.svgf_tangents.restype = None
    lib.svgf_tangents.argtypes = [_FP, _FP, _FP, _IP, ctypes.c_int32, ctypes.c_int32, _FP]
    return lib


def available() -> bool:
    """Whether the host library builds and loads here."""
    try:
        library()
    except NativeBuildError:
        return False
    return True


def _fp(a):
    return a.ctypes.data_as(_FP)


def _ip(a):
    return a.ctypes.data_as(_IP)


def build_blas_native(tri_pos: np.ndarray):
    """Native SAH build over (T, 3, 3) triangles, T > 0. Returns (node_min
    (N, 3) f32, node_max (N, 3) f32, skip (N,) i32, leaf_tri (N,) i32)
    with N = 2T - 1 in DFS order; leaf_tri is -1 at internal nodes."""
    t = np.ascontiguousarray(tri_pos, np.float32).reshape(-1, 9)
    T = t.shape[0]
    if T <= 0:
        raise ValueError("cannot build a BVH over zero triangles")
    n = 2 * T - 1
    node_min = np.empty((n, 3), np.float32)
    node_max = np.empty((n, 3), np.float32)
    skip = np.empty((n,), np.int32)
    leaf_tri = np.empty((n,), np.int32)
    got = library().svgf_build_blas(_fp(t), T, _fp(node_min), _fp(node_max), _ip(skip),
                                    _ip(leaf_tri))
    if got != n:
        raise RuntimeError(f"svgf_build_blas returned {got} nodes for {T} triangles, not {n}")
    return node_min, node_max, skip, leaf_tri


def tangents_native(pos, nrm, uv, idx) -> np.ndarray:
    """Per-vertex (V, 4) f32 tangents by Lengyel's method (reference
    Scene.cpp:111-161) of a mesh: pos, nrm (V, 3), uv (V, 2), idx (F, 3)."""
    pos = np.ascontiguousarray(pos, np.float32)
    nrm = np.ascontiguousarray(nrm, np.float32)
    uv = np.ascontiguousarray(uv, np.float32)
    idx = np.ascontiguousarray(idx, np.int32)
    V = pos.shape[0]
    if nrm.shape != (V, 3) or uv.shape != (V, 2) or idx.ndim != 2 or idx.shape[1] != 3:
        raise ValueError(f"shapes pos {pos.shape}, nrm {nrm.shape}, uv {uv.shape}, idx {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= V):
        raise ValueError(f"indices outside [0, {V})")
    out = np.empty((V, 4), np.float32)
    library().svgf_tangents(_fp(pos), _fp(nrm), _fp(uv), _ip(idx), V, idx.shape[0], _fp(out))
    return out
