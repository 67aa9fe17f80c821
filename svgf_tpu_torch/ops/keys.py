"""Host threefry2x32 keys, bit-identical to `jax.random.key` / `fold_in`.

svgf_tpu derives every per-frame, per-sample and per-bounce RNG seed from
a chain of `jax.random.fold_in` calls on a threefry2x32 key
(svgf_tpu/render/pipeline.py:215-223, render/pathtrace.py:294). The port
computes that chain here, on Python ints, so it needs no JAX at render
time. A key is the pair of uint32 words that `jax.random.key_data` gives.
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: tuple[int, int], x0: int, x1: int) -> tuple[int, int]:
    """The 20-round Threefry-2x32 block of (x0, x1) under `key`."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """`jax.random.key(seed)` for a 32-bit seed: the words (0, seed)."""
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is outside int32")
    return 0, seed & _M32


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """`jax.random.fold_in(k, data)`: threefry of the block (0, data)."""
    return threefry2x32(k, 0, data & _M32)
