"""Each kernel's bound, one module a kernel, found by the kernel's name:
`bound(shapes, counters) -> (seconds a step, "bytes" | "operations")`,
the least time one H100 could take for the kernel's work in one step
(peaks.bound). Inputs are counted read once, outputs written once."""

from __future__ import annotations

import importlib


def kernel(name: str):
    return importlib.import_module(f"portbench.roofline.{name}")
