"""End-to-end metrics, one module a metric, found by the metric's name in
BENCHMARK.json as the per-layer ones are (portbench.metrics.module_for): `value(window) -> float`, where window holds the timed
window's step times (s), its wall time (s), the set-up time (s) and the
peak device memory (bytes)."""

from __future__ import annotations

from portbench.metrics import module_for


def value(name: str, window: dict) -> float:
    return module_for("e2e", name).value(window)
