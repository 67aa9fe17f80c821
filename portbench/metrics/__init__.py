"""Per-layer metrics, one module a metric, found by the metric's name in
BENCHMARK.json (`module_for`): `read(trace) -> float | None`, from a traced window
(profiling.Trace). A reader that finds nothing to read returns None, and
the harness leaves the metric out of the line."""

from __future__ import annotations

import importlib

from portbench import port

DEVICE_COPIES = ("Memcpy", "Memset")


def module_for(package: str, name: str):
    """The module of metric `name` in `package`: `<name>.py`, its dots as
    underscores."""
    return importlib.import_module(f"portbench.{package}.{name.replace('.', '_')}")


def reader(name: str):
    return module_for("metrics", name).read


def kernel_us(trace, kernel: str) -> float:
    """Summed device microseconds of one of the program's kernels."""
    sub = port.KERNELS[kernel]
    return sum(d for n, _, d in trace.kernels if sub in n)


def mean_span(trace, name: str):
    v = trace.spans.get(name)
    return sum(v) / len(v) if v else None


def roofline_pct(trace, kernels) -> float | None:
    """The kernels' summed bounds over their summed device time, in percent;
    None where one of them left no record."""
    from portbench import roofline

    steps = [{n: v[i] for n, v in trace.counters.items()} for i in range(trace.steps)]
    bound_s = dev_us = 0.0
    for k in kernels:
        us = kernel_us(trace, k)
        if us <= 0:
            return None
        dev_us += us
        bound_s += sum(roofline.kernel(k).bound(trace.shapes, c)[0] for c in steps)
    return 100.0 * bound_s / (dev_us / 1e6)
