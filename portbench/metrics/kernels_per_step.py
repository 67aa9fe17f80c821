"""kernels_per_step: device kernels a step (copies and fills left out)."""

from portbench.metrics import DEVICE_COPIES


def read(trace):
    n = sum(1 for name, _, _ in trace.kernels if not name.startswith(DEVICE_COPIES))
    return n / trace.steps if n else None
