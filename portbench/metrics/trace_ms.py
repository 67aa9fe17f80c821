"""trace_ms: the program's trace span a step (Renderer.step's CUDA events), mean over the traced steps."""

from portbench.metrics import mean_span


def read(trace):
    return mean_span(trace, "trace_ms")
