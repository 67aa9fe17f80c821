"""filter_ms: the program's filter span a step (Renderer.step's CUDA events; in a denoise cell from the benchmark's event before filter_chain to its taa event), mean over the traced steps."""

from portbench.metrics import mean_span


def read(trace):
    return mean_span(trace, "filter_ms")
