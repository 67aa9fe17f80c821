"""k5_roofline_pct: K5's bound on the steps' calls (roofline/intersect_dense.py,
active lanes from FrameMetrics.rays_traced) over its device time, in percent."""

from portbench.metrics import roofline_pct


def read(trace):
    if "rays_traced" not in trace.counters:
        return None
    return roofline_pct(trace, ("intersect_dense",))
