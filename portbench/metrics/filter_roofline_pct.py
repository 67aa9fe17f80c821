"""filter_roofline_pct: K1-K4's summed bounds over their summed device time
(roofline/{temporal,moments,atrous,taa}.py), in percent."""

from portbench.metrics import roofline_pct


def read(trace):
    return roofline_pct(trace, ("temporal", "moments", "atrous", "taa"))
