"""filter_p95_ms: a denoised frame's device-time tail: the 95th percentile
over the recorded frames of the device ms from the program's filter.begin
mark (filter_chain's entry) to its taa mark: the parts temporal, moments,
atrous and taa."""

from portbench import program_spans as ps

FILTER = ("temporal", "moments", "atrous", "taa")


def read(trace):
    return ps.p95(ps.summed(FILTER.__contains__))
