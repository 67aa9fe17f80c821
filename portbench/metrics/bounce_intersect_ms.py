"""bounce_intersect_ms: the trace's batched intersects a frame, by the
program's own marks: the summed device ms of every bounce's intersect part
(trace.b<k>.intersect: the rays' concat and the one K5 call), median over
the recorded frames."""

import re

from portbench import program_spans as ps

INTERSECT = re.compile(r"trace\.b\d+\.intersect")


def read(trace):
    return ps.median(ps.summed(INTERSECT.fullmatch))
