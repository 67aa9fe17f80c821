"""shade_ms: the trace's shading a frame, by the program's own marks: the
summed device ms of every bounce's surface, sample, MIS and cull parts
(trace.b<k>.surface/sample/mis/cull), median over the recorded frames."""

import re

from portbench import program_spans as ps

SHADING = re.compile(r"trace\.b\d+\.(surface|sample|mis|cull)")


def read(trace):
    return ps.median(ps.summed(SHADING.fullmatch))
