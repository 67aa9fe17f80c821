"""host_syncs_per_step: the host-device synchronizations the program's own
code causes inside a frame (render_frame or filter_chain), as the program
counts them in the recorded frames that count them, median over those
frames."""

from portbench import program_spans as ps


def read(trace):
    return ps.median(ps.counted())
