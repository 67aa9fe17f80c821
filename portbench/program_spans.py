"""The program's own spans inside a frame (svgf_tpu_torch.render.spans),
read after the traced window from the frames its two sessions recorded:
every traced step hands the program `events`, and the program keeps each
such frame's marks (name, CUDA event, host seconds) and, in one frame of
every few, its count of host-device syncs. Times are read from the frames
that did not count (the count costs the host time at each sync), the count
from the others. Besides port.py, the one module of the benchmark that
imports the program. Where there is nothing to read (a program without
the recorder, no frame recorded, frames recorded on the CPU) the functions
give None or nothing, and the metric is left out of the line."""

from __future__ import annotations

import statistics


def _spans():
    try:
        from svgf_tpu_torch.render import spans
    except ImportError:
        return None
    return spans


def counted() -> list:
    """The syncs of each recorded frame that counted them (on the card)."""
    spans = _spans()
    if spans is None:
        return []
    return [f.syncs for f in spans.recent() if f.syncs is not None]


def summed(names) -> list:
    """For each recorded frame on the card that counted no syncs and has a
    part whose name satisfies `names`: the summed device ms of those parts
    (spans.parts: device ms since the mark before, summed over a name's
    repeats)."""
    spans = _spans()
    if spans is None:
        return []
    out = []
    for f in spans.timed(spans.recent()):
        if f.on_card:
            got = [p.device_ms for n, p in spans.parts(f).items() if names(n)]
            if got:
                out.append(sum(got))
    return out


def median(values):
    return statistics.median(values) if values else None


def p95(values):
    """The 95th percentile, as the harness's step_p95_ms takes it."""
    if len(values) < 2:
        return values[0] if values else None
    return statistics.quantiles(values, n=100, method="inclusive")[94]
