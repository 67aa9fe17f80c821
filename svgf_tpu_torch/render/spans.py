"""Spans inside a frame: named marks on the device's clock and the host's.

A mark ends a part of the frame. Where the caller of `Renderer.step`,
`render_frame` or `filter_chain` passes `events` (a dict), each mark records
a CUDA event on the current stream, stored under its name in `events`, and
appends (name, event, host `time.perf_counter()`) to the frame's record. A
frame's record goes into a ring of the last RING frames. One recorded frame
in SYNC_EVERY (the first, and every SYNC_EVERY-th after it) also counts the
host-device synchronizations the program's own code causes inside it
(`Frame.syncs`, through torch's sync debug mode on the card) and where each
came from (`Frame.sync_sites`, file:line). Counting costs the host a few
µs at each sync, where the device has run dry, and at the frame's start
and end, so a counted frame's times carry it: read times from the frames
with `syncs` None (`timed`), and the count from the others (the syncs of a
path repeat frame after frame). On the CPU a mark takes only the host
stamp and no frame counts. With `events` None a mark is one `is None`
test.

Operator's guide:

    from svgf_tpu_torch.render import spans
    spans.clear()
    for _ in range(10):
        renderer.step(events={})          # or pipeline.filter_chain(..., events={})
    for name, p in spans.table(spans.recent()).items():
        print(f"{name:24s} {p.device_ms:9.3f} {p.host_ms:9.3f} {p.lag_ms:9.3f}")
    print([(f.syncs, f.sync_sites) for f in spans.recent() if f.syncs is not None])

`table` gives, for each mark, the device ms and host ms since the mark
before it (summed where a frame repeats the name: chunks and samples do)
and the lag at the mark, the median of each over the uncounted frames. The
lag is the device's offset from the frame's first mark less the host's:
near zero, the device had run dry and the part waited for its host work;
large, the host ran ahead and the part is the device's.

The marks of a frame, in order (the eight stage marks of earlier releases
are `start`, `gbuffer`, `trace`, `temporal`, `moments`, `atrous`, `taa`,
`state`; their names and places are unchanged):

    start
    gbuffer.rays        view inverses, camera rays, block order, padding
    gbuffer.intersect   a chunk's primary intersect       } each chunk
    gbuffer.fill        a chunk's G-buffer fields         }
    gbuffer             the chunks' concat, the depth derivative
    trace.setup         a sample's key, jitter, camera rays, first hit
    trace.primary       the primary intersect, where there is no G-buffer hit
    trace.b{b}.surface  misses, media, the shading point, the emission
    trace.b{b}.sample   light, BSDF and delta directions, their evaluations
                        and offsets, media and opacity
    trace.b{b}.intersect  the one batched intersect (MIS: with its concat;
                        the other estimators: the next bounce's, after cull)
    trace.b{b}.mis      light pdfs, MIS weights, radiance, new state (MIS)
    trace.b{b}.cull     Russian roulette, dead lanes, the active probe
    trace               the final clamp and reshape
    filter.begin        filter_chain's entry
    temporal, moments, atrous, taa, state

Chunks repeat the gbuffer.intersect/fill marks and the bounce marks;
samples repeat trace.setup. Under `checkpoint` the trace chunks take no
marks (their recompute would mark twice).
"""

from __future__ import annotations

import collections
import contextlib
import os
import statistics
import sys
import time
import warnings
from typing import NamedTuple

import torch

RING = 256
SYNC_EVERY = 64   # one recorded frame in this many counts its syncs
# the stage marks, in order: each ends a stage of the frame
STAGES = ("start", "gbuffer", "trace", "temporal", "moments", "atrous", "taa", "state")
SYNC_WARNING = "called a synchronizing CUDA operation"


class Frame:
    """One recorded frame: its marks [(name, CUDA event or None, host
    seconds)], whether they are on a card, and, where it counted them,
    where it synchronized (else None)."""

    __slots__ = ("marks", "on_card", "sync_sites")

    def __init__(self, on_card: bool, counting: bool):
        self.marks = []
        self.on_card = on_card
        self.sync_sites = [] if counting else None

    @property
    def syncs(self) -> int | None:
        """The frame's host-device syncs; None where they were not counted."""
        return None if self.sync_sites is None else len(self.sync_sites)


class Part(NamedTuple):
    device_ms: float | None   # None on the CPU
    host_ms: float
    lag_ms: float | None


_ring: collections.deque = collections.deque(maxlen=RING)
_open: Frame | None = None
_recorded = 0   # frames recorded on a card, for SYNC_EVERY


def mark(events: dict | None, name: str) -> None:
    """End the part `name` of the frame being recorded. Outside a recorded
    frame (the sharded and tiled steps) it records the CUDA event alone."""
    if events is None:
        return
    rec = _open
    ev = None
    if rec is None or rec.on_card:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[name] = ev
    if rec is not None:
        rec.marks.append((name, ev, time.perf_counter()))


def frame(events: dict | None, device):
    """Record the frame run inside the `with` block where `events` is given
    (else a context that does nothing); a frame opened inside another
    (filter_chain inside render_frame) is part of the outer one."""
    if events is None or _open is not None:
        return contextlib.nullcontext()
    return _recording(torch.device(device).type == "cuda")


@contextlib.contextmanager
def _recording(on_card: bool):
    global _open, _recorded
    counting = on_card and _recorded % SYNC_EVERY == 0
    _recorded += on_card
    rec = Frame(on_card, counting)
    _open = rec
    try:
        if counting:
            with _counting_syncs(rec):
                yield
        else:
            yield
    finally:
        _open = None
        _ring.append(rec)


@contextlib.contextmanager
def _counting_syncs(rec: Frame):
    """Count the synchronizing CUDA operations run inside the block (torch's
    sync debug mode, "warn"), keeping each one's site instead of showing it."""
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        show = warnings.showwarning

        def keep(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                rec.sync_sites.append(_site())
            else:
                show(message, category, filename, lineno, file, line)

        warnings.showwarning = keep
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)


_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NOT_SITES = (os.path.dirname(torch.__file__) + os.sep, warnings.__file__,
              os.path.abspath(__file__), contextlib.__file__)


def _site() -> str:
    """file:line of the innermost caller outside torch and the warnings
    machinery: the line of the program that synchronized."""
    f = sys._getframe(1)
    while f.f_back is not None and f.f_code.co_filename.startswith(_NOT_SITES):
        f = f.f_back
    path = f.f_code.co_filename
    if path.startswith(_PACKAGE_PARENT + os.sep):
        path = path[len(_PACKAGE_PARENT) + 1:]
    return f"{path}:{f.f_lineno}"


def recent() -> list:
    """The recorded frames, oldest first (at most RING)."""
    return list(_ring)


def clear() -> None:
    """Empty the ring; the next frame recorded on a card counts its syncs."""
    global _recorded
    _ring.clear()
    _recorded = 0


def timed(frames) -> list:
    """The frames whose times carry no sync count."""
    return [f for f in frames if f.syncs is None]


def parts(rec: Frame) -> dict:
    """name -> Part for one frame: device and host ms since the mark before
    each mark, summed over the name's occurrences, and the lag at its last."""
    marks = rec.marks
    if not marks:
        return {}
    if rec.on_card:
        marks[-1][1].synchronize()
    _, e0, t0 = marks[0]
    out = {}
    for (_, ea, ta), (name, eb, tb) in zip(marks, marks[1:]):
        host = 1e3 * (tb - ta)
        dev = lag = None
        if rec.on_card:
            dev = ea.elapsed_time(eb)
            lag = e0.elapsed_time(eb) - 1e3 * (tb - t0)
        if name in out:
            p = out[name]
            dev = None if dev is None else dev + p.device_ms
            host += p.host_ms
        out[name] = Part(dev, host, lag)
    return out


def table(frames) -> dict:
    """name -> Part, each number the median over the uncounted frames that
    have the mark (None where the frames ran on the CPU)."""
    per = [parts(f) for f in timed(frames)]
    names = dict.fromkeys(n for p in per for n in p)

    def med(vals):
        return None if any(v is None for v in vals) else statistics.median(vals)

    return {n: Part(*(med([p[n][i] for p in per if n in p]) for i in range(3))) for n in names}
