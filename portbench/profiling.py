"""The traced window: torch.profiler over a fixed number of steps, and its
reduction to device busy time, kernel times by name, idle gaps by what the
host was doing, and the program's stage spans. Recording the host's
operators slows a host-bound frame by a third or more, so the window is
traced on the device alone and the host is recorded in two steps after it.

The tracer drops a varying prefix of a session's records late in a long
process, so a session opens with spin kernels, one untimed step and a short
spin, the marker; the device records after the marker's end are the traced
steps' (where the marker went unrecorded, all records but the spins)."""

from __future__ import annotations

import bisect
import time

import torch

LEAD_SPINS, LEAD_CYCLES, MARK_CYCLES, MARK_US = 8, 100_000, 1_000, 10.0
TOP = 10
ANNOTATION = "portbench."
HOST_STEPS = 2   # steps of the session that records the host


class Trace(dict):
    """What the metric readers read (a dict with attribute access): steps,
    window_s, busy_s, kernels [(name, start_us, dur_us)], spans {name:
    [ms a step]}, counters {name: [a step]}, shapes (the bounds' inputs)."""

    __getattr__ = dict.__getitem__


def _interval_union(iv):
    total, cur_s, cur_e = 0.0, None, None
    merged = []
    for s, e in sorted(iv):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                merged.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        merged.append((cur_s, cur_e))
    for s, e in merged:
        total += e - s
    return total, merged


def _session(sess, steps: int, cpu: bool, spans=None, counters=None, ahead=0):
    """One profiler session over `steps` steps (device records only, or
    the host's operators too), each ending in a synchronize, or with
    `ahead` all sent before one at the end; returns (device events after
    the marker, host events, the steps' stage events, wall seconds of the
    steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    evs = []
    with profile(activities=acts) as prof:
        for _ in range(LEAD_SPINS):
            torch.cuda._sleep(LEAD_CYCLES)
        sess.step()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            ev = {}
            sess.step(events=ev, spans=spans)
            evs.append(ev)
            if not ahead:
                torch.cuda.synchronize()
            if counters is not None:
                for name, c in sess.counters().items():
                    counters.setdefault(name, []).append(c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    # the benchmark's own record_function ranges appear on the device
    # timeline too, as annotations: they are no device work
    dev = [e for e in events if e.device_type == DeviceType.CUDA and not e.name.startswith(ANNOTATION)]
    spin = lambda e: "sleep" in e.name.lower() or "spin" in e.name.lower()
    marks = [e.time_range.end for e in dev if spin(e) and e.time_range.elapsed_us() < MARK_US]
    dev = [e for e in dev if e.time_range.start >= marks[-1]] if marks else \
        [e for e in dev if not spin(e)]
    return dev, [e for e in events if e.device_type == DeviceType.CPU], evs, wall


def traced_window(sess, steps: int, stage_spans, ahead=0) -> Trace:
    """`steps` steps under a profiler session that records the device
    alone, whose timeline gives every metric; then HOST_STEPS more under
    one that records the host's operators too, which cost the host time
    and so are read only for what the host did in the device's idle gaps.
    `stage_spans` maps a span name to the pair of the program's stage
    events it spans; `ahead` (the traffic's `ahead_steps`) sends the
    steps without a synchronize between them, as the timed window does."""
    spans, counters = {}, {}
    dev, _, evs, window_s = _session(sess, steps, False, spans, counters, ahead)
    for ev in evs:
        for name, (a, b) in stage_spans.items():
            if a in ev and b in ev:
                spans.setdefault(name, []).append(ev[a].elapsed_time(ev[b]))
    shapes = sess.shapes()
    kernels = [(e.name, e.time_range.start, e.time_range.elapsed_us()) for e in dev]
    busy_us, _ = _interval_union([(s, s + d) for _, s, d in kernels])
    host_dev, cpu, _, _ = _session(sess, min(HOST_STEPS, steps), True, ahead=ahead)
    _, merged = _interval_union([(e.time_range.start, e.time_range.end) for e in host_dev])
    return Trace(steps=steps, window_s=window_s, busy_s=busy_us / 1e6, kernels=kernels,
                 spans=spans, counters=counters, shapes=shapes,
                 breakdown=_breakdown(kernels, merged, cpu))


def _breakdown(kernels, merged, cpu) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by the innermost host operation running at their middle."""
    by_name = {}
    for name, _, d in kernels:
        by_name[name] = by_name.get(name, 0.0) + d / 1e6
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:TOP]
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:]) if s1 > e0]
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu))
    starts = [s for s, _, _ in spans]
    idle = {}
    for a, b in gaps[:2000]:
        mid = 0.5 * (a + b)
        name = "(no host operation)"
        # the latest-starting host span that covers the middle is the innermost
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if spans[j][1] >= mid:
                name = spans[j][2]
                break
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n[:120], s] for n, s in sorted(idle.items(), key=lambda x: -x[1])[:TOP]]}
