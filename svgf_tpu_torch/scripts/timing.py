"""The measuring tools' shared timing, the counterpart of the JAX scripts'
`_fetch` / `timed` (a fetch barrier, the best of several reps).

`timed(fn, iters, reps, device)` runs fn() `iters` times a rep and
returns, an iteration:

* device_ms: CUDA events around the rep's iterations, best of reps (on the
  CPU, where there are no events, the host's wall clock around them);
* host_ms: the host clock around the enqueue of the rep's iterations,
  before the sync, best of reps. The port's frame is host-bound, so a
  device figure alone hides the lever; where a part is host-bound the
  events' span is the host's pace, not the device's;
* on the card, from torch.profiler: the device kernels an iteration and
  their summed device time, and the hand kernels' (svgf::) share of that
  time (None on the CPU: not measured). `seen` and `launched` are the
  hand kernels the profiler recorded and the wrappers counted in the
  profiled calls; where the profiler lost records (seen < launched)
  svgf_ms is None, not an estimate;
* launches: what the kernel wrappers counted in one rep (kernels/launch.py
  LAUNCHES), the kernels that are not zero.

`profile_calls` is the one torch.profiler helper of the tools and of
chip_smoke.py.

Nothing here catches a failure: a part that raises ends the tool.
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import NamedTuple

import torch

# the most profiler sessions one measurement tries: the profiler now and
# then drops kernel records of a session
PROFILE_SESSIONS = 10
# spin kernels that open a profiler session, for the tracer to drop first:
# each about 50 µs, the marker after the warm-up call about 1 µs
LEAD_SPINS, LEAD_CYCLES, MARK_CYCLES, MARK_US = 8, 100_000, 1_000, 10.0


class Timing(NamedTuple):
    device_ms: float
    host_ms: float
    kernels: float | None = None      # device kernels an iteration (profiler)
    kernel_ms: float | None = None    # their summed device time an iteration
    svgf_ms: float | None = None      # the hand kernels' device time an iteration
    seen: int | None = None           # hand kernels the profiler recorded
    launched: int | None = None       # hand kernels the wrappers launched meanwhile
    launches: dict | None = None      # the wrappers' launches in one rep

    def row(self, label: str, **extra) -> dict:
        """A tool's row: its label (svgf_tpu's script's), these figures and `extra`."""
        return {"label": label, **extra, **self._asdict()}


def kernel_mode(device) -> str:
    """The kernel policy the tools run: the kernels on the card ("on", which
    raises rather than fall back), the plain versions on the CPU."""
    return "on" if torch.device(device).type == "cuda" else "off"


def card(device) -> str:
    """What the figures were taken on: the card's name and nvidia-smi's name
    and power limit, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(0)} | {smi}"


def _launches() -> dict:
    from svgf_tpu_torch.kernels.launch import LAUNCHES

    return dict(LAUNCHES)


class Profile(NamedTuple):
    prof: object      # the torch.profiler session that stands
    events: list      # its device events of the measured calls
    seen: int         # the svgf:: kernels among them
    launched: int     # the hand kernels launched in the measured calls
    wall_ms: float    # the host's clock around the measured calls


def measured_events(events: list) -> list:
    """The device events of a profile_calls session that are the measured
    calls': those that start after the marker (the short spin) ends, or,
    where the marker went unrecorded, all but the spins."""
    marks = [e.time_range.end for e in events
             if "spin_kernel" in e.name and e.time_range.elapsed_us() < MARK_US]
    if marks:
        return [e for e in events if e.time_range.start >= marks[-1]]
    return [e for e in events if "spin_kernel" not in e.name]


def profile_calls(fn, iters: int, cpu: bool = False, per_call: int | None = None) -> Profile:
    """fn() `iters` times under torch.profiler on the card (and the host's
    operators too if `cpu`). `launched` is what the wrappers counted, or
    `per_call` a call of fn for a launcher that no wrapper counts. The
    tracer loses the first records of a session, a varying number of them,
    so each session opens with LEAD_SPINS long spin kernels
    (torch.cuda._sleep's spin_kernel), calls fn() once, and then launches
    a short spin, the marker; the events that start after the marker ends
    are the measured calls'. Where the marker went unrecorded, the lost
    prefix took the warm-up call before it too, and every recorded event
    but the spins is the measured calls'. A session that saw a
    number of svgf:: kernels other than was launched, or no device event,
    is run again, up to PROFILE_SESSIONS times; the session nearest the
    launched count stands."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    best = None
    for _ in range(PROFILE_SESSIONS):
        with profile(activities=activities) as prof:
            for _ in range(LEAD_SPINS):
                torch.cuda._sleep(LEAD_CYCLES)
            fn()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            before = sum(_launches().values())
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launched = sum(_launches().values()) - before if per_call is None else per_call * iters
        events = measured_events([e for e in prof.events() if e.device_type == DeviceType.CUDA])
        seen = sum("svgf::" in e.name for e in events)
        got = Profile(prof, events, seen, launched, wall_ms)
        rank = lambda p: (-abs(p.seen - p.launched), len(p.events))
        if best is None or rank(got) > rank(best):
            best = got
        if seen == launched and events:
            break
    if best.seen != best.launched:
        print(f"  (the profiler saw {best.seen} of {best.launched} kernel launches)", flush=True)
    return best


def timed(fn, iters: int, reps: int = 3, device="cuda", warmup: int = 1) -> Timing:
    """fn()'s figures an iteration, as the module docstring says. `warmup`
    calls of fn() come first, untimed."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(warmup):
        fn()
    sync()
    best_dev = best_host = float("inf")
    launches = None
    for _ in range(reps):
        before = _launches()
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if cuda:
            end.record()
        host = time.perf_counter() - t0
        sync()
        wall = time.perf_counter() - t0
        dev = start.elapsed_time(end) if cuda else wall * 1e3
        best_dev, best_host = min(best_dev, dev), min(best_host, host * 1e3)
        if launches is None:
            launches = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
    out = Timing(device_ms=best_dev / iters, host_ms=best_host / iters, launches=launches)
    if not cuda:
        return out
    p = profile_calls(fn, iters)
    us = sum(e.time_range.elapsed_us() for e in p.events)
    svgf_us = sum(e.time_range.elapsed_us() for e in p.events if "svgf::" in e.name)
    return out._replace(kernels=len(p.events) / iters, kernel_ms=us / 1e3 / iters,
                        svgf_ms=svgf_us / 1e3 / iters if p.seen == p.launched else None,
                        seen=p.seen, launched=p.launched)


def fmt(row: dict) -> str:
    """One printed line of a row."""
    s = f"{row['label']:38s} device {row['device_ms']:10.4f} ms  host {row['host_ms']:10.4f} ms"
    if row.get("kernels") is not None:
        svgf = "not measured" if row["svgf_ms"] is None else f"{row['svgf_ms']:.4f} ms"
        s += (f"  {row['kernels']:8.1f} device kernels {row['kernel_ms']:9.4f} ms"
              f" (svgf:: {svgf}, seen {row['seen']} of {row['launched']})")
    if row.get("launches"):
        s += f"  launches a rep {row['launches']}"
    if row.get("port"):
        s += f"  [port: {row['port']}]"
    return s


def report(tool: str, device, rows: list, **extra) -> None:
    """Print the card line and one JSON line of the tool's rows."""
    print(f"card: {card(device)}", flush=True)
    print(json.dumps({"tool": tool, "device": str(device), **extra, "rows": rows}), flush=True)
