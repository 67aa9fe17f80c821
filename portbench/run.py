"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the session of the traffic's kind (kinds/<kind>.py): the
cell's scene or frame from the seed and the program over it (the kernel
library loads from, or is built into, build/ in the checkout), then runs
the traffic's warm-up steps. With --trace 0 the window
then runs steps for --seconds, each ending in torch.cuda.synchronize()
or, where the traffic has `ahead_steps`, in a wait for the step that
many before it (then, once the time is up, nothing more is sent and the
clock is read after all that was sent has finished), and the line holds
the cell's end-to-end metrics; with --trace 1 a fixed
number of steps runs under torch.profiler and the line holds its
per-layer metrics. Then the program is freed and the kind's check holds
its outputs against the plain reference. The numbers compared, each beside
its limit, are the last lines on standard error and the last key of the
line, which is the last line on standard output.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# kernel caches of the program's dependencies at fixed paths in the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
# one host thread a pool: the run is one viewer, and the host is shared
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import torch  # noqa: E402

torch.set_num_threads(1)

from portbench import check, drive, e2e, kinds, metrics, profiling  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "svgf_tpu"}


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def run_cell(man: dict, name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float = T0, overrides=None, fault=None, state_dtype=None) -> dict:
    """One run of cell `name`; returns the result line's object. On the
    CPU (the tests) device metrics are left out and `overrides` shrink the
    frame; `fault(session)`, a test's, breaks the program under the
    window; `state_dtype` runs the program at another state type than the
    configuration states, which the check still holds it to (the control)."""
    cell = next(c for c in man["workloads"] if c["name"] == name)
    cfg = drive.load("configs", cell["config"])
    traffic = drive.load("traffic", cell["traffic"])
    limits = check.limits(name)
    cuda = torch.device(device).type == "cuda"
    marks = [("start", t0), ("imports", time.perf_counter())]
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        marks.append(("cuda", time.perf_counter()))
    sess = kinds.session(traffic["kind"])(cfg, traffic, seed, device, overrides, state_dtype)
    marks.append(("scene and program", time.perf_counter()))
    if fault is not None:
        fault(sess)
    sess.warm_up()
    drive.sync(device)
    marks.append(("warm-up steps", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    print("set-up: " + ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b) in zip(marks, marks[1:])),
          file=sys.stderr)

    result_metrics, dev_info, breakdown = {}, {}, None
    if trace:
        tr = profiling.traced_window(sess, traffic["traced_steps"], sess.STAGE_SPANS,
                                     traffic.get("ahead_steps", 0)) if cuda else None
        attempted = traffic["traced_steps"]
        if tr is not None:
            for m in man["per_layer"]:
                if applies(m, name):
                    v = metrics.reader(m["name"])(tr)
                    if v is not None:
                        result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            dev_info = {"busy_s": tr.busy_s, "window_s": tr.window_s}
            breakdown = tr.breakdown
    else:
        step_s, gc_s = [], []
        clock = {}

        def gc_timer(phase, info):
            if phase == "start":
                clock["gc"] = time.perf_counter()
            elif "gc" in clock:
                gc_s.append((info["generation"], time.perf_counter() - clock.pop("gc")))

        gc.callbacks.append(gc_timer)
        ahead = traffic.get("ahead_steps", 0) if cuda else 0
        pending = collections.deque()
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            a = time.perf_counter()
            sess.step()
            if ahead:
                pending.append(torch.cuda.Event())
                pending[-1].record()
                if len(pending) > ahead:
                    pending.popleft().synchronize()
            else:
                drive.sync(device)
            step_s.append(time.perf_counter() - a)
        sent = time.perf_counter()
        drive.sync(device)
        wall = time.perf_counter() - start
        gc.callbacks.remove(gc_timer)
        attempted = len(step_s)
        q = statistics.quantiles(step_s, n=4) if len(step_s) > 1 else step_s * 3
        slow = sorted(range(attempted), key=lambda i: -step_s[i])[:8]
        print(f"window: {attempted} steps in {wall:.3f} s; step ms min {1e3 * min(step_s):.3f}, "
              f"quartiles {', '.join(f'{1e3 * x:.3f}' for x in q)}, max {1e3 * max(step_s):.3f}; "
              f"slowest (step: ms) {', '.join(f'{i}: {1e3 * step_s[i]:.2f}' for i in slow)}; "
              f"gc {len(gc_s)} collections, {sum(g == 2 for g, _ in gc_s)} of generation 2, "
              f"{1e3 * sum(d for _, d in gc_s):.2f} ms in all, longest "
              f"{1e3 * max([d for _, d in gc_s], default=0.0):.2f} ms; the wait for all sent at the "
              f"close {1e3 * (start + wall - sent):.2f} ms", file=sys.stderr)
        window = {"step_s": step_s, "wall_s": wall, "setup_s": setup_s,
                  "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
        for m in man["end_to_end"]:
            if applies(m, name) and (cuda or m["source"] == "host_clock"):
                result_metrics[m["name"]] = {"value": e2e.value(m["name"], window), "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded in the run: {found}")

    last = sess.end_of_window()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = sess.check(last, device)
    print(f"reference and check: {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    correct, failed = check.judge(numbers, limits)
    print("not judged: " + json.dumps({k: v for k, v in numbers.items() if k not in limits}),
          file=sys.stderr)
    out = {"correct": correct, "attempted": attempted, "failed": len(failed),
           "metrics": result_metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": peak, **dev_info}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    man = manifest()
    cell = next((c for c in man["workloads"] if c["name"] == a.workload), None)
    if cell is None:
        print(f"no cell {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(man, a.workload, a.seed, a.seconds, bool(a.trace))
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(f"card: {smi}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
