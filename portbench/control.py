"""The control of the output check: the program with its own lower-precision
path switched on, its carried state stored in bfloat16 where the
configuration states float16, run through the harness's own run and check
(frame 0 and the window's last step against the reference at the
configuration's type). Each number's upper reading is the least the
control gives over its seeds; the check has to fail it.

    python3 -m portbench.control --workload <cell> --seeds 21,22,23 --seconds 2 [--size WxH]

Prints one JSON line a seed: the numbers, and those that failed their limit."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import drive, run

# the state type of the control: the program's path one precision lower
LOWER = {"float16": "bfloat16", "float32": "bfloat16"}


def control_run(cell_name: str, seed: int, seconds: float, device, size=None) -> dict:
    man = run.manifest()
    cell = next(c for c in man["workloads"] if c["name"] == cell_name)
    lower = LOWER[drive.load("configs", cell["config"])["render"]["state_dtype"]]
    over = None if size is None else {"width": size[0], "height": size[1]}
    return run.run_cell(man, cell_name, seed, seconds, False, device=device,
                        t0=time.perf_counter(), overrides=over, state_dtype=lower)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--size", default=None)
    a = p.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    size = None if a.size is None else tuple(int(x) for x in a.size.split("x"))
    for seed in (int(s) for s in a.seeds.split(",")):
        out = control_run(a.workload, seed, a.seconds, device, size)
        print(json.dumps({"workload": a.workload, "seed": seed, "device": device,
                          "correct": out["correct"], "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
