"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file; a new cell added from new files alone."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import kinds
from portbench.metrics import module_for

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(not p.startswith("/") and ".." not in p for p in MAN["paths"])
    assert len(MAN["command"]) <= 32


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"]), entry["name"]
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    for k in entry.get("reduced", []):
        assert NAME.match(k)
    for k in ("why", "layer", "source"):
        if k in entry:
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k] and "\t" not in entry[k]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in MAN["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert module_for("e2e", metric["name"]).value
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in MAN["end_to_end"]}
        assert module_for("metrics", metric["name"]).read
        reporting = [c["name"] for c in MAN["workloads"] if any(
            m["name"] == metric["moves"] and ("workloads" not in m or c["name"] in m["workloads"])
            for m in MAN["end_to_end"])]
        assert set(metric.get("workloads", reporting)) <= set(reporting)


def test_unique_names():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    assert cell["chips"] in (1, 4)
    cfg = next(c for c in MAN["configs"] if c["name"] == cell["config"])
    assert cfg["file"] == f"portbench/configs/{cell['config']}.json"
    conf = json.loads((ROOT / cfg["file"]).read_text())
    assert conf["reduced"] == cfg["reduced"]
    traffic = json.loads((PB / "traffic" / f"{cell['traffic']}.json").read_text())
    sess = kinds.session(traffic["kind"])
    for hook in ("STAGE_SPANS", "warm_up", "step", "counters", "shapes", "end_of_window", "check"):
        assert hasattr(sess, hook), hook
    limits = json.loads((PB / "limits" / f"{cell['name']}.json").read_text())
    assert all("limit" in v for v in limits.values())
    e2e = [m for m in MAN["end_to_end"] if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any("workloads" not in m or cell["name"] in m["workloads"] for m in MAN["per_layer"])


def test_every_config_used():
    used = {c["config"] for c in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


# a traffic kind of a test's own: a viewer who holds the camera still and
# renders the same view again and again, through the render kind's program
STILL_KIND = """
from portbench.kinds import render


class Session(render.Session):
    def step(self, events=None, spans=None):
        self.prev_state = self.r.state
        self.out = self.r.step(events=events)
        self.k += 1
        return self.out

    def cameras(self, k):
        f = self.camera.frame(-1)
        return f, f
"""

# a scene generator of a test's own: the Cornell box without its two blocks
OPEN_BOX = """
from portbench.scenes import cornell_box


def make():
    d = cornell_box.make()
    keep = [i for i in d["instances"] if "block" not in i["name"]]
    return {**d, "instances": keep}
"""


def test_new_cell_from_new_files_alone(tmp_path):
    """A copy of the benchmark gains a scene generator, a configuration, a
    traffic kind and a mix of it, a per-layer metric, limits and a cell by
    new files and new manifest entries only, and the harness runs the new
    cell (on the CPU, tiny) through the new kind's hooks."""
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "svgf_tpu_torch").symlink_to(ROOT / "svgf_tpu_torch")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    man = json.loads(json.dumps(MAN))
    new = tmp_path / "portbench"
    (new / "scenes/open_box.py").write_text(OPEN_BOX)
    (new / "kinds/still.py").write_text(STILL_KIND)
    conf = json.loads((PB / "configs" / "cornell-1080p.json").read_text())
    conf["scene"] = {"generator": "open_box"}
    (new / "configs/open-box.json").write_text(json.dumps(conf))
    (new / "traffic/hold.json").write_text(json.dumps(
        {"kind": "still", "camera": {"path": "still"}, "warmup_steps": 2, "traced_steps": 2}))
    (new / "limits/open-hold.json").write_text((PB / "limits" / "cornell-orbit.json").read_text())
    (new / "metrics/steps_seen.py").write_text("def read(trace):\n    return float(trace.steps)\n")
    man["configs"].append({**MAN["configs"][0], "name": "open-box",
                           "file": "portbench/configs/open-box.json"})
    man["workloads"].append({"name": "open-hold", "config": "open-box", "traffic": "hold",
                             "chips": 1, "why": "a test's cell"})
    man["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                             "source": "program_counter", "layer": "device", "moves": "step_ms",
                             "workloads": ["open-hold"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = ("import json, time; from portbench import run; "
            "out = run.run_cell(run.manifest(), 'open-hold', 7, 0.5, False, device='cpu', "
            "t0=time.perf_counter(), overrides={'width': 24, 'height': 16}); "
            "print(json.dumps(out))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["attempted"] >= 2 and "step_ms" in out["metrics"]
    after = {p: p.read_bytes() for p in before}
    assert after == before, "an existing file of the benchmark changed"
