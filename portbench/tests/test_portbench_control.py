"""The control comes out as not correct: the program with its bfloat16
state path on, where the configuration states float16, fails each cell's
check in the harness's own run. On the CPU at a small frame; on the card
(`card`) at the cells' own 1920 x 1080."""

import json
from pathlib import Path

import pytest

from portbench import control

ROOT = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_a_small_size(cell):
    for seed in (11, 2**33 + 5):
        out = control.control_run(cell, seed, 0.3, "cpu", size=(64, 40))
        assert not out["correct"], out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cell_size(card, cell):
    for seed in (21, 22, 23):
        out = control.control_run(cell, seed, 2.0, card)
        print(json.dumps({"control": cell, "seed": seed, "checks": out["checks"]}))
        assert not out["correct"], out["checks"]
