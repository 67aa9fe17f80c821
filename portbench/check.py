"""The output check's verdict. Each traffic kind computes its numbers with
the plain reference (portbench/kinds/<kind>.py `Session.check`); a cell
judges those that its limits/<cell>.json lists, each passing at or under
its limit there: the numbers that separate the program's readings from
the control's, and the exact comparisons (limit 0)."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def limits(cell: str) -> dict:
    return {k: v["limit"] for k, v in json.loads((ROOT / "limits" / f"{cell}.json").read_text()).items()}


def judge(numbers: dict, lim: dict) -> tuple:
    """(correct, failed numbers): each number the cell's limits list at or
    under its limit; a number that is not finite fails."""
    failed = [k for k in lim if not (numbers[k] == numbers[k] and numbers[k] <= lim[k])]
    return not failed, failed
