"""What every traffic kind shares: the data files found by name, the
render settings of a run, and moving outputs to the host. The kinds
themselves, one module a kind, are in portbench/kinds/."""

from __future__ import annotations

import json
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    """The data file `<kind>/<name>.json` (kind: configs or traffic)."""
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def render_seed(seed: int) -> int:
    """The renderer's RNG seed of a run: its key takes a 32-bit seed."""
    return seed % (1 << 31)


def settings(cfg: dict, seed: int, overrides=None) -> dict:
    """The render settings of a run: the configuration's, changed by
    `overrides` (the tests' small frames), with the run's renderer seed."""
    return {**cfg["render"], **(overrides or {}), "seed": render_seed(seed)}


def to_host(x):
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: to_host(v) for k, v in x._asdict().items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return x


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
