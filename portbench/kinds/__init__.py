"""Traffic kinds, one module a kind, found by the `kind` that a traffic file
(traffic/<name>.json) names. A kind's module holds `Session`, built as

    Session(cfg, traffic, seed, device, overrides=None, state_dtype=None)

the configuration's program set up for the traffic from the seed, with

    STAGE_SPANS           {span name: (program event at its start, at its end)}
    warm_up()             the traffic's warm-up steps
    step(events, spans)   one step through the entry point the kind drives
    counters(), shapes()  the newest step's program counters, and what the
                          kernels' bounds are computed from
    end_of_window()       what the check needs on the host; frees the program
    check(last, device)   the numbers compared with the plain reference

`overrides` change the configuration's render settings on both sides (the
tests' small frames); `state_dtype` changes the program's carried-state
type alone, so that the check still holds it to the configuration (the
control). A new kind is a new module here and a traffic file naming it."""

from __future__ import annotations

import importlib


def session(kind: str):
    return importlib.import_module(f"portbench.kinds.{kind}").Session
