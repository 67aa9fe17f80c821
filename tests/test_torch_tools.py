"""The port's measuring tools (svgf_tpu_torch/scripts/) on the CPU.

* measure_balance against svgf_tpu's scripts/measure_balance.py, loaded by
  path and run in this process on the same arguments: the same JSON line.
* The probe (render/pathtrace.py set_active_probe): off, the trace is bit
  for bit the same; on, one mask a bounce whose active count never rises,
  chunk by chunk under pathtrace_chunked; set back to None, it stops.
* Each timing tool's main at tiny sizes on the CPU: its rows carry
  svgf_tpu's labels and finite figures >= 0.
* The profiler sessions' marker (timing.measured_events): the measured
  calls' events whatever prefix of the session the tracer dropped.
* profile_filter's copy of bench.py's make_bench_inputs against bench.py's.
* Every script of the repository's scripts/ has its counterpart in the port
  or a row in NOT_PORTED with its reason.
"""

import ast
import importlib.util
import json
import math
import pathlib
import sys
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest
import torch

from svgf_tpu_torch.ops.keys import key
from svgf_tpu_torch.render import pathtrace as pt
from svgf_tpu_torch.render.gbuffer import camera_rays
from svgf_tpu_torch.scenes.cornell import cornell_box
from svgf_tpu_torch.scripts import (
    measure_balance, profile_filter, profile_moments, profile_stages, profile_trace,
    profile_trace_parts, timing,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BALANCE_ARGS = ["4", "16", "24"]   # bands, h, w


def _load_script(name: str):
    """The repository's scripts/<name>.py as a module (its main not run)."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_measure_balance_matches_jax(monkeypatch, capsys):
    """The same JSON line as svgf_tpu's script: the keys, the scene, and
    every bounce's per-band live fractions, mean and both imbalances. At
    this view no lane ties under ROADMAP Q3's shared-edge rule, so every
    fraction is equal; a tie would show as a one-lane difference in a band.
    svgf_tpu's script tries the reference BaseScene first; its loader is
    made to find no file, so both trace the Cornell box wherever the test
    runs."""
    import svgf_tpu.io.binscene

    def no_scene(path):
        raise FileNotFoundError(path)

    monkeypatch.setattr(svgf_tpu.io.binscene, "load_reference_scene", no_scene)
    jax_script = _load_script("measure_balance")
    monkeypatch.setattr(sys, "argv", ["measure_balance.py", *BALANCE_ARGS])
    jax_script.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = measure_balance.main(BALANCE_ARGS, device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert sorted(got) == sorted(want) and got["scene"] == want["scene"] == "cornell"
    assert len(got["per_bounce"]) == measure_balance.BOUNCES
    for g, w in zip(got["per_bounce"], want["per_bounce"]):
        assert sorted(g) == sorted(w)
        assert g == w, (g, w)
    assert got == want
    # the trace really thins out: the lanes that miss the box die at bounce 0
    fracs = [p["live_frac_mean"] for p in got["per_bounce"]]
    assert fracs == sorted(fracs, reverse=True) and fracs[-1] < fracs[0] < 1.0


@pytest.fixture(scope="module")
def cornell_rays():
    h, w = 12, 16
    scene = cornell_box(aspect=w / h)
    arrays = scene.flatten(device="cpu")
    ro, rd = camera_rays(arrays.cam_frame[0], arrays.cam_proj[0], h, w)
    return arrays, ro, rd


def test_probe_off_leaves_trace_unchanged(cornell_rays):
    arrays, ro, rd = cornell_rays
    R, bounces = ro.shape[0], 5
    lanes = torch.arange(R)
    trace = lambda: pt.pathtrace(arrays, ro, rd, key(3), lanes, bounces=bounces)
    assert pt._ACTIVE_PROBE is None
    rad_off, n_off = trace()
    acc = []
    pt.set_active_probe(acc)
    try:
        rad_on, n_on = trace()
    finally:
        pt.set_active_probe(None)
    assert torch.equal(rad_on, rad_off) and int(n_on) == int(n_off)
    assert len(acc) == bounces
    assert all(m.shape == (R,) and m.dtype == torch.bool for m in acc)
    counts = [int(m.sum()) for m in acc]
    assert counts == sorted(counts, reverse=True) and 0 < counts[-1] < counts[0] < R, counts
    # a lane once dead stays dead
    for a, b in zip(acc, acc[1:]):
        assert not bool((b & ~a).any())
    trace()
    assert len(acc) == bounces


def test_probe_chunked_order(cornell_rays):
    """pathtrace_chunked appends chunk 0's masks of every bounce, then chunk
    1's: stitched back, they are the unchunked trace's masks."""
    arrays, ro, rd = cornell_rays
    R, bounces, chunks = ro.shape[0], 3, 2
    masks = {}
    for n in (1, chunks):
        acc = []
        pt.set_active_probe(acc)
        try:
            pt.pathtrace_chunked(arrays, ro, rd, key(5), bounces=bounces, num_chunks=n)
        finally:
            pt.set_active_probe(None)
        masks[n] = acc
    assert len(masks[chunks]) == chunks * bounces
    for b in range(bounces):
        stitched = torch.cat([masks[chunks][c * bounces + b] for c in range(chunks)])
        assert torch.equal(stitched, masks[1][b]), b


# svgf_tpu's labels of each tool's rows (the port's "pack_prev_planes"
# counterparts are left out: the port packs nothing)
TOOL_LABELS = {
    "profile_trace": ["trace_chunks=2", "trace_chunks=1", "gbuffer alone (chunks=1)"],
    "profile_trace_parts": [
        "intersect_scene (pallas)", "intersect_scene (xla dense)",
        "intersect_scene (all-inactive)", "_shading_point", "sample_lights",
        "sample_lights_pdf_from_hit", "bsdf sample+eval+pdf", "12x rng uniform draws",
        "one full MIS bounce"],
    "profile_stages": [
        "temporal (XLA, packed gather)", "gather alone (12ch f32)", "moments 7x7 (XLA)",
        "atrous step=1 (XLA)", "taa (XLA)", "temporal (Pallas)", "taa (Pallas)",
        "moments 7x7 (Pallas)", "atrous step=1 (Pallas)", "atrous step=16 (Pallas)",
        "atrous chain x5 (Pallas)"],
    "profile_filter": [
        "temporal kernel (pre-packed)", "moments kernel", "atrous chain steps=1",
        "atrous chain steps=2", "atrous chain steps=5", "taa kernel", "filter_chain"],
    "profile_moments": [
        "all history=24 (pass-through)", "all history=1 (all fallback)", "bench-like bands"],
}

# the labels above that svgf_tpu's scripts make with f-strings
JAX_FSTRINGS = {"trace_chunks=2", "trace_chunks=1", "gbuffer alone (chunks=1)",
                "atrous step=1 (Pallas)", "atrous step=16 (Pallas)", "atrous chain steps=1",
                "atrous chain steps=2", "atrous chain steps=5"}

TOOL_RUNS = {
    "profile_trace": lambda: profile_trace.main(["2", "1"], device="cpu", height=16,
                                                width=24).rows,
    "profile_trace_parts": lambda: profile_trace_parts.main(["256", "2"], device="cpu"),
    "profile_stages": lambda: profile_stages.main(["16", "24"], device="cpu"),
    "profile_filter": lambda: profile_filter.main(device="cpu", height=16, width=24),
    "profile_moments": lambda: profile_moments.main(device="cpu", height=16, width=24),
}


def _jax_literals(tool: str) -> set:
    """The string constants of svgf_tpu's script, stripped."""
    tree = ast.parse((ROOT / "scripts" / f"{tool}.py").read_text())
    return {n.value.strip() for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


@pytest.mark.parametrize("tool", sorted(TOOL_RUNS))
def test_tool_runs_on_cpu(tool, capsys):
    rows = TOOL_RUNS[tool]()
    assert [r["label"] for r in rows] == TOOL_LABELS[tool]
    # each label is a string constant of svgf_tpu's script, or one of its f-strings
    literals = _jax_literals(tool)
    assert [lab for lab in TOOL_LABELS[tool] if lab not in literals | JAX_FSTRINGS] == []
    for r in rows:
        for k in ("device_ms", "host_ms"):
            assert math.isfinite(r[k]) and r[k] >= 0, (r["label"], k, r[k])
        # no device on the CPU: the profiler's figures are not measured
        assert r["kernels"] is r["kernel_ms"] is r["svgf_ms"] is None, r
        assert r["seen"] is r["launched"] is None, r
        assert r["launches"] == {}, r
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["tool"] == tool and printed["device"] == "cpu"
    assert [r["label"] for r in printed["rows"]] == TOOL_LABELS[tool]


class _Event(NamedTuple):
    name: str
    time_range: object


def _event(name: str, start: float, end: float) -> _Event:
    return _Event(name, SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start))


@pytest.mark.parametrize("lost", [0, 3, 9, 10])
def test_measured_events_follow_the_marker(lost):
    """profile_calls' session: 8 long spins, a warm-up kernel, the short
    marker spin, then two measured kernels. Whatever prefix of it the
    tracer drops, the events kept are the measured two."""
    session = [_event("at::cuda::spin_kernel", 50.0 * i, 50.0 * i + 50) for i in range(8)]
    session += [_event("svgf::k warm-up", 400, 410), _event("at::cuda::spin_kernel", 410, 411),
                _event("svgf::k", 420, 430), _event("elementwise", 430, 431)]
    got = timing.measured_events(session[lost:])
    assert got == session[10:]


def test_profile_trace_radiance_ignores_chunks():
    sweep = profile_trace.main(["3", "1"], device="cpu", height=8, width=12)
    assert sorted(sweep.radiance) == [1, 3]
    assert sweep.radiance[1].shape == (8, 12, 3)
    assert torch.equal(sweep.radiance[3], sweep.radiance[1])


def test_bench_inputs_match_jax():
    """profile_filter.make_bench_inputs is bench.py's frame: the same
    radiance and G-buffer, and its state at fp16 (bench.py's fp32 state
    rounded, as its planar copy is)."""
    spec = importlib.util.spec_from_file_location("_jax_bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    h, w = 16, 64   # the disoccluded band is columns [0.55w, 0.58w)
    j_rad, j_gbuf, j_state = bench.make_bench_inputs(h, w)
    rad, gbuf, state = profile_filter.make_bench_inputs(h, w, "cpu")
    np.testing.assert_array_equal(rad.numpy(), np.asarray(j_rad))
    for f in ("depth", "depth_deriv", "normal", "instance", "motion"):
        np.testing.assert_array_equal(getattr(gbuf, f).numpy(), np.asarray(getattr(j_gbuf, f)),
                                      err_msg=f)
    for f in ("color", "moments", "history_len", "taa_history"):
        want = np.asarray(getattr(j_state, f))
        want = want.astype(np.float16) if want.dtype == np.float32 else want
        np.testing.assert_array_equal(getattr(state, f).numpy(), want, err_msg=f)
    assert state.color.dtype == state.gbuffer.depth.dtype == torch.float16
    np.testing.assert_array_equal(state.gbuffer.depth.numpy(),
                                  np.asarray(j_gbuf.depth).astype(np.float16))
    assert int((state.history_len < 4).sum()) > 0


# the repository's scripts with no counterpart in svgf_tpu_torch/scripts/, and why
NOT_PORTED = {
    "bench_large.py": "the port's benchmark, ROADMAP Q1 item 1 (a benchmark PR)",
    "bench_sharding.py": "the port's benchmark across cards, ROADMAP Q1 items 1-2",
    "gallery_match.py": "needs the reference project's scenes, which the repository lacks",
    "make_goldens.py": "writes svgf_tpu's goldens from the reference scenes, not in the repository",
    "profile_planar.py": "times the planar padded layout, not ported by decision",
    "probe_moments_floor.py": "times the planar padded layout's moments floor, not ported; "
                              "profile_moments reports the zero-fallback floor as case (a)",
    "grad_bisect.py": "CPU gradient debugging; the next slice (ROADMAP Q1)",
    "grad_bisect2.py": "CPU gradient debugging; the next slice (ROADMAP Q1)",
    "grad_fd_explore.py": "CPU gradient debugging; the next slice (ROADMAP Q1)",
}


@pytest.mark.parametrize("script", sorted(p.name for p in (ROOT / "scripts").glob("*.py")))
def test_scripts_have_counterparts(script):
    port = ROOT / "svgf_tpu_torch" / "scripts" / script
    if script in NOT_PORTED:
        assert not port.exists(), f"{script} has a counterpart now: drop its NOT_PORTED row"
        assert len(NOT_PORTED[script]) > 20
        return
    assert port.exists(), f"{script}: no svgf_tpu_torch/scripts/{script}"
    assert "def main(" in port.read_text()


def test_not_ported_table_is_pinned():
    assert sorted(NOT_PORTED) == [
        "bench_large.py", "bench_sharding.py", "gallery_match.py", "grad_bisect.py",
        "grad_bisect2.py", "grad_fd_explore.py", "make_goldens.py", "probe_moments_floor.py",
        "profile_planar.py"]
    assert all((ROOT / "scripts" / s).exists() for s in NOT_PORTED)
