"""The gradient-debugging tools (svgf_tpu_torch/scripts/grad_bisect.py,
grad_bisect2.py, grad_fd_explore.py) on the CPU, against svgf_tpu's scripts
of the same names.

Each svgf_tpu script runs once, in this process, in a module fixture
(runpy.run_path, its printed table captured and parsed; nothing of the
script changes), and each port tool's main(device="cpu") once. Bars:
  * row names and order, and the finite flags, equal;
  * |g|max within GMAX_RTOL (svgf_tpu prints three digits), except:
    - a row below ANALYTIC_ZERO in either package is an analytic zero and
      must be below it in both: "gbuffer motion" (the motion is exactly 0
      at the base camera in both packages' forward pass; svgf_tpu's jit
      prints 2.51e-06 of rounding) and "dir_l" (the mean of squared unit
      vectors is 1);
    - "hit_uv" at TIE_RTOL[hit_uv]: four of the 384 primary rays lie on an
      edge where two triangles meet, and there the packages pick different
      triangles at the same t (test_hit_uv_tie_lanes shows which);
  * grad_fd_explore: the interior count equal, `an` within FD_AN_RTOL,
    each `rel` below FD_REL_BAR; the port's `fd` is not held to
    svgf_tpu's (float32 central differences, ~2% apart at eps 1e-3).
The K5 launches a row (K5_CALLS of each tool, which chip_smoke.py holds
on the card) are counted here through the intersector's kernel route with
the plain sweep standing in for the kernel. test_frame_rows_follow_a_rounding
shows the rows whose gradient a 1-ulp change of the forward pass moves,
which chip_smoke.py holds to the CPU run at the tie bar.
"""

import contextlib
import io
import pathlib
import re
import runpy

import numpy as np
import pytest
import torch

from svgf_tpu_torch.scripts import grad_bisect, grad_bisect2, grad_fd_explore

ROOT = pathlib.Path(__file__).resolve().parents[1]
GMAX_RTOL = 1e-2
ANALYTIC_ZERO = 1e-5
TIE_RTOL = {"hit_uv": 2e-2}
FD_AN_RTOL = 2e-3
FD_REL_BAR = 0.05
TIE_LANES = [42, 111, 180, 354]    # grad_bisect2's 24x16 primary rays on a shared edge
GRAD_TOOLS = {"grad_bisect": grad_bisect, "grad_bisect2": grad_bisect2}

_ROW = re.compile(r"^(?P<name>\S.*?)\s+finite=(?P<finite>True|False)\s+\|g\|max=(?P<gmax>\S+)"
                  r"(\s+n_nonfinite=\d+)?$")
_FD = re.compile(r"^(?P<name>\w+) comp=(?P<comp>\d) eps=(?P<eps>\S+): fd=(?P<fd>\S+) "
                 r"an=(?P<an>\S+) rel=(?P<rel>\S+)$")
_INTERIOR = re.compile(r"^interior pixels: (\d+) / (\d+)$")


def _printed(fn) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn()
    return result, out.getvalue().splitlines()


def _run_jax(tool: str) -> list:
    """svgf_tpu's script's printed lines. Its render_frame sets svgf_tpu's
    intersector policy; the policy before it is put back."""
    from svgf_tpu.ops import intersect as jax_intersect

    mode = jax_intersect._PALLAS_MODE
    try:
        _, lines = _printed(lambda: runpy.run_path(str(ROOT / "scripts" / f"{tool}.py")))
    finally:
        jax_intersect.set_pallas_mode(mode)
    return lines


def _parse(lines, pattern) -> list:
    return [m.groupdict() for m in map(pattern.match, lines) if m]


@pytest.fixture(scope="module")
def tables():
    """tool -> (svgf_tpu's printed lines, the port's rows, the port's
    printed lines), each tool run once."""
    cache = {}

    def get(tool: str):
        if tool not in cache:
            mod = GRAD_TOOLS.get(tool, grad_fd_explore)
            rows, lines = _printed(lambda: mod.main([], device="cpu"))
            cache[tool] = (_run_jax(tool), rows, lines)
        return cache[tool]

    return get


@pytest.mark.parametrize("tool", sorted(GRAD_TOOLS))
def test_rows_and_finite_flags_match_jax(tables, tool):
    jax_lines, rows, _ = tables(tool)
    want = _parse(jax_lines, _ROW)
    assert [r.name for r in rows] == [w["name"] for w in want]
    assert [str(r.finite) for r in rows] == [w["finite"] for w in want]
    assert len(rows) == {"grad_bisect": 6, "grad_bisect2": 19}[tool]


@pytest.mark.parametrize("tool", sorted(GRAD_TOOLS))
def test_printed_table(tables, tool):
    """The port prints svgf_tpu's table: each row's line in svgf_tpu's
    format, with the row's figures to the printed digits."""
    _, rows, lines = tables(tool)
    got = _parse(lines, _ROW)
    assert [g["name"] for g in got] == [r.name for r in rows]
    assert [float(g["gmax"]) for g in got] == [float(f"{r.gmax:.3g}") for r in rows]
    assert lines[len(rows)] == "card: cpu"
    for r in rows:
        assert r.grad.shape == (1, 4, 4) and r.peak_mib is None and r.launches == {}
        assert r.finite == bool(np.isfinite(r.grad).all()) and r.ms > 0


@pytest.mark.parametrize("tool,row", [(t, n) for t, m in sorted(GRAD_TOOLS.items())
                                      for n in m.K5_CALLS])
def test_gradient_magnitude_matches_jax(tables, tool, row):
    jax_lines, rows, _ = tables(tool)
    want = float({w["name"]: w["gmax"] for w in _parse(jax_lines, _ROW)}[row])
    got = {r.name: r.gmax for r in rows}[row]
    if min(got, want) < ANALYTIC_ZERO:
        assert max(got, want) < ANALYTIC_ZERO, (row, got, want)
        return
    assert abs(got - want) <= TIE_RTOL.get(row, GMAX_RTOL) * want, (row, got, want)


def test_fd_table_matches_jax(tables):
    jax_lines, rows, lines = tables("grad_fd_explore")
    assert _parse(lines, _INTERIOR) == _parse(jax_lines, _INTERIOR)
    assert [m.groups() for m in map(_INTERIOR.match, lines) if m] == [("82", "1280")]
    want = _parse(jax_lines, _FD)
    assert len(rows) == len(want) == 8
    for r, w in zip(rows, want):
        assert (r.name, str(r.comp), f"{r.eps:g}") == (w["name"], w["comp"], w["eps"])
        assert abs(r.an - float(w["an"])) <= FD_AN_RTOL * abs(float(w["an"])), (r, w)
        assert r.rel < FD_REL_BAR and float(w["rel"]) < FD_REL_BAR, (r, w)
    assert [m.groupdict() for m in map(_FD.match, lines) if m] == [
        {"name": r.name, "comp": str(r.comp), "eps": f"{r.eps:g}", "fd": f"{r.fd:+.5g}",
         "an": f"{r.an:+.5g}", "rel": f"{r.rel:.3f}"} for r in rows]


def test_hit_uv_tie_lanes():
    """grad_bisect2's 24x16 primary rays: the only lanes whose triangle
    differs from svgf_tpu's intersect_scene are TIE_LANES, and on each the
    two packages' t agree to 1e-6 relative: each ray meets the edge two
    triangles share, at one t, and a rounding picks the side. The rays'
    directions differ by at most 2 ulp."""
    import jax

    from svgf_tpu.ops.intersect import intersect_scene as jax_intersect
    from svgf_tpu.render.gbuffer import camera_rays as jax_rays
    from svgf_tpu.scenes.cornell import cornell_box as jax_cornell
    from svgf_tpu_torch.ops.intersect import intersect_scene
    from svgf_tpu_torch.render.gbuffer import camera_rays

    h, w = grad_bisect2.H, grad_bisect2.W
    scene = jax_cornell()
    scene.cameras[0].aspect = w / h
    ja = scene.flatten()
    jro, jrd = jax_rays(ja.cam_frame[0], ja.cam_proj[0], h, w)
    jh = jax.jit(jax_intersect)(ja, jro, jrd)
    ta = grad_bisect.cornell_arrays(h, w, "cpu")
    ro, rd = camera_rays(ta.cam_frame[0], ta.cam_proj[0], h, w)
    th = intersect_scene(ta, ro, rd, "off")
    np.testing.assert_array_equal(ro.numpy(), np.asarray(jro))
    assert np.abs(rd.numpy() - np.asarray(jrd)).max() <= 2.4e-7
    differ = np.nonzero(th.prim.numpy() != np.asarray(jh.prim))[0]
    assert differ.tolist() == TIE_LANES
    jd, td = np.asarray(jh.dist)[differ], th.dist.numpy()[differ]
    assert (np.abs(td - jd) <= 1e-6 * jd).all(), (td, jd)
    # the lane's point lies on both triangles' shared edge: u + v = 1 or u or v ~ 0
    for u, v in ((th.u.numpy()[differ], th.v.numpy()[differ]),
                 (np.asarray(jh.u)[differ], np.asarray(jh.v)[differ])):
        on_edge = (np.abs(u + v - 1) < 1e-6) | (np.abs(u) < 1e-6) | (np.abs(v) < 1e-6)
        assert on_edge.all(), (u, v)
    same = th.prim.numpy() == np.asarray(jh.prim)
    for f in ("u", "v"):
        assert np.abs(getattr(th, f).numpy() - np.asarray(getattr(jh, f)))[same].max() < 1e-6


def test_frame_rows_follow_a_rounding():
    """grad_bisect's two frame rows are the rows that a 1-ulp change of the
    forward pass moves: the camera's z translation moved by one ulp moves
    their gradients by more than 1e-4 of the largest (the moments filter's
    depth weights; its tap's gradient moves by ~3e-3), the G-buffer and
    trace rows' by less than 1e-5. So the card, whose float32 rounds
    otherwise than the CPU path's, is held to the CPU on these rows at the
    tie bar (chip_smoke.py GRAD_TIE_ROWS)."""
    h, w = grad_bisect.H, grad_bisect.W
    arrays = grad_bisect.cornell_arrays(h, w, "cpu")
    named = grad_bisect.losses(arrays, grad_bisect.grad_config(h, w), h, w, "off")
    moved = arrays.cam_frame.clone()
    moved[0, 2, 3] = torch.nextafter(moved[0, 2, 3], torch.tensor(10.0))
    for name, loss in named.items():
        a = grad_bisect.gradient_row(name, loss, arrays.cam_frame).grad
        b = grad_bisect.gradient_row(name, loss, moved).grad
        if not np.abs(a).max():
            assert np.abs(b).max() < ANALYTIC_ZERO, name
            continue
        change = np.abs(b - a).max() / np.abs(a).max()
        assert change > 1e-4 if name.startswith("full frame") else change < 1e-5, (name, change)


@pytest.fixture
def counted_k5(monkeypatch):
    """The intersector's kernel route on CPU tensors: use_pallas="on"
    resolves to the kernel, whose wrapper counts a call and runs the plain
    sweep. Returns the list of calls' lane counts."""
    from svgf_tpu_torch import kernels
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.ops.intersect import intersect_dense

    calls = []

    def kernel(scene, ro, rd, active=None, any_hit=False, tmax=None, only_instance=None):
        calls.append(ro.shape[0])
        return intersect_dense(scene, ro, rd, active=active, tmax=tmax,
                               only_instance=only_instance)

    monkeypatch.setattr(kernels, "resolve_kernels", lambda mode, device: mode == "on")
    monkeypatch.setattr(KI, "intersect_dense_kernel", kernel)
    return calls


def test_k5_calls_per_row(counted_k5):
    """Each row's intersects through the kernel route: grad_bisect's and
    grad_bisect2's K5_CALLS (33 over grad_bisect2's stages) and
    grad_fd_explore's mask and loss evaluations; the gradients are those of
    the plain route."""
    h, w = 8, 12
    arrays = grad_bisect.cornell_arrays(h, w, "cpu")
    config = grad_bisect.grad_config(h, w)
    named = {"on": grad_bisect.losses(arrays, config, h, w, "on"),
             "off": grad_bisect.losses(arrays, config, h, w, "off")}
    named["on"].update({s: (lambda cf, s=s: grad_bisect2.stage(arrays, cf, s, h, w, "on"))
                        for s in grad_bisect2.STAGES})
    named["off"].update({s: (lambda cf, s=s: grad_bisect2.stage(arrays, cf, s, h, w, "off"))
                         for s in grad_bisect2.STAGES})
    expect = {**grad_bisect.K5_CALLS, **grad_bisect2.K5_CALLS}
    for name, loss in named["on"].items():
        before = len(counted_k5)
        got = grad_bisect.gradient_row(name, loss, arrays.cam_frame)
        assert len(counted_k5) - before == expect[name], name
        plain = grad_bisect.gradient_row(name, named["off"][name], arrays.cam_frame)
        assert len(counted_k5) - before == expect[name], name
        np.testing.assert_array_equal(got.grad, plain.grad, err_msg=name)
    assert sum(grad_bisect2.K5_CALLS.values()) == 33

    del counted_k5[:]
    mask = grad_fd_explore.interior_mask(arrays, h, w, "on")
    assert counted_k5 == [h * w]
    fd = grad_fd_explore.losses(arrays, config, mask, "on")
    with contextlib.redirect_stdout(io.StringIO()):
        grad_fd_explore.explore(fd, arrays.cam_frame)
    assert len(counted_k5) == 1 + grad_fd_explore.EVALUATIONS * sum(
        grad_fd_explore.K5_CALLS.values())


@pytest.mark.parametrize("tool", ["grad_bisect", "grad_bisect2", "grad_fd_explore"])
def test_tool_runs_on_the_card_by_default(tool):
    """main() runs on the card unless told otherwise: without one it raises."""
    mod = {"grad_fd_explore": grad_fd_explore, **GRAD_TOOLS}[tool]
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main([])
