"""A run with the timed path broken underneath comes out not correct: the
harness's run without its look for a card (on the CPU, a small frame), with
each fault a cell can have planted in the program: a step that returns its
state unchanged, half of the frame left out (its pixels given the mean of
the rest), an answer altered where it is produced. A sound run comes out
correct."""

import time

import pytest
import torch

from portbench import port, run
from portbench.kinds import render

MAN = run.manifest()
SIZE = {"width": 48, "height": 32}
RENDER_CELLS = ["cornell-orbit"]


def _run(cell, fault=None):
    return run.run_cell(MAN, cell, 2**35 + 17, 0.3, False, device="cpu", t0=time.perf_counter(),
                        overrides=SIZE, fault=fault)


def _state_unchanged(sess):
    if isinstance(sess, render.Session):
        real = sess.r.step

        def step(events=None):
            before = sess.r.state
            out = real(events)
            sess.r.state = before
            return out

        sess.r.step = step
    else:
        tres_of = sess.inputs[2]
        real = sess.step

        def step(events=None, spans=None):
            out = real(events, spans)
            tres = out[0]._replace(color=tres_of.color.float(), moments=tres_of.moments.float(),
                                   history_len=tres_of.history_len)
            sess.out = (tres, *out[1:4], tres_of.color.float())
            return sess.out

        sess.step = step


def _half_left_out(monkeypatch):
    import svgf_tpu_torch.render.pipeline as P

    real = P.pathtrace_chunked

    def half(*a, **kw):
        rad, nr = real(*a, **kw)
        n = rad.shape[0] // 2
        rad = rad.clone()
        rad[n:] = rad[:n].mean(0)
        return rad, nr

    monkeypatch.setattr(P, "pathtrace_chunked", half)
    real_chain = port.filter_chain

    def half_chain(radiance, *a, **kw):
        r = radiance.clone().reshape(-1, 3)
        n = r.shape[0] // 2
        r[n:] = r[:n].mean(0)
        return real_chain(r.reshape(radiance.shape), *a, **kw)

    monkeypatch.setattr(port, "filter_chain", half_chain)


def _answer_altered(monkeypatch):
    import svgf_tpu_torch.render.pipeline as P

    real = P.filter_chain

    def altered(*a, **kw):
        tres, m, at, final, fb = real(*a, **kw)
        final = final.clone()
        final[: max(1, final.shape[0] // 8), : max(1, final.shape[1] // 8), :3] += 0.2
        return tres, m, at, final, fb

    monkeypatch.setattr(P, "filter_chain", altered)


@pytest.mark.parametrize("cell", RENDER_CELLS + ["cornell-denoise"])
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", RENDER_CELLS + ["cornell-denoise"])
def test_state_unchanged_is_caught(cell):
    out = _run(cell, fault=_state_unchanged)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", RENDER_CELLS + ["cornell-denoise"])
def test_half_left_out_is_caught(cell, monkeypatch):
    _half_left_out(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", RENDER_CELLS + ["cornell-denoise"])
def test_answer_altered_is_caught(cell, monkeypatch):
    _answer_altered(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["checks"]


def test_no_card_exits_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "cornell-orbit", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
