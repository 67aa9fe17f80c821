"""The frame's span recorder (render/spans.py) on the CPU, on a 16x16
Cornell frame: nothing recorded without `events`; with them, every mark
in its place for one and two chunks and for the simple estimator, the
repeated names summed; the image and state unchanged by recording; the
stage events of earlier releases still in `events` and the syncs counted
in one recorded frame of every SYNC_EVERY (on stand-ins for the card's
events and sync mode); the ring's bound."""

import dataclasses
import time
import warnings

import pytest
import torch

from svgf_tpu_torch.config import RenderConfig, SamplingMode, SVGFConfig
from svgf_tpu_torch.render import spans
from svgf_tpu_torch.render.pipeline import Renderer
from svgf_tpu_torch.scenes.cornell import cornell_box

W = H = 16
CONFIG = RenderConfig(width=W, height=H, svgf=SVGFConfig(spatial_filter_steps=2),
                      state_dtype="float16", use_pallas="off")
MIS_PARTS = ("surface", "sample", "intersect", "mis", "cull")


def expected_marks(chunks: int, bounces: int, mis: bool = True, hybrid: bool = True) -> list:
    out = ["start", "gbuffer.rays"] + ["gbuffer.intersect", "gbuffer.fill"] * chunks
    out += ["gbuffer", "trace.setup"]
    for _ in range(chunks):
        out += [] if hybrid else ["trace.primary"]
        for b in range(bounces):
            if mis:
                out += [f"trace.b{b}.{p}" for p in MIS_PARTS]
            else:
                out += [f"trace.b{b}.{p}" for p in ("surface", "sample", "cull")]
                out += [f"trace.b{b}.intersect"] if b + 1 < bounces else []
    return out + ["trace", "filter.begin", "temporal", "moments", "atrous", "taa", "state"]


@pytest.fixture(autouse=True)
def empty_ring():
    spans.clear()
    yield
    spans.clear()


def renderer(config=CONFIG):
    return Renderer(cornell_box(aspect=W / H), config, device="cpu")


class FakeEvent:
    """A stand-in for torch.cuda.Event on the CPU: the host clock at record."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


@pytest.fixture
def fake_card(monkeypatch):
    modes = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    return modes


def test_nothing_recorded_without_events(fake_card):
    renderer().step()
    with spans.frame(None, "cuda"):
        spans.mark(None, "x")
    assert spans.recent() == [] and fake_card == []


@pytest.mark.parametrize("chunks, mode, hybrid", [
    (1, SamplingMode.MIS, True), (2, SamplingMode.MIS, True), (1, SamplingMode.BSDF, False),
], ids=["mis-1chunk", "mis-2chunks", "bsdf-no-gbuffer-hit"])
def test_marks_in_order_and_summed(chunks, mode, hybrid):
    config = dataclasses.replace(
        CONFIG, trace_chunks=chunks, hybrid_primary=hybrid,
        tracing=dataclasses.replace(CONFIG.tracing, sampling_mode=mode))
    events = {}
    renderer(config).step(events=events)
    (rec,) = spans.recent()
    names = [n for n, _, _ in rec.marks]
    assert names == expected_marks(chunks, config.tracing.bounces, mode == SamplingMode.MIS,
                                   hybrid)
    # the CPU: host stamps alone, no events, syncs not counted
    assert events == {} and all(ev is None for _, ev, _ in rec.marks) and rec.syncs is None
    parts = spans.parts(rec)
    assert list(parts) == list(dict.fromkeys(names[1:]))
    stamps = [t for _, _, t in rec.marks]
    for name, p in parts.items():
        want = sum(1e3 * (b - a) for a, b, n in zip(stamps, stamps[1:], names[1:]) if n == name)
        assert p.host_ms == pytest.approx(want) and p.device_ms is None and p.lag_ms is None
    assert spans.table([rec, rec]) == parts


def test_image_and_state_unchanged_by_recording():
    plain, recorded = renderer(), renderer()
    for _ in range(2):
        a, b = plain.step(), recorded.step(events={})
        assert torch.equal(a.final, b.final)
    for f in ("color", "moments", "history_len", "taa_history"):
        assert torch.equal(getattr(plain.state, f), getattr(recorded.state, f)), f
    assert plain.state.frame_idx == recorded.state.frame_idx
    assert len(spans.recent()) == 2


def test_stage_events_kept_and_parts_timed(fake_card):
    events = {}
    r = renderer()
    with spans.frame(events, "cuda"):   # the card's path of the recorder, on stand-ins
        r.step(events=events)
    (rec,) = spans.recent()
    assert set(spans.STAGES) <= set(events)
    assert set(events) == {n for n, _, _ in rec.marks}
    assert all(isinstance(ev, FakeEvent) for ev in events.values())
    assert fake_card == ["warn", 0] and rec.syncs == 0
    parts = spans.parts(rec)
    trace = [p.device_ms for n, p in parts.items() if n.startswith("trace")]
    dev = {n: ev for n, ev, _ in rec.marks}
    assert sum(trace) == pytest.approx(dev["gbuffer"].elapsed_time(dev["trace"]))
    assert all(p.lag_ms is not None for p in parts.values())


def test_syncs_counted_with_their_sites(fake_card):
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with spans.frame({}, "cuda"):
            for _ in range(2):
                warnings.warn(spans.SYNC_WARNING + " (as torch's sync debug mode words it)")
            warnings.warn("another warning")
    (rec,) = spans.recent()
    assert rec.syncs == 2 and len(rec.sync_sites) == 2
    assert all(s.startswith("tests/test_torch_spans.py:") for s in rec.sync_sites)
    # the other warnings are shown as before
    assert [str(w.message) for w in shown] == ["another warning"]


def test_one_frame_in_sync_every_counts(fake_card):
    for _ in range(2 * spans.SYNC_EVERY + 1):
        with spans.frame({}, "cuda"):
            spans.mark({}, "a")
            spans.mark({}, "b")
    frames = spans.recent()
    counted = [k for k, f in enumerate(frames) if f.syncs is not None]
    assert counted == [0, spans.SYNC_EVERY, 2 * spans.SYNC_EVERY]
    # the sync mode is switched for the counting frames alone
    assert fake_card == ["warn", 0] * len(counted)
    timed = spans.timed(frames)
    assert len(timed) == len(frames) - len(counted) and all(f.syncs is None for f in timed)
    assert list(spans.table(frames)) == ["b"]
    spans.clear()
    with spans.frame({}, "cuda"):
        pass
    assert spans.recent()[0].syncs == 0   # after clear(), the next frame counts


def test_ring_is_bounded():
    for _ in range(spans.RING + 44):
        with spans.frame({}, "cpu"):
            spans.mark({}, "x")
    assert len(spans.recent()) == spans.RING
