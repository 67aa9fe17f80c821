"""The readers of the program's own spans (program_spans.py and the metrics
shade_ms, bounce_intersect_ms, host_syncs_per_step and filter_p95_ms) on
registries built by hand: their medians and the 95th percentile, times
from the frames that counted no syncs and the count from the others, and
None where the registry holds no frame, where its frames ran on the CPU,
or where the program has no span recorder."""

import statistics
import sys

import pytest

from portbench.metrics import reader

READERS = ["shade_ms", "bounce_intersect_ms", "host_syncs_per_step", "filter_p95_ms"]


class Ev:
    """A device event at a given device time (ms)."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms

    def synchronize(self):
        pass


# an orbit frame's marks: (name, device ms, host ms), two bounces
ORBIT = [("start", 0, 0), ("gbuffer.rays", 1, 1), ("gbuffer.intersect", 2, 2),
         ("gbuffer.fill", 4, 3), ("gbuffer", 5, 4), ("trace.setup", 6, 5),
         ("trace.b0.surface", 10, 6), ("trace.b0.sample", 14, 7), ("trace.b0.intersect", 15, 8),
         ("trace.b0.mis", 18, 9), ("trace.b0.cull", 19, 10), ("trace.b1.surface", 22, 11),
         ("trace.b1.sample", 25, 12), ("trace.b1.intersect", 25.5, 13), ("trace.b1.mis", 28, 14),
         ("trace.b1.cull", 29, 15), ("trace", 30, 17), ("filter.begin", 30.5, 17.5),
         ("temporal", 31, 18), ("moments", 31.5, 18.5), ("atrous", 32.5, 19), ("taa", 33, 19.5),
         ("state", 33.5, 20)]
SHADE = (4 + 4 + 3 + 1) + (3 + 3 + 2.5 + 1)
INTERSECT = 1 + 0.5
FILTER = 33 - 30.5


def frame(marks, scale=1.0, syncs=None, on_card=True):
    """A recorded frame; `syncs` given: a frame that counted them."""
    from svgf_tpu_torch.render.spans import Frame

    f = Frame(on_card, syncs is not None)
    f.marks = [(n, Ev(d * scale) if on_card else None, h * scale / 1e3) for n, d, h in marks]
    if syncs is not None:
        f.sync_sites.extend(["render/pipeline.py:1"] * syncs)
    return f


@pytest.fixture
def registry(monkeypatch):
    """Sets the program's registry to the frames given."""
    from svgf_tpu_torch.render import spans

    def fill(frames):
        monkeypatch.setattr(spans, "recent", lambda: list(frames))

    return fill


def read(name):
    return reader(name)(None)


def test_medians_over_frames(registry):
    # the frames that counted syncs read slow: their times are not read
    registry([frame(ORBIT, 9.0, syncs=5), frame(ORBIT, 3.0), frame(ORBIT, 1.0),
              frame(ORBIT, 9.0, syncs=2), frame(ORBIT, 2.0), frame(ORBIT, 9.0, syncs=3)])
    assert read("shade_ms") == pytest.approx(2 * SHADE)
    assert read("bounce_intersect_ms") == pytest.approx(2 * INTERSECT)
    assert read("host_syncs_per_step") == 3


def test_filter_p95(registry):
    scales = [1.0 + 0.01 * k for k in range(40)]
    denoise = ORBIT[ORBIT.index(("filter.begin", 30.5, 17.5)):-1]
    registry([frame(denoise, 5.0, syncs=0)] + [frame(denoise, s) for s in scales])
    want = statistics.quantiles([FILTER * s for s in scales], n=100, method="inclusive")[94]
    assert read("filter_p95_ms") == pytest.approx(want)
    # a denoise frame has no trace: the orbit's readers find nothing there
    assert read("shade_ms") is None and read("bounce_intersect_ms") is None
    assert read("host_syncs_per_step") == 0


@pytest.mark.parametrize("name", READERS)
def test_none_when_empty_or_on_the_cpu(registry, name):
    registry([])
    assert read(name) is None
    registry([frame(ORBIT, on_card=False), frame(ORBIT, 2.0, on_card=False)])
    assert read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_recorder(monkeypatch, name):
    # the parent program has no render.spans: its import fails
    import svgf_tpu_torch.render

    monkeypatch.delattr(svgf_tpu_torch.render, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "svgf_tpu_torch.render.spans", None)
    assert read(name) is None
