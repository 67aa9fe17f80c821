"""The kernel policy and the wrappers' checks, on the CPU. The CUDA kernels
themselves run only on the card: chip_smoke.py holds each against its plain
version there."""

import numpy as np
import pytest
import torch

from svgf_tpu_torch.config import RenderConfig
from svgf_tpu_torch.kernels import build, resolve_kernels
from svgf_tpu_torch.kernels import filter as K
from svgf_tpu_torch.render import pipeline
from svgf_tpu_torch.render import svgf as P
from svgf_tpu_torch.render.types import GBuffer, TemporalState


@pytest.mark.parametrize("mode,device,expect", [
    ("off", "cpu", False), ("off", "cuda", False),
    ("auto", "cpu", False), ("auto", "cuda", True),
    ("on", "cuda", True),
])
def test_resolve_kernels(mode, device, expect):
    assert resolve_kernels(mode, device) is expect


@pytest.mark.parametrize("mode,device", [("on", "cpu"), ("interpret", "cpu"),
                                         ("interpret", "cuda"), ("fast", "cpu")])
def test_resolve_kernels_rejects(mode, device):
    with pytest.raises(ValueError):
        resolve_kernels(mode, device)


def test_intersector_policy():
    from svgf_tpu_torch.ops.intersect import intersect_scene
    from svgf_tpu_torch.scenes.cornell import cornell_box

    arrays = cornell_box().flatten()
    ro, rd = torch.zeros((4, 3)), torch.ones((4, 3))
    with pytest.raises(ValueError):  # "on" on CPU tensors
        intersect_scene(arrays, ro, rd, "on")
    assert intersect_scene(arrays, ro, rd, "auto").dist.shape == (4,)


def test_render_with_kernels_on_cpu_raises():
    from svgf_tpu_torch.scenes.cornell import cornell_box

    cfg = RenderConfig(width=8, height=8, use_pallas="on", use_pallas_intersect="off")
    r = pipeline.Renderer(cornell_box(), cfg)
    with pytest.raises(ValueError):
        r.step()


def _inputs(h=6, w=10, device="cpu"):
    rng = np.random.default_rng(0)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    gbuf = GBuffer.zeros(h, w, device=device)._replace(
        depth=t(rng.uniform(1, 2, (h, w))), normal=t(np.tile([0.0, 0.0, 1.0], (h, w, 1))),
        depth_deriv=t(rng.uniform(0, 0.01, (h, w))), instance=t(np.zeros((h, w)), torch.int32))
    state = TemporalState.initial(h, w, torch.float16, device)
    return t(rng.uniform(0, 1, (h, w, 3))), gbuf, state


def test_wrappers_on_cpu_are_the_plain_versions():
    radiance, gbuf, state = _inputs()
    K.reset_launches()
    args = (radiance, state.color, gbuf, state.gbuffer, state.moments, state.history_len,
            0.8, 0.9, 24)
    tk, tp = K.temporal_filter(*args), P.temporal_filter(*args)
    for a, b in zip(tk, tp):
        assert torch.equal(a, b)
    m = K.filter_moments(tp.color, tp.moments, gbuf, tp.history_len, 10.0, 128.0)
    assert torch.equal(m, P.filter_moments(tp.color, tp.moments, gbuf, tp.history_len, 10.0, 128.0))
    for a, b in zip(K.wavelet_filter(m, gbuf, 3, 10.0, 128.0), P.wavelet_filter(m, gbuf, 3, 10.0, 128.0)):
        assert torch.equal(a, b)
    assert torch.equal(K.taa(m, state.taa_history), P.taa(m, state.taa_history))
    assert K.LAUNCHES == {"temporal": 0, "moments": 0, "atrous": 0, "taa": 0}


def test_wrappers_reject_devices_without_a_kernel():
    state = TemporalState.initial(6, 10, torch.float16, "meta")
    with pytest.raises(ValueError):
        K.taa(torch.empty((6, 10, 4), device="meta"), state.taa_history)
    with pytest.raises(ValueError):  # mixed devices
        K.taa(torch.zeros((6, 10, 4)), state.taa_history)


@pytest.mark.parametrize("phi,expect", [(128.0, 7), (2.0, 1), (64, 6), (100.0, -1), (1.0, -1),
                                        (0.5, -1)])
def test_normal_power_squarings(phi, expect):
    assert K._normal_squarings(phi) == expect


def test_library_path_is_keyed_by_the_sources():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path == build.library_path()
    assert len(sorted(build.CSRC.glob("*.cu"))) == 4
    for name in build.SIGNATURES:
        assert any(name in src.read_text() for src in build.CSRC.glob("*.cu")), name
