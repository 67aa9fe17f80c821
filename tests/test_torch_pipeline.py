"""The port's Renderer against svgf_tpu's: Cornell at 32x24 for three frames
with a small camera orbit before each, fp16 state, on the same scene data
(convert.py). The port runs its plain versions on the CPU; svgf_tpu runs
render_frame with use_pallas="off". The same frames again with bfloat16
state.

A large scene goes the same way: one frame of stress_scene(n=96) (18,052
world triangles: the BLAS-leaf soup, the scene-BVH walk and the 64x64
pixel-block lane order), each package flattening its own scene with the
NumPy BVH builder.

Tolerances are those of tests/test_planar.py:158-176: radiance to 1e-4;
taps mean < 1e-4 and no pixel above 2e-2; the final image mean < 1e-4 and
no pixel above 5e-3; metrics to 1e-3. The ray count is exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from svgf_tpu.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_tpu.core.camera import orbit_frame
from svgf_tpu.render.pipeline import Renderer as JRenderer
from svgf_tpu.scenes import cornell_box as j_cornell
from svgf_tpu.scenes.stress import stress_scene as j_stress
from svgf_tpu_torch import config as tconfig
from svgf_tpu_torch import convert
from svgf_tpu_torch.render.pipeline import Renderer
from svgf_tpu_torch.scenes.cornell import cornell_box
from svgf_tpu_torch.scenes.stress import stress_scene

W, H = 32, 24
FRAMES = 3
CONFIG = RenderConfig(width=W, height=H, svgf=SVGFConfig(spatial_filter_steps=3),
                      tracing=TracingConfig(bounces=2), state_dtype="float16", use_pallas="off")


def orbit(f):
    # starts off the symmetric default view: a pixel centre exactly on a
    # corner edge of the box is a tie either side may win
    return orbit_frame([0.0, 0.0, 0.0], 3.4, theta=0.013 + 0.03 * f, phi=0.011)


def _run_frames(config):
    jr = JRenderer(j_cornell(aspect=W / H), config)
    tr = Renderer(cornell_box(aspect=W / H), config, device="cpu")
    tr.arrays = convert.scene_arrays(jax.tree.map(np.asarray, jr.arrays), device="cpu")
    out = []
    for f in range(FRAMES):
        jr.update_camera(orbit(f))
        tr.update_camera(orbit(f))
        out.append((jax.tree.map(np.asarray, jr.step()), tr.step(), tr.state))
    return out


@pytest.fixture(scope="module")
def frames():
    return _run_frames(CONFIG)


@pytest.fixture(scope="module")
def frames_bf16():
    """The same frames with bfloat16 state ("the TPU-native choice" of
    svgf_tpu/config.py), which the kernel route reads as the fp16 state."""
    return _run_frames(dataclasses.replace(CONFIG, state_dtype="bfloat16"))


def assert_close(name, got, want, mean_tol, max_tol):
    d = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64))
    assert d.mean() < mean_tol, (name, d.mean())
    assert (d > max_tol).mean() == 0.0, (name, d.max())


def _assert_frame_matches(want, got):
    np.testing.assert_allclose(got.radiance.numpy(), want.radiance, atol=1e-4)
    for tap in ("temporal", "moments_filtered", "atrous"):
        assert_close(tap, getattr(got, tap), getattr(want, tap), 1e-4, 2e-2)
    assert_close("final", got.final, want.final, 1e-4, 5e-3)
    assert got.final.shape == (H, W, 3)
    for f in ("disoccluded_pct", "mean_history", "mean_variance", "coverage_pct"):
        np.testing.assert_allclose(float(getattr(got.metrics, f)), float(getattr(want.metrics, f)),
                                   atol=1e-3, err_msg=f)
    assert int(got.metrics.rays_traced) == int(want.metrics.rays_traced)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_frame_matches_jax(frames, frame):
    _assert_frame_matches(*frames[frame][:2])


@pytest.mark.parametrize("frame", range(FRAMES))
def test_bf16_frame_matches_jax(frames_bf16, frame):
    want, got, state = frames_bf16[frame]
    _assert_frame_matches(want, got)
    for t in (state.color, state.moments, state.taa_history, state.gbuffer.depth):
        assert t.dtype == torch.bfloat16


def test_state_is_fp16_and_advances(frames):
    _, _, state = frames[-1]
    assert state.frame_idx == FRAMES
    for t in (state.color, state.moments, state.taa_history, state.gbuffer.depth):
        assert str(t.dtype) == "torch.float16"
    assert str(state.history_len.dtype) == "torch.int32"
    assert int(state.history_len.max()) >= 2  # the orbit keeps most pixels


def test_stress_frame_matches_jax(monkeypatch):
    # svgf_tpu's optional native BVH builder makes another tree than the
    # NumPy builder the port copies, and the tree orders the soup
    monkeypatch.setenv("SVGF_NATIVE", "0")
    w, h = 40, 24
    cfg = CONFIG.to_json().replace('"state_dtype": "float16"', '"state_dtype": "float32"')
    jcfg, tcfg = RenderConfig.from_json(cfg), tconfig.RenderConfig.from_json(cfg)
    assert (jcfg.state_dtype, tcfg.width, tcfg.height) == ("float32", W, H)
    jcfg = dataclasses.replace(jcfg, width=w, height=h)
    tcfg = dataclasses.replace(tcfg, width=w, height=h)
    want = jax.tree.map(np.asarray, JRenderer(j_stress(n=96, aspect=w / h), jcfg).step())
    tr = Renderer(stress_scene(n=96, aspect=w / h), tcfg, device="cpu")
    assert tr.arrays.meta.soup_leaf_order and tr.arrays.meta.n_world_tris == 18052
    got = tr.step()
    np.testing.assert_allclose(got.radiance.numpy(), want.radiance, atol=1e-4)
    for tap in ("temporal", "atrous"):
        assert_close(tap, getattr(got, tap), getattr(want, tap), 1e-4, 2e-2)
    assert_close("final", got.final, want.final, 1e-4, 5e-3)
    assert float(got.metrics.coverage_pct) > 20.0
    np.testing.assert_allclose(float(got.metrics.coverage_pct), float(want.metrics.coverage_pct),
                               atol=1e-3)
    # the 64x64-block edge padding traces, and counts, as in svgf_tpu
    assert int(got.metrics.rays_traced) == int(want.metrics.rays_traced)
