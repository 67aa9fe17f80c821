"""The port's plain filter stages (svgf_tpu_torch.render.svgf) against their
JAX twins (svgf_tpu.render.svgf), on the same seeded inputs.

Tolerances are tests/test_planar.py's: the temporal stage to atol 3e-5
with the reprojection mask exact; downstream of the variance-guided
weights, mean < 1e-4 and no pixel above 2e-2. One case holds the port's
filter chain against svgf_tpu's planar Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgf_tpu.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_tpu.render import pipeline as jpipe
from svgf_tpu.render import svgf as jsvgf
from svgf_tpu.render.types import GBuffer as JGBuffer
from svgf_tpu.render.types import TemporalState as JState
from svgf_tpu_torch.render import pipeline as tpipe
from svgf_tpu_torch.render import svgf as tsvgf
from svgf_tpu_torch.render.types import GBuffer, TemporalState

H, W = 40, 72
SV = SVGFConfig(spatial_filter_steps=3)


def make_inputs(seed=0, background=False, max_motion=(6, 40), dtype=np.float32):
    """NumPy radiance, G-buffer and previous state: the current G-buffer is
    the previous one seen through the motion (so most pixels reproject),
    10% of pixels change instance (disocclusion), motion pushes border
    pixels off-screen, history spans 1..23 (so < 4 occurs)."""
    rng = np.random.default_rng(seed)
    n_prev = rng.standard_normal((H, W, 3))
    n_prev /= np.linalg.norm(n_prev, axis=-1, keepdims=True)
    depth_prev = rng.uniform(1, 5, (H, W))
    inst_prev = rng.integers(0, 3, (H, W))
    my, mx = max_motion
    motion = np.stack([np.trunc(rng.uniform(-mx, mx, (H, W))),
                       np.trunc(rng.uniform(-my, my, (H, W)))], axis=-1)
    py = np.clip(np.arange(H)[:, None] + motion[..., 1].astype(int), 0, H - 1)
    px = np.clip(np.arange(W)[None, :] + motion[..., 0].astype(int), 0, W - 1)
    depth = depth_prev[py, px] + rng.uniform(-0.05, 0.05, (H, W))
    n = n_prev[py, px]
    inst = np.where(rng.uniform(size=(H, W)) < 0.1, (inst_prev[py, px] + 1) % 3, inst_prev[py, px])
    if background:
        bg = rng.uniform(size=(H, W)) < 0.2
        depth, n, inst = np.where(bg, 0.0, depth), np.where(bg[..., None], 0.0, n), np.where(bg, -1, inst)
    f = lambda x, dt=np.float32: np.asarray(x, dt)
    gbuf = dict(depth=f(depth), depth_deriv=f(rng.uniform(1e-4, 1e-2, (H, W))),
                normal=f(n), instance=f(inst, np.int32), motion=f(motion))
    prev = dict(depth=f(depth_prev, dtype), normal=f(n_prev, dtype), instance=f(inst_prev, np.int32))
    state = dict(color=f(rng.uniform(0, 1, (H, W, 4)), dtype),
                 moments=f(rng.uniform(0, 0.5, (H, W, 2)), dtype),
                 history_len=f(rng.integers(1, 24, (H, W)), np.int32),
                 taa_history=f(rng.uniform(0, 1, (H, W, 4)), dtype))
    return f(rng.uniform(0, 1, (H, W, 3))), gbuf, prev, state


def jax_gbuf(fields, dtype=jnp.float32):
    return JGBuffer.zeros(H, W, dtype)._replace(**{k: jnp.asarray(v) for k, v in fields.items()})


def torch_gbuf(fields, dtype=torch.float32):
    return GBuffer.zeros(H, W, dtype, "cpu")._replace(**{k: torch.from_numpy(v) for k, v in fields.items()})


def jax_state(prev, state):
    dt = jnp.asarray(state["color"]).dtype
    return JState.initial(H, W, dt)._replace(
        gbuffer=jax_gbuf(prev, dt), **{k: jnp.asarray(v) for k, v in state.items()})


def torch_state(prev, state):
    dt = torch.from_numpy(state["color"]).dtype
    return TemporalState.initial(H, W, dt, "cpu")._replace(
        gbuffer=torch_gbuf(prev, dt), **{k: torch.from_numpy(v) for k, v in state.items()})


def assert_downstream(name, got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.mean() < 1e-4, (name, d.mean())
    assert (d > 2e-2).mean() == 0.0, (name, d.max())


@pytest.mark.parametrize("seed,background,dtype", [
    (0, False, np.float32), (1, True, np.float32), (2, True, np.float16),
])
def test_temporal_filter_matches_jax(seed, background, dtype):
    radiance, gbuf, prev, state = make_inputs(seed, background, max_motion=(30, 90), dtype=dtype)
    args = dict(depth_threshold=SV.depth_threshold, normal_threshold=SV.normal_threshold,
                history_base_length=SV.history_length)
    js = jax_state(prev, state)
    want = jax.jit(lambda r: jsvgf.temporal_filter(
        r, js.color.astype(jnp.float32), jax_gbuf(gbuf), js.gbuffer,
        js.moments.astype(jnp.float32), js.history_len, **args))(jnp.asarray(radiance))
    ts = torch_state(prev, state)
    got = tsvgf.temporal_filter(torch.from_numpy(radiance), ts.color, torch_gbuf(gbuf), ts.gbuffer,
                                ts.moments, ts.history_len, **args)
    valid = np.asarray(want.reprojected)
    assert 0.1 < valid.mean() < 0.95  # both reprojected and disoccluded pixels occur
    np.testing.assert_array_equal(got.reprojected.numpy(), valid)
    np.testing.assert_array_equal(got.history_len.numpy(), np.asarray(want.history_len))
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color), atol=3e-5)
    np.testing.assert_allclose(got.moments.numpy(), np.asarray(want.moments), atol=3e-5)


@pytest.mark.parametrize("background", [False, True])
def test_moments_atrous_taa_match_jax(background):
    """Each downstream stage fed the same inputs on both sides."""
    radiance, gbuf, prev, state = make_inputs(3, background)
    rng = np.random.default_rng(4)
    color = np.asarray(rng.uniform(0, 1, (H, W, 4)), np.float32)
    moments = np.asarray(rng.uniform(0, 0.5, (H, W, 2)), np.float32)
    hist = np.asarray(rng.integers(1, 7, (H, W)), np.int32)   # about half below 4
    jg, tg = jax_gbuf(gbuf), torch_gbuf(gbuf)
    t = torch.from_numpy

    want = jax.jit(lambda c, m, h: jsvgf.filter_moments(c, m, jg, h, SV.phi_colour, SV.phi_normal))(
        jnp.asarray(color), jnp.asarray(moments), jnp.asarray(hist))
    got = tsvgf.filter_moments(t(color), t(moments), tg, t(hist), SV.phi_colour, SV.phi_normal)
    assert_downstream("moments", got.numpy(), want)

    want_w = jax.jit(lambda c: jsvgf.wavelet_filter(c, jg, 3, SV.phi_colour, SV.phi_normal))(
        jnp.asarray(color))
    got_w = tsvgf.wavelet_filter(t(color), tg, 3, SV.phi_colour, SV.phi_normal)
    for name, g, w in zip(("atrous", "feedback", "second_last"), got_w, want_w):
        assert_downstream(name, g.numpy(), w)

    hist_taa = state["taa_history"]
    want_t = jax.jit(jsvgf.taa)(jnp.asarray(color), jnp.asarray(hist_taa))
    got_t = tsvgf.taa(t(color), t(hist_taa))
    assert_downstream("taa", got_t.numpy(), want_t)


def _chains(cfg_jax, cfg_torch, seed=5, background=True, max_motion=(6, 40)):
    radiance, gbuf, prev, state = make_inputs(seed, background, max_motion)
    js = jax_state(prev, state)
    tres, m, a, final, fb = jax.jit(
        lambda r: jpipe.filter_chain(r, jax_gbuf(gbuf), js, cfg_jax))(jnp.asarray(radiance))
    want = dict(temporal=tres.color, t_moments=tres.moments, t_hist=tres.history_len,
                t_valid=tres.reprojected, moments=m, atrous=a, final=final, feedback=fb)
    tres, m, a, final, fb = tpipe.filter_chain(
        torch.from_numpy(radiance), torch_gbuf(gbuf), torch_state(prev, state), cfg_torch)
    got = dict(temporal=tres.color, t_moments=tres.moments, t_hist=tres.history_len,
               t_valid=tres.reprojected, moments=m, atrous=a, final=final, feedback=fb)
    return {k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()}


def test_filter_chain_matches_jax_pallas_kernels():
    """The port's chain against svgf_tpu's planar Pallas kernels (interpret
    mode), motion inside their (8, 63) px bound."""
    cfg = RenderConfig(width=W, height=H, svgf=SV, tracing=TracingConfig(bounces=2),
                       state_dtype="float32")
    got, want = _chains(dataclasses.replace(cfg, use_pallas="interpret", planar_chain=True),
                        dataclasses.replace(cfg, use_pallas="off"))
    for k in want:
        if k == "t_valid":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif k in ("temporal", "t_moments", "t_hist"):
            np.testing.assert_allclose(got[k], want[k], atol=3e-5, err_msg=k)
        else:
            assert_downstream(k, got[k], want[k])


def test_filter_chain_no_atrous_no_taa():
    """steps=0: the temporal output is the feedback; no TAA: clip + sRGB."""
    sv = SVGFConfig(spatial_filter_steps=0, enable_taa=False)
    cfg = RenderConfig(width=W, height=H, svgf=sv, state_dtype="float32", use_pallas="off")
    got, want = _chains(cfg, cfg, seed=6)
    np.testing.assert_array_equal(got["feedback"], got["temporal"])
    for k in ("temporal", "moments", "final", "feedback"):
        np.testing.assert_allclose(got[k], want[k], atol=3e-5, err_msg=k)
