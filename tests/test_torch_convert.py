"""svgf_tpu's data carries across to the port (svgf_tpu_torch.convert).

The port's config dataclasses are svgf_tpu's field for field, and one
JSON config loads into either package. The Cornell scene flattened by
svgf_tpu and converted equals the port's own Scene.flatten(device="cpu")
bit for bit, field by field and SceneMeta entry by entry, when both build
their BVHs with the NumPy builder; and a JAX fp16 TemporalState after two
frames, converted, renders the third frame as svgf_tpu does, to
tests/test_torch_pipeline.py's tolerances.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from svgf_tpu import config as jconfig
from svgf_tpu.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_tpu.core.camera import orbit_frame
from svgf_tpu.render.pipeline import Renderer as JRenderer
from svgf_tpu.scenes import cornell_box as j_cornell
from svgf_tpu_torch import config as tconfig
from svgf_tpu_torch import convert
from svgf_tpu_torch.core.scene import SceneArrays, SceneMeta
from svgf_tpu_torch.render.pipeline import render_frame
from svgf_tpu_torch.scenes.cornell import cornell_box

W, H = 32, 24


@pytest.mark.parametrize("name", ["TracingConfig", "SVGFConfig", "MeshConfig", "RenderConfig"])
def test_config_matches_jax(name):
    """The port's own copy of svgf_tpu/config.py: the same fields with the
    same defaults, and the enums with the same members."""
    want, got = getattr(jconfig, name), getattr(tconfig, name)
    assert [(f.name, f.type) for f in dataclasses.fields(got)] == \
        [(f.name, f.type) for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())
    for enum_name in ("SamplingMode", "DebugOutput"):
        assert ({m.name: int(m) for m in getattr(tconfig, enum_name)}
                == {m.name: int(m) for m in getattr(jconfig, enum_name)})


def test_config_json_loads_into_either_package():
    cfg = RenderConfig(width=64, height=36, svgf=SVGFConfig(spatial_filter_steps=5),
                       tracing=TracingConfig(bounces=2, sampling_mode=jconfig.SamplingMode.BSDF),
                       debug_output=jconfig.DebugOutput.ATROUS, use_pallas="off",
                       use_pallas_intersect="on", reproject_max_motion=(4, 31))
    port = tconfig.RenderConfig.from_json(cfg.to_json())
    assert port.to_json() == cfg.to_json()
    assert RenderConfig.from_json(port.to_json()) == cfg
    assert port.tracing.sampling_mode is tconfig.SamplingMode.BSDF
    assert port.debug_output is tconfig.DebugOutput.ATROUS


@pytest.mark.parametrize("aspect", [1.0, 16 / 9])
def test_flatten_matches_jax_bitwise(aspect, monkeypatch):
    # the port builds its BVHs with svgf_tpu's NumPy reference builder
    # only; svgf_tpu's optional native builder makes another tree
    monkeypatch.setenv("SVGF_NATIVE", "0")
    want = jax.tree.map(np.asarray, j_cornell(aspect=aspect).flatten())
    got = cornell_box(aspect=aspect).flatten(device="cpu")
    conv = convert.scene_arrays(want, device="cpu")
    for f in dataclasses.fields(SceneMeta):
        assert getattr(got.meta, f.name) == getattr(want.meta, f.name), f.name
    assert conv.meta == got.meta
    for name in SceneArrays.tensor_fields():
        w, g, c = getattr(want, name), getattr(got, name), getattr(conv, name)
        assert g.shape == w.shape and str(g.dtype) == f"torch.{w.dtype}", name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert torch.equal(c, g), name


def test_jax_state_renders_third_frame():
    cfg = RenderConfig(width=W, height=H, svgf=SVGFConfig(spatial_filter_steps=2),
                       tracing=TracingConfig(bounces=2), state_dtype="float16",
                       use_pallas="off", seed=3)
    jr = JRenderer(j_cornell(aspect=W / H), cfg)
    for f in range(3):
        jr.update_camera(orbit_frame([0.0, 0.0, 0.0], 3.4, theta=0.017 + 0.02 * f, phi=0.009))
        if f == 2:
            state = convert.temporal_state(jax.tree.map(np.asarray, jr.state), device="cpu")
            arrays = convert.scene_arrays(jax.tree.map(np.asarray, jr.arrays), device="cpu")
        out = jax.tree.map(np.asarray, jr.step())
    assert state.frame_idx == 2 and state.color.dtype == torch.float16

    got, new_state = render_frame(arrays, state, cfg)
    assert new_state.frame_idx == 3
    np.testing.assert_allclose(got.radiance.numpy(), out.radiance, atol=1e-4)
    for tap, max_tol in (("temporal", 2e-2), ("moments_filtered", 2e-2), ("atrous", 2e-2),
                         ("final", 5e-3)):
        d = np.abs(getattr(got, tap).numpy() - getattr(out, tap))
        assert d.mean() < 1e-4, (tap, d.mean())
        assert (d > max_tol).mean() == 0.0, (tap, d.max())


@pytest.mark.parametrize("n", [1, 2, 4])
def test_state_bands_round_trip(n):
    """temporal_state_band cuts a full-image JAX state into rank r's rows
    [r*H/n, (r+1)*H/n); stack_bands puts the ranks' bands back together."""
    import jax.numpy as jnp

    from svgf_tpu.render.types import TemporalState as JState

    rng = np.random.default_rng(n)
    js = jax.tree.map(np.asarray, JState.initial(H, W, jnp.float16))
    js = js._replace(
        color=rng.uniform(0, 1, js.color.shape).astype(np.float16),
        history_len=rng.integers(1, 24, js.history_len.shape).astype(np.int32),
        gbuffer=js.gbuffer._replace(depth=rng.uniform(1, 3, (H, W)).astype(np.float16)),
        frame_idx=np.int32(5))
    bands = [convert.temporal_state_band(js, r, n, "cpu") for r in range(n)]
    hs = H // n
    for r, band in enumerate(bands):
        assert band.color.shape == (hs, W, 4) and band.frame_idx == 5
        assert np.array_equal(band.color.numpy(), js.color[r * hs:(r + 1) * hs])
        assert np.array_equal(band.gbuffer.depth.numpy(), js.gbuffer.depth[r * hs:(r + 1) * hs])
    whole, stacked = convert.temporal_state(js, "cpu"), convert.stack_bands(bands)
    for f in ("color", "moments", "history_len", "taa_history"):
        assert torch.equal(getattr(stacked, f), getattr(whole, f)), f
    for a, b in zip(stacked.gbuffer, whole.gbuffer):
        assert torch.equal(a, b)
    assert stacked.frame_idx == whole.frame_idx == 5
