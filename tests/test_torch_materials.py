"""The port's tracer on the materials scene against svgf_tpu's, on the CPU.

The materials scene (svgf_tpu_torch/scenes/materials.py: textured and
normal-mapped walls with alpha, PBR rough and mirror walls, a glass block,
a volumetric block, an area light and a textured environment) is built
by both packages from the same data, svgf_tpu's flattened with its NumPy
BVH builder and carried across with convert.scene_arrays. A variant turns
the glass rough (0.2), the volume into SUBSURFACE and the left wall 60%
opaque.

* pathtrace on 2,048 camera lanes, 3 bounces, in MIS, BSDF, LIGHT and BOTH
  modes: radiance to 1e-4 (tests/test_torch_pipeline.py's bar), rays_traced
  exact, and every uniform field the bounces draw bit for bit, in order
  (svgf_tpu runs eagerly: its jit compile would take most of the file's
  time budget);
* svgf_tpu's Beer-Lambert slab (tests/test_media.py:98) through the port,
  at its rtol 0.06;
* three 32x24 Renderer frames of the materials scene, fp16 state, plain
  versions, against svgf_tpu's render_frame at test_torch_pipeline.py's
  bars;
* each feature that raised NotImplementedError before the port had it
  renders a finite frame.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgf_tpu.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_tpu.config import SamplingMode as JSamplingMode
from svgf_tpu.core.camera import orbit_frame as j_orbit_frame
from svgf_tpu.core.scene import Environment as JEnvironment
from svgf_tpu.core.scene import Material as JMaterial
from svgf_tpu.core.scene import MaterialType as JMaterialType
from svgf_tpu.ops import sampling as jsampling
from svgf_tpu.render.gbuffer import camera_rays as j_camera_rays
from svgf_tpu.render.pathtrace import pathtrace as j_pathtrace
from svgf_tpu.render.pipeline import Renderer as JRenderer
from svgf_tpu.render.pipeline import render_frame as j_render_frame
from svgf_tpu.scenes import cornell_box as j_cornell
from svgf_tpu_torch import config as tconfig
from svgf_tpu_torch import convert
from svgf_tpu_torch.core.camera import Camera, look_at_frame
from svgf_tpu_torch.core.camera import orbit_frame
from svgf_tpu_torch.core.scene import Environment, Instance, Material, MaterialType, Scene, Shape
from svgf_tpu_torch.ops import keys
from svgf_tpu_torch.ops import sampling as tsampling
from svgf_tpu_torch.render.pathtrace import pathtrace
from svgf_tpu_torch.render.pipeline import Renderer
from svgf_tpu_torch.scenes.cornell import cornell_box
from svgf_tpu_torch.scenes.materials import (
    checker_texture, dress_cornell, environment_texture, normal_texture,
)

H, W = 32, 64           # 2,048 lanes
MODES = ("MIS", "BSDF", "LIGHT", "BOTH")


def variant(scene, material_type):
    """Rough glass, SUBSURFACE in place of the volume, a 60% opaque wall."""
    m = scene.materials
    m[4] = dataclasses.replace(m[4], roughness=0.2)
    m[5] = dataclasses.replace(m[5], material_type=material_type.SUBSURFACE)
    m[1] = dataclasses.replace(m[1], opacity=0.6)
    return scene


def _j_scene(name, aspect, monkeypatch):
    """svgf_tpu's materials scene (or its variant) seen from a slightly
    orbited camera, flattened with the NumPy BVH builder."""
    monkeypatch.setenv("SVGF_NATIVE", "0")
    scene = dress_cornell(j_cornell(aspect=aspect), JMaterial, JMaterialType, JEnvironment)
    if name == "variant":
        variant(scene, JMaterialType)
    cam = scene.cameras[0]
    scene.cameras[0] = cam.advance(j_orbit_frame([0, 0, 0], 3.4, theta=0.021, phi=0.013))
    return scene


@pytest.fixture(scope="module", params=["materials", "variant"])
def scenes(request):
    mp = pytest.MonkeyPatch()
    try:
        ja = _j_scene(request.param, W / H, mp).flatten()
    finally:
        mp.undo()
    ta = convert.scene_arrays(jax.tree.map(np.asarray, ja), device="cpu")
    m = ta.meta
    assert m.has_media and m.has_opacity and m.textures_enabled and m.has_normal_maps
    assert m.n_lights == 2 and m.n_envs == 1
    assert set(m.mat_types_used) == ({0, 1, 2, 3} if request.param == "materials" else {0, 1, 3, 4})
    ro, rd = jax.jit(lambda a: j_camera_rays(a.cam_frame[0], a.cam_proj[0], H, W))(ja)
    return ja, ta, np.array(ro), np.array(rd)


@contextlib.contextmanager
def recorded_uniforms(monkeypatch):
    """Every uniform field either package's RngStream draws, in order:
    (svgf_tpu's, the port's)."""
    fields = ([], [])
    for cls, out in ((jsampling.RngStream, fields[0]), (tsampling.RngStream, fields[1])):
        def record(self, *args, _orig=cls.uniform, _out=out):
            u = _orig(self, *args)
            _out.append(np.array(u))
            return u
        monkeypatch.setattr(cls, "uniform", record)
    yield fields


@pytest.mark.parametrize("mode", MODES)
def test_pathtrace_matches_jax(scenes, mode, monkeypatch):
    ja, ta, ro, rd = scenes
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.key(7), 3), 0)
    tkey = keys.fold_in(keys.fold_in(keys.key(7), 3), 0)
    with recorded_uniforms(monkeypatch) as (j_u, t_u):
        rad, _, nr = j_pathtrace(ja, jnp.asarray(ro), jnp.asarray(rd), jkey, bounces=3,
                                 mode=JSamplingMode[mode])
        rad = np.asarray(rad)
        got, got_nr = pathtrace(ta, torch.from_numpy(ro), torch.from_numpy(rd), tkey,
                                torch.arange(H * W), bounces=3,
                                mode=tconfig.SamplingMode[mode])
    # medium (2), opacity (1), NEE (4), BSDF (3), delta (1) and scatter (8)
    # draws a bounce, and BOTH's 50/50 choice
    assert len(j_u) == 3 * (19 + (mode == "BOTH")), len(j_u)
    assert len(t_u) == len(j_u)
    for k, (a, b) in enumerate(zip(j_u, t_u)):
        np.testing.assert_array_equal(b, a, err_msg=f"uniform field {k}")
    assert rad.mean() > 0.05
    np.testing.assert_allclose(got.numpy(), rad, atol=1e-4)
    assert int(got_nr) == int(nr)


# ---------------------------------------------------------------------------
# svgf_tpu's Beer-Lambert slab (tests/test_media.py:98), through the port
# ---------------------------------------------------------------------------


def _quad_z(z, half):
    p = np.array([[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]],
                 np.float32)
    return p, np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def test_absorbing_slab_beer_lambert():
    """Rays crossing a 1-unit absorbing VOLUMETRIC slab toward an emitter
    attenuate by exp(-density * L) = colour^L per channel (density is
    -log(colour) / transmission_depth, Common.cuh:1466-1470)."""
    colour = np.array([0.5, 0.6, 0.7], np.float32)
    emission = np.array([4.0, 4.0, 4.0], np.float32)
    scene = Scene()
    for z, name in ((0.5, "front"), (-0.5, "back"), (-2.0, "light")):
        p, i = _quad_z(z, 4.0)
        scene.shapes.append(Shape(positions=p, indices=i, name=name))
    scene.materials += [
        Material(colour=tuple(colour), material_type=MaterialType.VOLUMETRIC,
                 transmission_depth=1.0),
        Material(colour=(0.0, 0.0, 0.0), emission=tuple(emission)),
    ]
    scene.instances += [Instance(shape=0, material=0), Instance(shape=1, material=0),
                        Instance(shape=2, material=1)]
    scene.cameras.append(Camera(frame=look_at_frame([0, 0, 3], [0, 0, 0])))
    arrays = scene.flatten(device="cpu")
    assert arrays.meta.has_media
    R = 8192
    ro = torch.tensor([[0.0, 0.0, 3.0]]).repeat(R, 1)
    rd = torch.tensor([[0.0, 0.0, -1.0]]).repeat(R, 1)
    rad, _ = pathtrace(arrays, ro, rd, keys.key(7), torch.arange(R), bounces=4, clamp=100.0)
    expect = emission * np.exp(-(-np.log(colour)) * 1.0)  # = emission * colour
    np.testing.assert_allclose(rad.mean(0).numpy(), expect, rtol=0.06)


# ---------------------------------------------------------------------------
# Renderer frames against svgf_tpu's render_frame
# ---------------------------------------------------------------------------

RW, RH = 32, 24
FRAMES = 3
CONFIG = RenderConfig(width=RW, height=RH, svgf=SVGFConfig(spatial_filter_steps=3),
                      tracing=TracingConfig(bounces=2), state_dtype="float16", use_pallas="off")


def _orbit(f):
    """(eye orbit centre, radius), theta, phi before frame f; starts off the
    symmetric view, as tests/test_torch_pipeline.py's orbit."""
    return ([0.0, 0.0, 0.0], 3.4), dict(theta=0.013 + 0.03 * f, phi=0.011)


def _assert_close(name, got, want, mean_tol, max_tol):
    d = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64))
    assert d.mean() < mean_tol, (name, d.mean())
    assert (d > max_tol).mean() == 0.0, (name, d.max())


@pytest.fixture(scope="module")
def renderer_frames():
    """FRAMES frames of both renderers; svgf_tpu's render_frame runs
    eagerly on its Renderer's arrays and state."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("SVGF_NATIVE", "0")
        jr = JRenderer(dress_cornell(j_cornell(aspect=RW / RH), JMaterial, JMaterialType,
                                     JEnvironment), CONFIG)
    finally:
        mp.undo()
    tcfg = tconfig.RenderConfig.from_json(CONFIG.to_json())
    tr = Renderer(cornell_box(aspect=RW / RH), tcfg, device="cpu")
    tr.arrays = convert.scene_arrays(jax.tree.map(np.asarray, jr.arrays), device="cpu")
    out = []
    for f in range(FRAMES):
        args, kw = _orbit(f)
        jr.update_camera(j_orbit_frame(*args, **kw))
        tr.update_camera(orbit_frame(*args, **kw))
        want, jr.state = j_render_frame(jr.arrays, jr.state, CONFIG)
        out.append((jax.tree.map(np.asarray, want), tr.step()))
    return out


@pytest.mark.parametrize("frame", range(FRAMES))
def test_renderer_frame_matches_jax(renderer_frames, frame):
    want, got = renderer_frames[frame]
    np.testing.assert_allclose(got.radiance.numpy(), want.radiance, atol=1e-4)
    for tap in ("temporal", "moments_filtered", "atrous"):
        _assert_close(tap, getattr(got, tap), getattr(want, tap), 1e-4, 2e-2)
    _assert_close("final", got.final, want.final, 1e-4, 5e-3)
    for f in ("disoccluded_pct", "mean_history", "mean_variance", "coverage_pct"):
        np.testing.assert_allclose(float(getattr(got.metrics, f)), float(getattr(want.metrics, f)),
                                   atol=1e-3, err_msg=f)
    assert int(got.metrics.rays_traced) == int(want.metrics.rays_traced)


# ---------------------------------------------------------------------------
# every feature that raised NotImplementedError renders
# ---------------------------------------------------------------------------


def _feature_scene(feature):
    """The port's Cornell box with one feature, and the SceneMeta flag that
    shows it (None: a sampling mode)."""
    scene = cornell_box(aspect=4 / 3)
    walls = scene.shapes[0]
    walls.uvs = np.tile(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32), (3, 1))
    if feature in ("PBR", "GLASS", "VOLUMETRIC", "SUBSURFACE"):
        scene.materials.append(Material(colour=(0.8, 0.8, 0.8), roughness=0.3,
                                        material_type=MaterialType[feature], metallic=0.5,
                                        scattering_colour=(0.5, 0.5, 0.5)))
        scene.instances[4].material = len(scene.materials) - 1
        return scene, lambda m: MaterialType[feature] in m.mat_types_used
    if feature == "environment light":
        scene.env_textures = [environment_texture()]
        scene.environments.append(Environment(emission_texture=0))
        return scene, lambda m: m.n_envs == 1 and -1 in m.light_instance
    if feature in ("textures", "normal maps"):
        scene.textures = [checker_texture()[..., :3], normal_texture()]
        scene.textures_enabled = True
        tex = {"colour_texture": 0} if feature == "textures" else {"normal_texture": 1}
        scene.materials[0] = dataclasses.replace(scene.materials[0], **tex)
        return scene, (lambda m: m.textures_enabled and not m.has_opacity) if feature == "textures" \
            else (lambda m: m.has_normal_maps)
    if feature == "media":
        scene.materials.append(Material(colour=(0.7, 0.8, 0.9), transmission_depth=0.5,
                                        material_type=MaterialType.VOLUMETRIC,
                                        scattering_colour=(0.6, 0.6, 0.6), anisotropy=0.3))
        scene.instances[5].material = len(scene.materials) - 1
        return scene, lambda m: m.has_media
    if feature == "opacity":
        scene.materials[1] = dataclasses.replace(scene.materials[1], opacity=0.5)
        return scene, lambda m: m.has_opacity and not m.has_media
    return scene, None


@pytest.mark.parametrize("feature", [
    "PBR", "GLASS", "VOLUMETRIC", "SUBSURFACE", "environment light", "textures", "normal maps",
    "media", "opacity", "BSDF", "LIGHT", "BOTH",
])
def test_former_unported_feature_renders(feature):
    scene, flag = _feature_scene(feature)
    mode = tconfig.SamplingMode[feature] if flag is None else tconfig.SamplingMode.MIS
    cfg = tconfig.RenderConfig(width=16, height=12, svgf=tconfig.SVGFConfig(spatial_filter_steps=2),
                               tracing=tconfig.TracingConfig(bounces=2, sampling_mode=mode))
    r = Renderer(scene, cfg, device="cpu")
    if flag is not None:
        assert flag(r.arrays.meta), r.arrays.meta
    final = r.step().final.numpy()
    assert final.shape == (12, 16, 3) and np.isfinite(final).all()
    assert 0.0 <= final.min() and final.max() <= 1.0 and final.mean() > 0.02
