"""The port's shading library against svgf_tpu's, lobe by lobe, on the CPU.

Each function runs on 4,096 seeded lanes (a NumPy generator) through
svgf_tpu eagerly and through the port, at rtol 1e-5 / atol 1e-6; where
the JAX function only selects, negates or reflects its inputs, the
directions are compared bit for bit. Covered: the PBR lobe (rough and
delta), GLASS (rough and delta), VOLUMETRIC, the dispatchers on lanes of
every type with SUBSURFACE taking the GLASS lobes (`_sel_used`), the
Fresnel and microfacet helpers, `refract` with total internal reflection,
the six transmittance and phase functions of ops/media.py, the texture
functions of ops/texture.py, and the environment branch of
`sample_lights` and its pdf on the materials scene.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgf_tpu.core.scene import Environment as JEnvironment
from svgf_tpu.core.scene import Material as JMaterial
from svgf_tpu.core.scene import MaterialType as JMaterialType
from svgf_tpu.core.textures import build_texture_stack as j_build_texture_stack
from svgf_tpu.ops import bsdf as JB
from svgf_tpu.ops import geometry as JG
from svgf_tpu.ops import lights as JL
from svgf_tpu.ops import media as JM
from svgf_tpu.ops import sampling as JS
from svgf_tpu.ops import texture as JT
from svgf_tpu.scenes import cornell_box as j_cornell
from svgf_tpu_torch import convert
from svgf_tpu_torch.core import textures as TX
from svgf_tpu_torch.ops import bsdf as TB
from svgf_tpu_torch.ops import geometry as TG
from svgf_tpu_torch.ops.intersect import Hit
from svgf_tpu_torch.ops import lights as TL
from svgf_tpu_torch.ops import media as TM
from svgf_tpu_torch.ops import sampling as TS
from svgf_tpu_torch.ops import texture as TT
from svgf_tpu_torch.scenes.materials import checker_texture, dress_cornell, normal_texture

N = 4096
RTOL, ATOL = 1e-5, 1e-6


def _unit(rng, n=N):
    v = rng.standard_normal((n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(11)
    u = lambda *shape: rng.uniform(size=shape).astype(np.float32)
    return {
        "normal": _unit(rng), "outgoing": _unit(rng), "incoming": _unit(rng),
        "colour": u(N, 3), "roughness": (0.5 * u(N)) ** 2, "metallic": u(N),
        "rnl": u(N), "rn": u(N, 2), "rand": u(N),
    }


def _j(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _t(x):
    return torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x


def both(jf, tf, *args):
    """(svgf_tpu's result, the port's) of the same NumPy inputs, as NumPy."""
    return np.asarray(jf(*map(_j, args))), tf(*map(_t, args)).numpy()


def close(jf, tf, *args, exact=False):
    want, got = both(jf, tf, *args)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    return want


# ---------------------------------------------------------------------------
# geometry and sampling helpers
# ---------------------------------------------------------------------------


def test_reflect_and_refract_with_total_internal_reflection(lanes):
    d, n = -lanes["outgoing"], lanes["normal"]
    close(JG.reflect, TG.reflect, d, n, exact=True)
    for eta in (1.5, 1.0 / 1.5, np.where(lanes["rand"] < 0.5, 1.5, 1 / 1.5).astype(np.float32)):
        want = close(JG.refract, TG.refract, d, n, eta)
        tir = (want == 0.0).all(-1)
        if not np.isscalar(eta) or eta > 1.0:
            assert 0.05 < tir.mean() < 0.95, tir.mean()   # both branches taken
        else:
            assert not tir.any()


def test_sampling_and_colour_helpers(lanes):
    close(JS.sample_sphere, TS.sample_sphere, lanes["rn"])
    cdf = np.cumsum(np.random.default_rng(3).uniform(0.1, 2.0, 300)).astype(np.float32)
    idx = np.random.default_rng(4).integers(0, 120, N).astype(np.int32)
    close(lambda c, i: JS.sample_discrete_pdf(c, 100, 120, i),
          lambda c, i: TS.sample_discrete_pdf(c, 100, 120, i), cdf, idx)
    close(JG.from_srgb, TG.from_srgb, lanes["colour"])
    v = np.where(lanes["rand"][:, None] < 0.1, np.float32(np.nan), lanes["colour"])
    close(JG.is_finite3, TG.is_finite3, v.astype(np.float32), exact=True)


def test_fresnel_and_microfacet_helpers(lanes):
    L = lanes
    close(JB.fresnel_schlick, TB.fresnel_schlick, L["colour"], L["normal"], L["outgoing"])
    eta = np.where(L["rand"] < 0.5, 1.5, 1 / 1.5).astype(np.float32)
    close(JB.fresnel_dielectric, TB.fresnel_dielectric, eta, L["normal"], L["outgoing"])
    close(JB.sample_microfacet, TB.sample_microfacet, L["roughness"], L["normal"], L["rn"])
    h = TG.normalize(torch.from_numpy(L["incoming"] + L["outgoing"])).numpy()
    for jf, tf in ((JB.microfacet_distribution, TB.microfacet_distribution),
                   (JB.sample_microfacet_pdf, TB.sample_microfacet_pdf)):
        close(jf, tf, L["roughness"], L["normal"], h)
    close(JB.microfacet_shadowing, TB.microfacet_shadowing, L["roughness"], L["normal"], h,
          L["outgoing"], L["incoming"])


# ---------------------------------------------------------------------------
# the lobes: sample, eval and pdf, at random directions and at their samples
# ---------------------------------------------------------------------------


def _lobe(L, lobe, cv):
    """(eval, sample, pdf) of one lobe over the lobe module B, their
    parameters from the lanes L through the converter cv, and whether its
    sampled direction is bit-exact."""
    rough, glass_rough = cv(L["roughness"]), cv(np.full(N, 0.2 * 0.2, np.float32))
    c, m, rnl, rn = cv(L["colour"]), cv(L["metallic"]), cv(L["rnl"]), cv(L["rn"])
    return {
        "pbr": (lambda B, n, o, i: B.eval_pbr(c, rough, m, n, o, i),
                lambda B, n, o: B.sample_pbr(c, rough, m, n, o, rnl, rn),
                lambda B, n, o, i: B.sample_pbr_pdf(c, rough, m, n, o, i), False),
        "pbr_delta": (lambda B, n, o, i: B.eval_pbr_delta(c, m, n, o, i),
                      lambda B, n, o: B.sample_pbr_delta(n, o),
                      lambda B, n, o, i: B.sample_pbr_delta_pdf(c, m, n, o, i), True),
        "glass": (lambda B, n, o, i: B.eval_glass(glass_rough, n, o, i),
                  lambda B, n, o: B.sample_glass(glass_rough, n, o, rnl, rn),
                  lambda B, n, o, i: B.sample_glass_pdf(glass_rough, n, o, i), False),
        "glass_delta": (lambda B, n, o, i: B.eval_glass_delta(n, o, i),
                        lambda B, n, o: B.sample_glass_delta(n, o, rnl),
                        lambda B, n, o, i: B.sample_glass_delta_pdf(n, o, i), True),
        "volumetric": (lambda B, n, o, i: B.eval_volumetric(n, o, i),
                       lambda B, n, o: B.sample_volumetric(o),
                       lambda B, n, o, i: B.sample_volumetric_pdf(n, o, i), True),
    }[lobe]


@pytest.mark.parametrize("lobe", ["pbr", "pbr_delta", "glass", "glass_delta", "volumetric"])
def test_lobe_matches_jax(lanes, lobe):
    """eval, sample and pdf of one lobe; a lobe whose sampled direction is
    a select, negation or reflection of its inputs gives it bit for bit."""
    L = lanes
    jl, tl = _lobe(L, lobe, _j), _lobe(L, lobe, _t)
    fn = lambda k: ((lambda *a: jl[k](JB, *map(_j, a))), (lambda *a: tl[k](TB, *map(_t, a))))
    n, o = L["normal"], L["outgoing"]
    want_dir = close(*fn(1), n, o, exact=jl[3])
    assert (np.abs(want_dir).sum(-1) > 0).mean() > 0.3
    for i in (L["incoming"], want_dir):
        e = close(*fn(0), n, o, i)
        p = close(*fn(2), n, o, i)
        assert (e != 0).any() and (p != 0).any()


def _material_points(L, seed=5):
    """The same random MaterialPoint for both packages: every type, with
    SUBSURFACE lanes and zero-roughness (delta) lanes."""
    rng = np.random.default_rng(seed)
    mtype = rng.integers(0, 5, N).astype(np.int32)
    rough = np.where(rng.uniform(size=N) < 0.4, 0.0, L["roughness"]).astype(np.float32)
    fields = dict(
        mtype=mtype, colour=L["colour"], emission=np.zeros((N, 3), np.float32),
        roughness=rough, metallic=L["metallic"], opacity=np.ones(N, np.float32),
        anisotropy=np.zeros(N, np.float32), scattering=L["colour"], density=L["colour"],
    )
    jmp = JB.MaterialPoint(**{k: jnp.asarray(v) for k, v in fields.items()})
    tmp = TB.MaterialPoint(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return jmp, tmp


@pytest.mark.parametrize("types", [JB.ALL_TYPES, (0, 1, 2, 3), (0, 4), (3,)])
def test_dispatchers_select_by_type(lanes, types):
    """The six dispatchers with the static type set `types`: the lobes
    evaluated and the where order of svgf_tpu's _sel_used, SUBSURFACE lanes
    on the GLASS lobes, and is_delta / is_volumetric."""
    L = lanes
    jmp, tmp = _material_points(L)
    n, o, i = L["normal"], L["outgoing"], L["incoming"]
    J = lambda f, *a: np.asarray(f(jmp, *map(_j, a), types_used=types))
    T = lambda f, *a: f(tmp, *map(_t, a), types_used=types).numpy()
    d_b = J(JB.sample_bsdf_cos, n, o, L["rnl"], L["rn"])
    np.testing.assert_allclose(T(TB.sample_bsdf_cos, n, o, L["rnl"], L["rn"]), d_b,
                               rtol=RTOL, atol=ATOL)
    d_d = J(JB.sample_delta, n, o, L["rnl"])
    np.testing.assert_array_equal(T(TB.sample_delta, n, o, L["rnl"]), d_d)
    for inc in (i, d_b, d_d):
        for jf, tf in ((JB.eval_bsdf_cos, TB.eval_bsdf_cos),
                       (JB.sample_bsdf_cos_pdf, TB.sample_bsdf_cos_pdf),
                       (JB.eval_delta, TB.eval_delta), (JB.sample_delta_pdf, TB.sample_delta_pdf)):
            np.testing.assert_allclose(T(tf, n, o, inc), J(jf, n, o, inc), rtol=RTOL, atol=ATOL)
    for jf, tf in ((JB.is_delta, TB.is_delta), (JB.is_volumetric, TB.is_volumetric)):
        np.testing.assert_array_equal(tf(tmp).numpy(), np.asarray(jf(jmp)))


# ---------------------------------------------------------------------------
# media
# ---------------------------------------------------------------------------


def test_media_functions_match_jax(lanes):
    L = lanes
    rng = np.random.default_rng(6)
    density = (rng.uniform(0, 3, (N, 3)) * (rng.uniform(size=(N, 1)) < 0.9)).astype(np.float32)
    max_d = rng.uniform(0.01, 4.0, N).astype(np.float32)
    g = np.where(L["rand"] < 0.1, 0.0, rng.uniform(-0.9, 0.9, N)).astype(np.float32)
    dist = close(JM.sample_transmittance, TM.sample_transmittance, density, max_d, L["rnl"],
                 L["rand"])
    assert (dist < max_d).mean() > 0.2 and (dist == max_d).any()
    close(JM.eval_transmittance, TM.eval_transmittance, density, dist)
    close(JM.sample_transmittance_pdf, TM.sample_transmittance_pdf, density, dist, max_d)
    o, i = L["outgoing"], L["incoming"]
    d = close(JM.sample_phase, TM.sample_phase, density, g, o, L["rn"])
    for inc in (i, d):
        close(JM.eval_phase, TM.eval_phase, L["colour"], density, g, o, inc)
        close(JM.sample_phase_pdf, TM.sample_phase_pdf, density, g, o, inc)


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------


def test_texture_stack_matches_jax():
    images = [checker_texture(), normal_texture(), np.random.default_rng(2).uniform(size=(20, 30, 3))]
    np.testing.assert_array_equal(TX.build_texture_stack(images), j_build_texture_stack(images))
    assert TX.texture_alpha_min(images[:1]) == [128 / 255.0]


def test_texture_functions_match_jax(lanes):
    L = lanes
    rng = np.random.default_rng(8)
    stack = TX.build_texture_stack([checker_texture(), normal_texture()])
    uv = rng.uniform(-3.0, 3.0, (N, 2)).astype(np.float32)
    uv[:64] = np.round(uv[:64] * 4) / 4           # texel and tile edges, negatives mirrored
    tex_id = rng.integers(-1, 2, N).astype(np.int32)
    close(JT.to_linear, TT.to_linear, L["colour"], exact=False)
    close(lambda s, i, c: JT.sample_texture(s, i, c), TT.sample_texture, stack, tex_id, uv,
          exact=True)
    for linear in (False, True):
        close(lambda s, i, c: JT.eval_texture(s, i, c, linear),
              lambda s, i, c: TT.eval_texture(s, i, c, linear), stack, tex_id, uv)
    tangent = np.concatenate([_unit(rng), np.where(rng.uniform(size=(N, 1)) < 0.5, -1.0, 1.0)],
                             axis=-1).astype(np.float32)
    m = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    m[:, :3, :3] += rng.uniform(-0.3, 0.3, (N, 3, 3)).astype(np.float32)
    close(lambda *a: JT.apply_normal_map(*a, JG.transform_direction, JG.normalize),
          lambda *a: TT.apply_normal_map(*a, TG.transform_direction, TG.normalize),
          stack, tex_id, uv, L["normal"], tangent, m)


# ---------------------------------------------------------------------------
# the environment light
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def materials_scene():
    os.environ.setdefault("SVGF_NATIVE", "0")
    ja = dress_cornell(j_cornell(), JMaterial, JMaterialType, JEnvironment).flatten()
    return ja, convert.scene_arrays(jax.tree.map(np.asarray, ja), device="cpu")


def test_environment_light_sampling_matches_jax(lanes, materials_scene):
    """sample_lights over the area light and the textured environment, the
    environment's pdf term, sample_lights_pdf_from_hit, and the sampled
    directions' environment radiance; and the untextured environment's
    uniform sphere."""
    ja, ta = materials_scene
    L = lanes
    assert ta.meta.n_lights == 2 and ta.meta.light_env == (-1, 0)
    pos = np.random.default_rng(9).uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    d = close(lambda *a: JL.sample_lights(ja, *a), lambda *a: TL.sample_lights(ta, *a),
              pos, L["rand"], L["rnl"], L["rn"])
    env = TS.sample_uniform_index(2, torch.from_numpy(L["rand"])).numpy() == 1
    assert 0.3 < env.mean() < 0.7
    for direction in (d, L["incoming"]):
        close(lambda p, i: JL._env_light_pdf(ja, 1, p, i),
              lambda p, i: TL._env_light_pdf(ta, 1, p, i), pos, direction)
        close(lambda i: JL.eval_environment(ja, i), lambda i: TL.eval_environment(ta, i), direction)
    # the light pdf from the directions' hits, through the same Hit
    hit = JL.intersect_scene(ja, jnp.asarray(pos), jnp.asarray(d))
    thit = Hit(*(torch.from_numpy(np.array(x)) for x in hit))
    want = np.asarray(JL.sample_lights_pdf_from_hit(ja, jnp.asarray(pos), jnp.asarray(d), hit))
    got = TL.sample_lights_pdf_from_hit(ta, _t(pos), _t(d), thit).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # sample_lights_pdf re-traces the area light with only_instance
    want = np.asarray(JL.sample_lights_pdf(ja, jnp.asarray(pos), jnp.asarray(d)))
    np.testing.assert_allclose(TL.sample_lights_pdf(ta, _t(pos), _t(d), "off").numpy(), want,
                               rtol=RTOL, atol=ATOL)
    # an environment without texture: a uniform sphere and 1 / (4 pi)
    ja2 = dataclasses.replace(ja, meta=dataclasses.replace(ja.meta, env_tex=(-1,)))
    ta2 = dataclasses.replace(ta, meta=dataclasses.replace(ta.meta, env_tex=(-1,)))
    close(lambda *a: JL.sample_lights(ja2, *a), lambda *a: TL.sample_lights(ta2, *a),
          pos, L["rand"], L["rnl"], L["rn"])
    close(lambda p, i: JL._env_light_pdf(ja2, 1, p, i),
          lambda p, i: TL._env_light_pdf(ta2, 1, p, i), pos, L["incoming"])
