"""BSDF library: matte, PBR, glass and volumetric lobes with their delta
variants, sample/eval/pdf (svgf_tpu/ops/bsdf.py; reference
Common.cuh:720-1323).

Every lane evaluates the lobes of the material types its scene uses
(`SceneMeta.mat_types_used`, a host tuple) and the dispatchers select per
lane by material type, in svgf_tpu's order (`_sel_used`), so the same
lanes take the same values; SUBSURFACE shares the GLASS lobes. The delta
dispatchers return zeros for a scene without delta materials. Integer
powers are written as svgf_tpu's integer_pow multiplies them
(`_pow5`), so the Fresnel terms that decide reflect or refract round
alike in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svgf_tpu_torch.ops.geometry import (
    PI, basis_from_z, dot, normalize, reflect, refract, safe_sqrt, sqrt, take_rows,
)
from svgf_tpu_torch.ops.sampling import sample_hemisphere_cosine, sample_hemisphere_cosine_pdf

MATTE, PBR, VOLUMETRIC, GLASS, SUBSURFACE = 0, 1, 2, 3, 4
MIN_ROUGHNESS = 0.03 * 0.03   # Common.cuh:24
IOR = 1.5                     # hard-coded in every dispatcher (Common.cuh:1205 etc.)
ALL_TYPES = (MATTE, PBR, VOLUMETRIC, GLASS, SUBSURFACE)


class MaterialPoint(NamedTuple):
    """EvalMaterial output (Common.cuh:1440-1479): per-lane shading params."""

    mtype: torch.Tensor       # (R,) i32
    colour: torch.Tensor      # (R,3)
    emission: torch.Tensor    # (R,3)
    roughness: torch.Tensor   # (R,) squared + MIN_ROUGHNESS-cut
    metallic: torch.Tensor    # (R,)
    opacity: torch.Tensor     # (R,)
    anisotropy: torch.Tensor  # (R,)
    scattering: torch.Tensor  # (R,3)
    density: torch.Tensor     # (R,3)


def eval_material_point(scene, mat_idx, tex_colour=None, tex_emission=None,
                        tex_roughness=None, tex_alpha=None) -> MaterialPoint:
    """Gather + derive shading params per lane (Common.cuh:1440-1479). The
    texture factors default to 1; the tracer passes them when
    SceneMeta.textures_enabled. `tex_alpha`, the colour texture's alpha,
    folds into opacity (Common.cuh:1458)."""
    m = torch.clamp(mat_idx, 0, scene.mat_type.shape[0] - 1)
    colour = take_rows(scene.mat_colour, m)
    emission = take_rows(scene.mat_emission, m)
    rough = take_rows(scene.mat_roughness, m)
    metal = take_rows(scene.mat_metallic, m)
    opacity = take_rows(scene.mat_opacity, m)
    if tex_colour is not None:
        colour = colour * tex_colour
    if tex_emission is not None:
        emission = emission * tex_emission
    if tex_roughness is not None:
        rough = rough * tex_roughness[..., 1]
        metal = metal * tex_roughness[..., 2]
    if tex_alpha is not None:
        opacity = opacity * tex_alpha
    rough = rough * rough
    mtype = scene.mat_type[m]
    rough = torch.where(mtype == VOLUMETRIC, 0.0, rough)
    rough = torch.where(rough < MIN_ROUGHNESS, 0.0, rough)
    tdepth = scene.mat_transmission_depth[m]
    density = -torch.log(torch.clamp(colour, 1e-4, 1.0)) / torch.clamp_min(tdepth, 1e-9)[..., None]
    has_density = (mtype == VOLUMETRIC) | (mtype == GLASS) | (mtype == SUBSURFACE)
    density = torch.where(has_density[..., None], density, 0.0)
    return MaterialPoint(
        mtype=mtype,
        colour=colour,
        emission=emission,
        roughness=rough,
        metallic=metal,
        opacity=opacity,
        anisotropy=scene.mat_anisotropy[m],
        scattering=scene.mat_scattering[m],
        density=density,
    )


def is_delta(mp: MaterialPoint):
    """(Common.cuh:1189-1195)."""
    r0 = mp.roughness == 0.0
    return ((mp.mtype == PBR) & r0) | ((mp.mtype == GLASS) & r0) | (mp.mtype == VOLUMETRIC)


def is_volumetric(mp: MaterialPoint):
    """(Common.cuh:1485-1491)."""
    return (mp.mtype == VOLUMETRIC) | (mp.mtype == GLASS) | (mp.mtype == SUBSURFACE)


def eval_emission(mp: MaterialPoint, normal, outgoing):
    """(Common.cuh:1481-1483)."""
    return torch.where((dot(normal, outgoing) >= 0)[..., None], mp.emission, 0.0)


# ---------------------------------------------------------------------------
# microfacet helpers (Common.cuh:741-834)
# ---------------------------------------------------------------------------


def _pow5(x):
    """x ** 5 as XLA's integer_pow computes it: x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


def eta_to_reflectivity(eta):
    return ((eta - 1.0) * (eta - 1.0)) / ((eta + 1.0) * (eta + 1.0))


def fresnel_schlick(specular, normal, outgoing):
    cosine = dot(normal, outgoing)
    f = specular + (1.0 - specular) * _pow5(torch.clamp(1.0 - torch.abs(cosine), 0.0, 1.0)[..., None])
    zero = (specular == 0.0).all(-1, keepdim=True)
    return torch.where(zero, 0.0, f)


def fresnel_dielectric(eta, normal, outgoing):
    """(Common.cuh:753-773)."""
    cosw = torch.abs(dot(normal, outgoing))
    sin2 = 1.0 - cosw * cosw
    eta2 = eta * eta
    cos2t = 1.0 - sin2 / eta2
    tir = cos2t < 0.0
    t0 = safe_sqrt(cos2t)  # clamped derivative: TIR lanes would give NaN gradients
    t1 = eta * t0
    t2 = eta * cosw
    rs = (cosw - t1) / (cosw + t1 + 1e-18)
    rp = (t0 - t2) / (t0 + t2 + 1e-18)
    return torch.where(tir, 1.0, (rs * rs + rp * rp) / 2.0)


def sample_microfacet(roughness, normal, rn):
    """GGX-style half-vector sampling (Common.cuh:776-794)."""
    phi = 2.0 * PI * rn[..., 0]
    theta = torch.atan(roughness * sqrt(rn[..., 1] / torch.clamp_min(1.0 - rn[..., 1], 1e-9)))
    st = torch.sin(theta)
    ct = torch.cos(theta)
    local = torch.stack([torch.cos(phi) * st, torch.sin(phi) * st, ct], dim=-1)
    bx, by, bz = basis_from_z(normal)
    return normalize(local[..., 0:1] * bx + local[..., 1:2] * by + local[..., 2:3] * bz)


def microfacet_distribution(roughness, normal, halfway):
    """(Common.cuh:797-805)."""
    cosine = dot(normal, halfway)
    c2 = cosine * cosine
    r2 = roughness * roughness
    d = c2 * r2 + 1.0 - c2
    return torch.where(cosine <= 0, 0.0, r2 / (PI * d * d + 1e-18))


def _shadowing1(roughness, normal, halfway, direction):
    cosine = dot(normal, direction)
    c2 = cosine * cosine
    cosh = dot(halfway, direction)
    r2 = roughness * roughness
    # safe_sqrt: the argument is exactly 0 on r2 == 0, c2 == 0 lanes
    g = 2.0 / (safe_sqrt(((r2 * (1.0 - c2)) + c2) / torch.clamp_min(c2, 1e-18)) + 1.0)
    return torch.where(cosine * cosh <= 0, 0.0, g)


def microfacet_shadowing(roughness, normal, halfway, outgoing, incoming):
    return _shadowing1(roughness, normal, halfway, outgoing) * _shadowing1(
        roughness, normal, halfway, incoming
    )


def sample_microfacet_pdf(roughness, normal, halfway):
    cosine = dot(normal, halfway)
    return torch.where(cosine < 0, 0.0, microfacet_distribution(roughness, normal, halfway) * cosine)


def _up_normal(normal, outgoing):
    return torch.where((dot(normal, outgoing) <= 0)[..., None], -normal, normal)


def _same_hemisphere(normal, outgoing, incoming):
    return dot(normal, outgoing) * dot(normal, incoming) >= 0


# ---------------------------------------------------------------------------
# matte (Common.cuh:919-942)
# ---------------------------------------------------------------------------


def eval_matte(colour, normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    val = colour / PI * torch.abs(dot(normal, incoming))[..., None]
    return torch.where(ok[..., None], val, 0.0)


def sample_matte(normal, outgoing, rn):
    return sample_hemisphere_cosine(_up_normal(normal, outgoing), rn)


def sample_matte_pdf(normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    return torch.where(
        ok, sample_hemisphere_cosine_pdf(_up_normal(normal, outgoing), incoming), 0.0
    )


# ---------------------------------------------------------------------------
# PBR metallic-roughness (Common.cuh:839-916)
# ---------------------------------------------------------------------------


def _reflectivity(colour, metallic):
    base = eta_to_reflectivity(torch.full_like(colour, IOR))
    return base + (colour - base) * metallic[..., None]


def eval_pbr(colour, roughness, metallic, normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    up = _up_normal(normal, outgoing)
    refl = _reflectivity(colour, metallic)
    f1 = fresnel_schlick(refl, up, outgoing)
    halfway = normalize(incoming + outgoing)
    f = fresnel_schlick(refl, halfway, incoming)
    d = microfacet_distribution(roughness, up, halfway)
    g = microfacet_shadowing(roughness, up, halfway, outgoing, incoming)
    cosine = torch.abs(dot(up, incoming))
    # the reference multiplies Diffuse by the cosine TWICE
    # (Common.cuh:876-880) — reproduced
    diffuse = colour * (1.0 - metallic[..., None]) * (1.0 - f1) / PI * cosine[..., None]
    denom = 4.0 * dot(up, outgoing) * dot(up, incoming)
    # double where: grazing lanes never divide by the floor
    bad = torch.abs(denom) < 1e-18
    specular = f * (torch.where(bad, 0.0, d * g) / torch.where(bad, 1.0, denom))[..., None]
    return torch.where(ok[..., None], (diffuse + specular) * cosine[..., None], 0.0)


def sample_pbr(colour, roughness, metallic, normal, outgoing, rnl, rn):
    up = _up_normal(normal, outgoing)
    refl = _reflectivity(colour, metallic)
    f_mean = torch.mean(fresnel_schlick(refl, up, outgoing), dim=-1)
    halfway = sample_microfacet(roughness, up, rn)
    spec_in = reflect(-outgoing, halfway)
    spec_ok = _same_hemisphere(up, outgoing, spec_in)
    diff_in = sample_hemisphere_cosine(up, rn)
    use_spec = rnl < f_mean
    incoming = torch.where(use_spec[..., None], spec_in, diff_in)
    bad = use_spec & ~spec_ok
    return torch.where(bad[..., None], 0.0, incoming)


def sample_pbr_pdf(colour, roughness, metallic, normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    up = _up_normal(normal, outgoing)
    halfway = normalize(outgoing + incoming)
    refl = _reflectivity(colour, metallic)
    f = torch.mean(fresnel_schlick(refl, up, outgoing), dim=-1)
    pdf = f * sample_microfacet_pdf(roughness, up, halfway) / (
        4.0 * torch.clamp_min(torch.abs(dot(outgoing, halfway)), 1e-18)
    ) + (1.0 - f) * sample_hemisphere_cosine_pdf(up, incoming)
    return torch.where(ok, pdf, 0.0)


# delta (mirror) PBR (Common.cuh:854-861, 883-895, 908-916)


def eval_pbr_delta(colour, metallic, normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    up = _up_normal(normal, outgoing)
    refl = _reflectivity(colour, metallic)
    f = fresnel_schlick(refl, up, incoming)
    cosine = torch.abs(dot(up, incoming))
    denom = 4.0 * dot(up, outgoing) * dot(up, incoming)
    bad = torch.abs(denom) < 1e-18
    val = torch.where(bad[..., None], 0.0, f) / torch.where(bad, 1.0, denom)[..., None] * cosine[..., None]
    return torch.where(ok[..., None], val, 0.0)


def sample_pbr_delta(normal, outgoing):
    up = _up_normal(normal, outgoing)
    incoming = reflect(-outgoing, up)
    ok = _same_hemisphere(up, outgoing, incoming)
    return torch.where(ok[..., None], incoming, 0.0)


def sample_pbr_delta_pdf(colour, metallic, normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    up = _up_normal(normal, outgoing)
    halfway = normalize(outgoing + incoming)
    refl = _reflectivity(colour, metallic)
    f = torch.mean(fresnel_schlick(refl, up, outgoing), dim=-1)
    return torch.where(ok, f / (4.0 * torch.clamp_min(torch.abs(dot(outgoing, halfway)), 1e-18)), 0.0)


# ---------------------------------------------------------------------------
# glass, rough + delta (Common.cuh:1016-1139)
# ---------------------------------------------------------------------------


def _glass_frame(normal, outgoing):
    """(entering, up normal, relative IOR) of a glass lane."""
    entering = dot(normal, outgoing) >= 0
    up = torch.where(entering[..., None], normal, -normal)
    return entering, up, torch.where(entering, IOR, 1.0 / IOR)


def _glass_transmission_half(rel_ior, entering, outgoing, incoming):
    return -normalize(rel_ior[..., None] * incoming + outgoing) * torch.where(
        entering, 1.0, -1.0)[..., None]


def eval_glass(roughness, normal, outgoing, incoming):
    entering, up, rel_ior = _glass_frame(normal, outgoing)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0

    # reflection branch
    h_r = normalize(incoming + outgoing)
    f_r = fresnel_dielectric(rel_ior, h_r, outgoing)
    d_r = microfacet_distribution(roughness, up, h_r)
    g_r = microfacet_shadowing(roughness, up, h_r, outgoing, incoming)
    denom_r = torch.abs(4.0 * dot(normal, outgoing) * dot(normal, incoming))
    bad_r = denom_r < 1e-18
    refl = torch.where(bad_r, 0.0, f_r * d_r * g_r) / torch.where(bad_r, 1.0, denom_r) * torch.abs(
        dot(normal, incoming))

    # transmission branch
    h_t = _glass_transmission_half(rel_ior, entering, outgoing, incoming)
    f_t = fresnel_dielectric(rel_ior, h_t, outgoing)
    d_t = microfacet_distribution(roughness, up, h_t)
    g_t = microfacet_shadowing(roughness, up, h_t, outgoing, incoming)
    num = torch.abs(dot(outgoing, h_t) * dot(incoming, h_t))
    den = torch.abs(dot(outgoing, normal) * dot(incoming, normal))
    s = rel_ior * dot(h_t, incoming) + dot(h_t, outgoing)
    den2 = s * s
    bad_t = (den < 1e-18) | (den2 < 1e-18)
    trans = (
        torch.where(bad_t, 0.0, num) / torch.where(bad_t, 1.0, den)
        * (1.0 - f_t) * d_t * g_t
        / torch.where(bad_t, 1.0, den2 + 1e-18)
        * torch.abs(dot(normal, incoming))
    )
    val = torch.where(same, refl, trans)
    return val[..., None].expand(val.shape + (3,))


def sample_glass(roughness, normal, outgoing, rnl, rn):
    entering, up, rel_ior = _glass_frame(normal, outgoing)
    halfway = sample_microfacet(roughness, up, rn)
    f = fresnel_dielectric(rel_ior, halfway, outgoing)
    refl_in = reflect(-outgoing, halfway)
    refl_ok = _same_hemisphere(up, outgoing, refl_in)
    refr_in = refract(-outgoing, halfway, torch.where(entering, 1.0 / IOR, IOR))
    refr_ok = ~_same_hemisphere(up, outgoing, refr_in)
    use_refl = rnl < f
    incoming = torch.where(use_refl[..., None], refl_in, refr_in)
    ok = torch.where(use_refl, refl_ok, refr_ok)
    return torch.where(ok[..., None], incoming, 0.0)


def sample_glass_pdf(roughness, normal, outgoing, incoming):
    entering, up, rel_ior = _glass_frame(normal, outgoing)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0

    h_r = normalize(incoming + outgoing)
    pdf_r = fresnel_dielectric(rel_ior, h_r, outgoing) * sample_microfacet_pdf(
        roughness, up, h_r
    ) / (4.0 * torch.clamp_min(torch.abs(dot(outgoing, h_r)), 1e-18))

    h_t = _glass_transmission_half(rel_ior, entering, outgoing, incoming)
    s = rel_ior * dot(h_t, incoming) + dot(h_t, outgoing)
    den2 = s * s
    bad2 = den2 < 1e-18
    pdf_t = torch.where(
        bad2,
        0.0,
        (1.0 - fresnel_dielectric(rel_ior, h_t, outgoing))
        * sample_microfacet_pdf(roughness, up, h_t)
        * torch.abs(dot(h_t, incoming)),
    ) / torch.where(bad2, 1.0, den2 + 1e-18)
    return torch.where(same, pdf_r, pdf_t)


def eval_glass_delta(normal, outgoing, incoming):
    _, up, rel_ior = _glass_frame(normal, outgoing)
    f = fresnel_dielectric(rel_ior, up, outgoing)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0
    val = torch.where(same, f, (1.0 / (rel_ior * rel_ior)) * (1.0 - f))
    return val[..., None].expand(val.shape + (3,))


def sample_glass_delta(normal, outgoing, rnl):
    _, up, rel_ior = _glass_frame(normal, outgoing)
    f = fresnel_dielectric(rel_ior, up, outgoing)
    refl = reflect(-outgoing, up)
    refr = refract(-outgoing, up, 1.0 / rel_ior)
    return torch.where((rnl < f)[..., None], refl, refr)


def sample_glass_delta_pdf(normal, outgoing, incoming):
    _, up, rel_ior = _glass_frame(normal, outgoing)
    f = fresnel_dielectric(rel_ior, up, outgoing)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0
    return torch.where(same, f, 1.0 - f)


# ---------------------------------------------------------------------------
# volumetric boundary pass-through (Common.cuh:946-975)
# ---------------------------------------------------------------------------


def eval_volumetric(normal, outgoing, incoming):
    opposite = dot(normal, incoming) * dot(normal, outgoing) < 0
    return torch.where(opposite[..., None], 1.0, 0.0) * torch.ones_like(normal)


def sample_volumetric(outgoing):
    return -outgoing


def sample_volumetric_pdf(normal, outgoing, incoming):
    opposite = dot(normal, incoming) * dot(normal, outgoing) < 0
    return torch.where(opposite, 1.0, 0.0)


# ---------------------------------------------------------------------------
# dispatchers (Common.cuh:1197-1323)
# ---------------------------------------------------------------------------


def _sel_used(mtype, lobes, used, vec: bool):
    """Select per material type, evaluating ONLY the lobes whose types occur
    in the (static) scene, in svgf_tpu's order (MATTE, PBR, VOLUMETRIC,
    GLASS; a later type's `where` wins). `lobes` maps type -> thunk;
    SUBSURFACE shares the GLASS lobes."""
    used = set(used)
    if SUBSURFACE in used:
        used.add(GLASS)
        used.discard(SUBSURFACE)
    keys = [t for t in (MATTE, PBR, VOLUMETRIC, GLASS) if t in used] or [MATTE]
    out = lobes[keys[0]]()
    for t in keys[1:]:
        m = mtype == t
        if t == GLASS:
            m = m | (mtype == SUBSURFACE)
        out = torch.where(m[..., None] if vec else m, lobes[t](), out)
    return out


def eval_bsdf_cos(mp: MaterialPoint, normal, outgoing, incoming, types_used=ALL_TYPES):
    return _sel_used(mp.mtype, {
        MATTE: lambda: eval_matte(mp.colour, normal, outgoing, incoming),
        PBR: lambda: eval_pbr(mp.colour, mp.roughness, mp.metallic, normal, outgoing, incoming),
        VOLUMETRIC: lambda: eval_volumetric(normal, outgoing, incoming),
        GLASS: lambda: eval_glass(mp.roughness, normal, outgoing, incoming),
    }, types_used, vec=True)


def sample_bsdf_cos(mp: MaterialPoint, normal, outgoing, rnl, rn, types_used=ALL_TYPES):
    return _sel_used(mp.mtype, {
        MATTE: lambda: sample_matte(normal, outgoing, rn),
        PBR: lambda: sample_pbr(mp.colour, mp.roughness, mp.metallic, normal, outgoing, rnl, rn),
        VOLUMETRIC: lambda: sample_volumetric(outgoing),
        GLASS: lambda: sample_glass(mp.roughness, normal, outgoing, rnl, rn),
    }, types_used, vec=True)


def sample_bsdf_cos_pdf(mp: MaterialPoint, normal, outgoing, incoming, types_used=ALL_TYPES):
    return _sel_used(mp.mtype, {
        MATTE: lambda: sample_matte_pdf(normal, outgoing, incoming),
        PBR: lambda: sample_pbr_pdf(mp.colour, mp.roughness, mp.metallic, normal, outgoing,
                                    incoming),
        VOLUMETRIC: lambda: sample_volumetric_pdf(normal, outgoing, incoming),
        GLASS: lambda: sample_glass_pdf(mp.roughness, normal, outgoing, incoming),
    }, types_used, vec=False)


def _has_delta(types_used) -> bool:
    """Delta lobes exist only for PBR/GLASS/SUBSURFACE/VOLUMETRIC materials
    (is_delta, Common.cuh:1189-1195)."""
    return any(t in types_used for t in (PBR, GLASS, SUBSURFACE, VOLUMETRIC))


def _with_matte(types_used) -> tuple:
    """MATTE stays in a delta dispatch so that matte lanes select zero."""
    return tuple(set(types_used) | {MATTE})


def eval_delta(mp: MaterialPoint, normal, outgoing, incoming, types_used=ALL_TYPES):
    if not _has_delta(types_used):
        return torch.zeros_like(normal)
    val = _sel_used(mp.mtype, {
        MATTE: lambda: torch.zeros_like(normal),
        PBR: lambda: eval_pbr_delta(mp.colour, mp.metallic, normal, outgoing, incoming),
        VOLUMETRIC: lambda: eval_volumetric(normal, outgoing, incoming),
        GLASS: lambda: eval_glass_delta(normal, outgoing, incoming),
    }, _with_matte(types_used), vec=True)
    return torch.where((mp.roughness != 0.0)[..., None], 0.0, val)


def sample_delta(mp: MaterialPoint, normal, outgoing, rnl, types_used=ALL_TYPES):
    if not _has_delta(types_used):
        return torch.zeros_like(normal)
    val = _sel_used(mp.mtype, {
        MATTE: lambda: torch.zeros_like(normal),
        PBR: lambda: sample_pbr_delta(normal, outgoing),
        VOLUMETRIC: lambda: sample_volumetric(outgoing),
        GLASS: lambda: sample_glass_delta(normal, outgoing, rnl),
    }, _with_matte(types_used), vec=True)
    return torch.where((mp.roughness != 0.0)[..., None], 0.0, val)


def sample_delta_pdf(mp: MaterialPoint, normal, outgoing, incoming, types_used=ALL_TYPES):
    if not _has_delta(types_used):
        return torch.zeros_like(normal[..., 0])
    val = _sel_used(mp.mtype, {
        MATTE: lambda: torch.zeros_like(normal[..., 0]),
        PBR: lambda: sample_pbr_delta_pdf(mp.colour, mp.metallic, normal, outgoing, incoming),
        VOLUMETRIC: lambda: sample_volumetric_pdf(normal, outgoing, incoming),
        GLASS: lambda: sample_glass_delta_pdf(normal, outgoing, incoming),
    }, _with_matte(types_used), vec=False)
    return torch.where(mp.roughness != 0.0, 0.0, val)
