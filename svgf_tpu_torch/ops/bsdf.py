"""BSDF library (svgf_tpu/ops/bsdf.py; reference Common.cuh:720-1323).

Every lane evaluates the lobes of the material types its scene uses
(`SceneMeta.mat_types_used`), selected per lane by material type. Only the
MATTE lobe is ported so far; a scene that uses another type raises in the
dispatchers. The delta dispatchers return zeros for a scene without delta
materials, as in svgf_tpu.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svgf_tpu_torch.ops.geometry import PI, dot
from svgf_tpu_torch.ops.sampling import sample_hemisphere_cosine, sample_hemisphere_cosine_pdf

MATTE, PBR, VOLUMETRIC, GLASS, SUBSURFACE = 0, 1, 2, 3, 4
MIN_ROUGHNESS = 0.03 * 0.03   # Common.cuh:24
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


def eval_material_point(scene, mat_idx) -> MaterialPoint:
    """Gather + derive shading params per lane (Common.cuh:1440-1479), with
    the texture factors at 1 (textures are not ported)."""
    m = torch.clamp(mat_idx, 0, scene.mat_type.shape[0] - 1)
    colour = scene.mat_colour[m]
    rough = scene.mat_roughness[m]
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
        emission=scene.mat_emission[m],
        roughness=rough,
        metallic=scene.mat_metallic[m],
        opacity=scene.mat_opacity[m],
        anisotropy=scene.mat_anisotropy[m],
        scattering=scene.mat_scattering[m],
        density=density,
    )


def is_delta(mp: MaterialPoint):
    """(Common.cuh:1189-1195)."""
    r0 = mp.roughness == 0.0
    return ((mp.mtype == PBR) & r0) | ((mp.mtype == GLASS) & r0) | (mp.mtype == VOLUMETRIC)


def eval_emission(mp: MaterialPoint, normal, outgoing):
    """(Common.cuh:1481-1483)."""
    return torch.where((dot(normal, outgoing) >= 0)[..., None], mp.emission, 0.0)


def _up_normal(normal, outgoing):
    return torch.where((dot(normal, outgoing) <= 0)[..., None], -normal, normal)


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
# dispatchers (Common.cuh:1197-1323)
# ---------------------------------------------------------------------------


def _matte_only(types_used) -> None:
    others = sorted(set(types_used) - {MATTE})
    if others:
        raise NotImplementedError(
            f"material types {others}: only the MATTE lobe is ported to svgf_tpu_torch yet"
        )


def eval_bsdf_cos(mp: MaterialPoint, normal, outgoing, incoming, types_used=ALL_TYPES):
    _matte_only(types_used)
    return eval_matte(mp.colour, normal, outgoing, incoming)


def sample_bsdf_cos(mp: MaterialPoint, normal, outgoing, rnl, rn, types_used=ALL_TYPES):
    _matte_only(types_used)
    return sample_matte(normal, outgoing, rn)


def sample_bsdf_cos_pdf(mp: MaterialPoint, normal, outgoing, incoming, types_used=ALL_TYPES):
    _matte_only(types_used)
    return sample_matte_pdf(normal, outgoing, incoming)


def eval_delta(mp: MaterialPoint, normal, outgoing, incoming, types_used=ALL_TYPES):
    _matte_only(types_used)
    return torch.zeros_like(normal)


def sample_delta(mp: MaterialPoint, normal, outgoing, rnl, types_used=ALL_TYPES):
    _matte_only(types_used)
    return torch.zeros_like(normal)


def sample_delta_pdf(mp: MaterialPoint, normal, outgoing, incoming, types_used=ALL_TYPES):
    _matte_only(types_used)
    return torch.zeros_like(normal[..., 0])
