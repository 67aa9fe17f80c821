"""Light sampling + environment evaluation (svgf_tpu/ops/lights.py;
reference Common.cuh:348-459, 635-715, 1493-1517).

The static light list is unrolled on the host: each light contributes one
masked block over all lanes. Area (instance) lights and environment
lights, with or without an equirect texture, are sampled and their pdfs
evaluated. `sample_lights_pdf` re-traces each area light with
`only_instance`, as the reference's SampleLightsPDF does; the MIS bounce
reads the pdf from its existing hit (`sample_lights_pdf_from_hit`).
"""

from __future__ import annotations

import torch

from svgf_tpu_torch.ops.geometry import (
    MAX_LENGTH,
    PI,
    dot,
    normalize,
    transform_direction,
    transform_point,
)
from svgf_tpu_torch.ops.intersect import intersect_scene
from svgf_tpu_torch.ops.sampling import (
    sample_discrete,
    sample_discrete_pdf,
    sample_sphere,
    sample_triangle_uv,
    sample_uniform_index,
)


def interp(tri_attr, prim, u, v):
    """Barycentric interpolation a1*u + a2*v + a0*(1-u-v) of per-triangle
    attributes (T, 3, C) at triangles `prim` (svgf_tpu _interp)."""
    a = tri_attr[prim]  # (R, 3, C)
    w0 = (1.0 - u - v)[..., None]
    return a[:, 1] * u[..., None] + a[:, 2] * v[..., None] + a[:, 0] * w0


def eval_environment(scene, direction):
    """Sum of all environments' equirect emission along `direction`
    (Common.cuh:1493-1517). Nearest-texel lookup, no sRGB."""
    R = direction.shape[0]
    total = torch.zeros((R, 3), device=direction.device)
    for e in range(scene.meta.n_envs):
        wd = transform_direction(scene.env_inv_transform[e], direction)
        tex_id = scene.meta.env_tex[e]
        if tex_id >= 0:
            tx = torch.atan2(wd[..., 0], wd[..., 2]) / (2.0 * PI)
            tx = torch.where(tx < 0, tx + 1.0, tx)
            ty = torch.arccos(torch.clamp(wd[..., 1], -1.0, 1.0)) / PI
            h, w = scene.env_textures.shape[1:3]
            px = torch.clamp((tx * w).to(torch.int32), 0, w - 1)
            py = torch.clamp((ty * h).to(torch.int32), 0, h - 1)
            col = scene.env_textures[tex_id][py, px]
        else:
            col = torch.ones((R, 3), device=direction.device)
        total = total + scene.env_emission[e] * col
    return total


def sample_lights(scene, position, rand_l, rand_el, rand_uv):
    """SampleLights (Common.cuh:413-459): direction toward a sampled light,
    or zero when no light can be sampled (the caller breaks the path)."""
    R = position.shape[0]
    meta = scene.meta
    out = torch.zeros((R, 3), device=position.device)
    if meta.n_lights == 0:
        return out
    lid = sample_uniform_index(meta.n_lights, rand_l)
    for l in range(meta.n_lights):
        if meta.light_instance[l] >= 0:
            inst = meta.light_instance[l]
            elem = sample_discrete(
                scene.lights_cdf, meta.light_cdf_start[l], meta.light_cdf_count[l], rand_el
            )
            uv = sample_triangle_uv(rand_uv) if meta.light_cdf_count[l] > 0 else rand_uv
            prim = meta.light_tri_start[l] + elem
            lp = interp(scene.tri_pos, prim, uv[..., 0], uv[..., 1])
            lp = transform_point(scene.inst_transform[inst], lp)
            d = normalize(lp - position)
        else:
            env = meta.light_env[l]
            if meta.env_tex[env] >= 0:
                h, w = scene.env_textures.shape[1:3]
                s = sample_discrete(
                    scene.lights_cdf, meta.light_cdf_start[l], meta.light_cdf_count[l], rand_el
                )
                u = ((s % w).to(torch.float32) + 0.5) / w
                v = (torch.div(s, w, rounding_mode="floor").to(torch.float32) + 0.5) / h
                local = torch.stack([
                    torch.cos(u * 2.0 * PI) * torch.sin(v * PI),
                    torch.cos(v * PI),
                    torch.sin(u * 2.0 * PI) * torch.sin(v * PI),
                ], dim=-1)
                d = transform_direction(scene.env_transform[env], local)
            else:
                d = sample_sphere(rand_uv)
        out = torch.where((lid == l)[..., None], d, out)
    return out


def _instance_light_pdf(scene, l, inst, position, direction, ok, prim, u, v):
    """Solid-angle pdf term of instance light `l` given a hit on it at
    (prim, u, v) along `direction` from `position` (Common.cuh:666-692)."""
    prim = torch.clamp(prim, 0, scene.tri_pos.shape[0] - 1)
    lp = transform_point(scene.inst_transform[inst], interp(scene.tri_pos, prim, u, v))
    # the reference transforms the light normal by Transform, not
    # NormalTransform (Common.cuh:675) — reproduced
    ln = transform_direction(scene.inst_transform[inst], interp(scene.tri_nrm, prim, u, v))
    area = scene.light_area[l]
    d2 = ((lp - position) ** 2).sum(-1)
    denom = torch.abs(dot(ln, direction)) * area + 1e-18
    return torch.where(ok, d2, 0.0) / torch.where(ok, denom, 1.0)


def _env_light_pdf(scene, l, position, direction):
    """Environment light pdf term (Common.cuh:694-713). No tracing needed."""
    meta = scene.meta
    env = meta.light_env[l]
    if meta.env_tex[env] >= 0:
        wd = transform_direction(scene.env_inv_transform[env], direction)
        tx = torch.atan2(wd[..., 2], wd[..., 0]) / (2.0 * PI)
        tx = torch.where(tx < 0, tx + 1.0, tx)
        ty = torch.arccos(torch.clamp(wd[..., 1], -1.0, 1.0)) / PI
        h, w = scene.env_textures.shape[1:3]
        u = torch.clamp((tx * w).to(torch.int32), 0, w - 1)
        v = torch.clamp((ty * h).to(torch.int32), 0, h - 1)
        prob = sample_discrete_pdf(scene.lights_cdf, meta.light_cdf_start[l],
                                   meta.light_cdf_count[l], v * w + u)
        angle = (2.0 * PI / w) * (PI / h) * torch.sin(PI * (v.to(torch.float32) + 0.5) / h)
        return prob / torch.clamp_min(angle, 1e-18)
    return torch.full(position.shape[:-1], 1.0 / (4.0 * PI), device=position.device)


def _lights_pdf(scene, position, direction, light_hit):
    """The light sampler's pdf of `direction` from `position`: the mean of
    each light's term, an area light's from `light_hit(inst)` = (ok, Hit),
    whether and where the ray meets instance `inst`."""
    meta = scene.meta
    pdf = torch.zeros(position.shape[:-1], device=position.device)
    for l in range(meta.n_lights):
        inst = meta.light_instance[l]
        if inst >= 0:
            ok, hit = light_hit(inst)
            pdf = pdf + _instance_light_pdf(
                scene, l, inst, position, direction, ok, hit.prim, hit.u, hit.v
            )
        else:
            pdf = pdf + _env_light_pdf(scene, l, position, direction)
    if meta.n_lights > 0:
        pdf = pdf / meta.n_lights
    return pdf


def sample_lights_pdf_from_hit(scene, position, direction, hit):
    """Light-sampler pdf of `direction`, from the existing full-scene hit
    along that ray: an instance light contributes iff the nearest hit lands
    on it (svgf_tpu's fix of the reference's per-light re-traces,
    PARITY.md); environment terms need no trace."""
    return _lights_pdf(scene, position, direction, lambda inst: (
        (hit.dist < MAX_LENGTH) & (hit.instance == inst), hit))


def sample_lights_pdf(scene, position, direction, intersect_mode: str):
    """SampleLightsPDF (Common.cuh:635-715): the solid-angle pdf of sampling
    `direction` from `position` through the light sampler. Each area light
    re-traces all lanes against that instance alone (`only_instance`, one
    intersect call a light, through the kernel when `intersect_mode`
    resolves to it)."""
    def light_hit(inst):
        hit = intersect_scene(scene, position, direction, intersect_mode, only_instance=inst)
        return hit.dist < MAX_LENGTH, hit

    return _lights_pdf(scene, position, direction, light_hit)
