"""The G-buffer pass and the 1-spp MIS path tracer for matte scenes with
one area light: every bounce intersects the NEE shadow rays and the BSDF
sample rays in one batch, whose hits are the next bounce's. Draws come in
the renderer's call order per bounce (light pick, light element, light
uv x2, BSDF lobe, BSDF uv x2, delta lobe), unused draws included."""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference import rng as R
from portbench.reference.geometry import (
    MAX_LENGTH, dot, normalize, transform_direction, transform_point, transform_vector,
)
from portbench.reference.intersect import Hit


class GBuffer(NamedTuple):
    position: torch.Tensor     # (H, W, 3)
    normal: torch.Tensor       # (H, W, 3)
    motion: torch.Tensor       # (H, W, 2) prev - cur, pixels
    depth: torch.Tensor        # (H, W) 0 = background
    depth_deriv: torch.Tensor  # (H, W)
    uv: torch.Tensor           # (H, W, 2)
    instance: torch.Tensor     # (H, W) i32, -1 = background
    prim: torch.Tensor
    material: torch.Tensor


def interp(attr, prim, u, v):
    a = attr[prim]
    return a[:, 1] * u[..., None] + a[:, 2] * v[..., None] + a[:, 0] * (1.0 - u - v)[..., None]


def camera_rays(frame, proj, h: int, w: int, jitter=None):
    dev = frame.device
    r = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    c = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    jx, jy = (0.0, 0.0) if jitter is None else (jitter[..., 0], jitter[..., 1])
    one = torch.ones((), device=dev)
    u = (c + 0.5 + jx) * (one / w)
    v = 1.0 - (r + 0.5 + jy) * (one / h)
    x = (2.0 * u - 1.0) / proj[0, 0]
    y = (2.0 * v - 1.0) / proj[1, 1]
    d = normalize(torch.stack([x, y, -torch.ones_like(x)], dim=-1))
    rd = transform_vector(frame, d)
    ro = torch.broadcast_to(frame[:3, 3], (h, w, 3))
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


def _project(view, proj, pos, h: int, w: int):
    p = transform_point(view, pos)
    clip = transform_point(proj, p)
    wc = -p[..., 2]
    bad = torch.abs(wc) < 1e-18
    num = torch.where(bad[..., None], 0.0, clip[..., :2])
    ndc = num / torch.where(bad, 1.0, wc)[..., None]
    return (ndc[..., 0] + 1.0) * 0.5 * w, (1.0 - ndc[..., 1]) * 0.5 * h


def gbuffer(rs, frame, prev_frame, h: int, w: int) -> GBuffer:
    view = torch.linalg.inv(frame)
    prev_view = torch.linalg.inv(prev_frame)
    ro, rd = camera_rays(frame, rs.proj, h, w)
    hit = rs.intersect(ro, rd)
    ok = hit.dist < MAX_LENGTH
    prim = torch.clamp(hit.prim, 0, rs.tri_pos.shape[0] - 1)
    inst = torch.clamp(hit.instance, 0, rs.inst_transform.shape[0] - 1)
    pos = transform_point(rs.inst_transform[inst], interp(rs.tri_pos, prim, hit.u, hit.v))
    nrm = normalize(transform_vector(rs.inst_normal[inst], interp(rs.tri_nrm, prim, hit.u, hit.v)))
    dp = pos - frame[:3, 3]
    depth = torch.sqrt((dp * dp).sum(-1))
    cx, cy = _project(view, rs.proj, pos, h, w)
    px, py = _project(prev_view, rs.proj, pos, h, w)
    motion = torch.stack([px - cx, py - cy], dim=-1)
    okf = ok[..., None]
    m1 = torch.full_like(hit.instance, -1)
    z = torch.where(ok, depth, 0.0).reshape(h, w)
    dzx = torch.abs(torch.diff(z, dim=1, append=z[:, -1:]))
    dzy = torch.abs(torch.diff(z, dim=0, append=z[-1:, :]))
    return GBuffer(
        position=torch.where(okf, pos, 0.0).reshape(h, w, 3),
        normal=torch.where(okf, nrm, 0.0).reshape(h, w, 3),
        motion=torch.where(okf, motion, 0.0).reshape(h, w, 2),
        depth=z,
        depth_deriv=torch.where(z > 0.0, torch.maximum(dzx, dzy), 0.0),
        uv=torch.where(okf, torch.stack([hit.u, hit.v], -1), 0.0).reshape(h, w, 2),
        instance=torch.where(ok, hit.instance, m1).reshape(h, w),
        prim=torch.where(ok, hit.prim, m1).reshape(h, w),
        material=torch.where(ok, hit.material, m1).reshape(h, w),
    )


def first_hit(g: GBuffer) -> Hit:
    ok = (g.instance >= 0).reshape(-1)
    zero = torch.zeros_like(g.instance.reshape(-1))
    return Hit(dist=torch.where(ok, g.depth.reshape(-1).float(), MAX_LENGTH),
               u=g.uv[..., 0].reshape(-1).float(), v=g.uv[..., 1].reshape(-1).float(),
               prim=torch.where(ok, g.prim.reshape(-1), zero),
               instance=torch.where(ok, g.instance.reshape(-1), zero),
               material=torch.where(ok, g.material.reshape(-1), zero))


def _offset(position, normal, incoming):
    side = torch.where(dot(normal, incoming) > 0, 1.0, -1.0)
    return position + side[..., None] * normal * 1e-3


def _up(normal, outgoing):
    return torch.where((dot(normal, outgoing) <= 0)[..., None], -normal, normal)


def _matte(colour, normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    return torch.where(ok[..., None], colour / R.PI * torch.abs(dot(normal, incoming))[..., None], 0.0)


def _matte_pdf(normal, outgoing, incoming):
    ok = dot(normal, incoming) * dot(normal, outgoing) > 0
    return torch.where(ok, R.hemisphere_cosine_pdf(_up(normal, outgoing), incoming), 0.0)


def _light_pdf(rs, position, direction, hit: Hit):
    """The light sampler's solid-angle pdf of `direction`, nonzero where the
    ray's nearest hit is the light."""
    ok = (hit.dist < MAX_LENGTH) & (hit.instance == rs.light_inst)
    prim = torch.clamp(hit.prim, 0, rs.tri_pos.shape[0] - 1)
    t = rs.inst_transform[rs.light_inst]
    lp = transform_point(t, interp(rs.tri_pos, prim, hit.u, hit.v))
    ln = transform_direction(t, interp(rs.tri_nrm, prim, hit.u, hit.v))
    d2 = ((lp - position) ** 2).sum(-1)
    denom = torch.abs(dot(ln, direction)) * rs.light_area + 1e-18
    return torch.where(ok, d2, 0.0) / torch.where(ok, denom, 1.0)


def _shading(rs, hit: Hit, outgoing):
    prim = torch.clamp(hit.prim, 0, rs.tri_pos.shape[0] - 1)
    inst = torch.clamp(hit.instance, 0, rs.inst_transform.shape[0] - 1)
    mat = torch.clamp(hit.material, 0, rs.mat_colour.shape[0] - 1)
    pos = transform_point(rs.inst_transform[inst], interp(rs.tri_pos, prim, hit.u, hit.v))
    n = normalize(transform_vector(rs.inst_normal[inst], interp(rs.tri_nrm, prim, hit.u, hit.v)))
    n = torch.where((dot(n, outgoing) < 0)[..., None], -n, n)
    return pos, n, mat


def _bounce(rs, st: dict, hit: Hit, rs_rng: R.Stream):
    Rn = st["ro"].shape[0]
    miss = st["active"] & (hit.dist >= MAX_LENGTH)
    act = st["active"] & ~miss
    outgoing = -st["rd"]
    position, normal, mat = _shading(rs, hit, outgoing)
    colour = rs.mat_colour[mat]
    emission = rs.mat_emission[mat]
    emit = torch.where((dot(normal, outgoing) >= 0)[..., None], emission, 0.0)
    radiance = st["radiance"] + torch.where((act & ~st["use_mis"])[..., None], st["weight"] * emit, 0.0)
    weight = st["weight"]

    # next-event estimation toward the light
    rs_rng.uniform()  # the light pick: one light
    rand_el = rs_rng.uniform()
    ruv = rs_rng.uniform2()
    elem = R.sample_discrete(rs.light_cdf, rs.light_cdf.shape[0], rand_el)
    luv = R.triangle_uv(ruv)
    lp = transform_point(rs.inst_transform[rs.light_inst],
                         interp(rs.tri_pos, rs.light_tri_start + elem, luv[..., 0], luv[..., 1]))
    dir_l = normalize(lp - position)
    l_zero = (dir_l == 0.0).all(-1)
    shifted_l = _offset(position, normal, dir_l)
    bsdf_l = _matte(colour, normal, outgoing, dir_l)
    pre_l = act & ~l_zero & (bsdf_l != 0.0).any(-1)

    # BSDF sample
    rs_rng.uniform()
    dir_b = R.hemisphere_cosine(_up(normal, outgoing), rs_rng.uniform2())
    b_zero = (dir_b == 0.0).all(-1)
    shifted_b = _offset(position, normal, dir_b)
    bsdf_b = _matte(colour, normal, outgoing, dir_b)
    bpdf_b = _matte_pdf(normal, outgoing, dir_b)
    pre_b = act & ~l_zero & ~b_zero & (bpdf_b > 0) & (bsdf_b != 0.0).any(-1)
    trace_b = act & ~l_zero & ~b_zero
    rs_rng.uniform()  # the delta lobe's draw, unused by matte surfaces
    nrays = pre_l.sum() + trace_b.sum()

    broke = b_zero | l_zero
    new_ro = _offset(position, normal, dir_b)
    hits = rs.intersect(torch.cat([shifted_l, shifted_b]), torch.cat([dir_l, dir_b]),
                        torch.cat([pre_l, trace_b]))
    shadow = Hit(*(x[:Rn] for x in hits))
    mis_hit = Hit(*(x[Rn:] for x in hits))

    lpdf_l = _light_pdf(rs, shifted_l, dir_l, shadow)
    bpdf_l = _matte_pdf(normal, outgoing, dir_l)
    safe_l = lpdf_l > 0
    misw_l = torch.where(safe_l, R.power_heuristic(lpdf_l, bpdf_l), 0.0) / torch.where(
        safe_l, torch.clamp_min(lpdf_l, 1e-18), 1.0)
    nee_ok = pre_l & safe_l & (misw_l != 0)
    shadow_miss = shadow.dist >= MAX_LENGTH
    # emission where the shadow ray lands: the surface normal flipped toward the ray
    sp = torch.clamp(shadow.prim, 0, rs.tri_pos.shape[0] - 1)
    si = torch.clamp(shadow.instance, 0, rs.inst_transform.shape[0] - 1)
    sm = torch.clamp(shadow.material, 0, rs.mat_colour.shape[0] - 1)
    sn = normalize(transform_vector(rs.inst_normal[si], interp(rs.tri_nrm, sp, shadow.u, shadow.v)))
    sn = torch.where((dot(sn, -dir_l) < 0)[..., None], -sn, sn)
    emis_hit = torch.where((dot(sn, -dir_l) >= 0)[..., None], rs.mat_emission[sm], 0.0)
    emis = torch.where(shadow_miss[..., None], 0.0, emis_hit)
    radiance = radiance + torch.where(nee_ok[..., None], weight * bsdf_l * emis * misw_l[..., None], 0.0)

    # the BSDF sample's hit supplies its light pdf
    lpdf_b = _light_pdf(rs, shifted_b, dir_b, mis_hit)
    safe_b = bpdf_b > 0
    misw_b = torch.where(safe_b, R.power_heuristic(bpdf_b, lpdf_b), 0.0) / torch.where(
        safe_b, torch.clamp_min(bpdf_b, 1e-18), 1.0)
    mis_cond = pre_b & (misw_b != 0)
    hm = torch.clamp(mis_hit.material, 0, rs.mat_colour.shape[0] - 1)
    emis_b = torch.where((mis_hit.dist >= MAX_LENGTH)[..., None], 0.0, rs.mat_emission[hm])
    radiance = radiance + torch.where(mis_cond[..., None], weight * bsdf_b * emis_b * misw_b[..., None], 0.0)
    w_bsdf = weight * torch.where(safe_b[..., None], bsdf_b, 0.0) / torch.where(
        safe_b, torch.clamp_min(bpdf_b, 1e-18), 1.0)[..., None]
    new_weight = torch.where(mis_cond[..., None], w_bsdf, weight)
    st = dict(
        radiance=radiance,
        weight=torch.where(act[..., None], new_weight, st["weight"]),
        active=act & ~broke,
        use_mis=torch.where(act, mis_cond, st["use_mis"]),
        ro=torch.where(act[..., None], new_ro, st["ro"]),
        rd=torch.where(act[..., None], dir_b, st["rd"]),
    )
    return st, mis_hit, nrays


def pathtrace(rs, ro, rd, k, lane_ids, hit: Hit, bounces: int, clamp: float):
    """One sample a lane from its first hit; returns (radiance (R, 3), rays
    handed to the intersector)."""
    Rn, dev = ro.shape[0], ro.device
    st = dict(radiance=torch.zeros((Rn, 3), device=dev), weight=torch.ones((Rn, 3), device=dev),
              active=torch.ones((Rn,), dtype=torch.bool, device=dev),
              use_mis=torch.zeros((Rn,), dtype=torch.bool, device=dev), ro=ro, rd=rd)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    for b in range(bounces):
        st, hit, nb = _bounce(rs, st, hit, R.Stream(R.fold_in(k, b), lane_ids))
        nrays = nrays + nb
        dead = (st["weight"].amax(-1) <= 0.0) | ~torch.isfinite(st["weight"]).all(-1)
        st["active"] = st["active"] & ~dead
    rad = st["radiance"]
    rad = torch.where(torch.isfinite(rad).all(-1, keepdim=True), rad, 0.0)
    m = rad.amax(-1)
    scale = torch.where(m > clamp, clamp / torch.clamp_min(m, clamp), 1.0)
    return rad * scale[..., None], nrays
