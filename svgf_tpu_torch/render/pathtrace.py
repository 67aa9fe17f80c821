"""Wavefront path tracer (svgf_tpu/render/pathtrace.py; reference
src/PathTrace.cuh).

Every bounce is one step over the whole lane batch: all lanes intersect
together, all lanes shade together, termination is a mask. The MIS
estimator (PathTrace.cuh:148-351) batches the NEE shadow ray, the BSDF
sample and, where the scene can produce them, the delta, in-volume and
pass-through continuation rays (a third segment) into one intersect; that
intersect's hits are the next bounce's. The BSDF / LIGHT / BOTH estimators
(PathTrace.cuh:353-556) leave the next bounce to trace for itself.
Participating media (a depth-1 medium stack, transmittance-sampled
scatter events with a 50/50 phase-or-light direction, PathTrace.cuh:187-202,
295-335), opacity pass-through (:219-226), scene textures and normal maps
run where the scene's static flags (`SceneMeta.has_media`, `has_opacity`,
`textures_enabled`, `has_normal_maps`) ask for them. An opacity
pass-through consumes a bounce, as in svgf_tpu. Lanes are masked, never
compacted. Random draws come from the counter-based RngStream in
svgf_tpu's call order, draws that no lane uses included, so each lane
gets the JAX tracer's numbers bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svgf_tpu_torch.config import SamplingMode
from svgf_tpu_torch.ops import bsdf as B
from svgf_tpu_torch.ops import media as M
from svgf_tpu_torch.ops import texture as T
from svgf_tpu_torch.ops.geometry import (
    MAX_LENGTH, dot, normalize, take_rows, transform_direction, transform_point,
    transform_vector,
)
from svgf_tpu_torch.ops.intersect import Hit, intersect_scene
from svgf_tpu_torch.ops.keys import fold_in
from svgf_tpu_torch.ops.lights import (
    eval_environment, interp, sample_lights, sample_lights_pdf, sample_lights_pdf_from_hit,
)
from svgf_tpu_torch.ops.sampling import RngStream, power_heuristic
from svgf_tpu_torch.render import spans
from svgf_tpu_torch.render.gbuffer import pad_rows


class _Shade(NamedTuple):
    position: torch.Tensor  # (R,3) world shading position
    normal: torch.Tensor    # (R,3) shading normal, flipped toward outgoing (glass keeps it)
    mp: B.MaterialPoint


def _shading_point(scene, hit: Hit, outgoing) -> _Shade:
    """Geometry + material evaluation at a hit (Common.cuh:1422-1479). With
    SceneMeta.textures_enabled the material's texture slots are sampled at
    the interpolated UV and folded in as EvalMaterial does (colour and
    emission sRGB->linear, roughness.y / metallic.z, colour alpha into
    opacity), and the normal map applies through the tangent frame."""
    prim = torch.clamp(hit.prim, 0, scene.tri_pos.shape[0] - 1)
    inst = torch.clamp(hit.instance, 0, scene.inst_shape.shape[0] - 1)
    mat = torch.clamp(hit.material, 0, scene.mat_type.shape[0] - 1)
    m_n = scene.inst_normal_transform[inst]
    pos = transform_point(scene.inst_transform[inst], interp(scene.tri_pos, prim, hit.u, hit.v))
    n = normalize(transform_vector(m_n, interp(scene.tri_nrm, prim, hit.u, hit.v)))
    if scene.meta.textures_enabled:
        uv = interp(scene.tri_uv, prim, hit.u, hit.v)
        tex_col = T.eval_texture(scene.textures, scene.mat_colour_tex[mat], uv, linear=True)
        tex_emi = T.eval_texture(scene.textures, scene.mat_emission_tex[mat], uv, linear=True)[..., :3]
        tex_rgh = T.eval_texture(scene.textures, scene.mat_roughness_tex[mat], uv, linear=False)
        mp = B.eval_material_point(scene, mat, tex_colour=tex_col[..., :3], tex_emission=tex_emi,
                                   tex_roughness=tex_rgh, tex_alpha=tex_col[..., 3])
        if scene.meta.has_normal_maps:
            tan = interp(scene.tri_tan, prim, hit.u, hit.v)
            n = T.apply_normal_map(scene.textures, scene.mat_normal_tex[mat], uv, n, tan, m_n,
                                   transform_direction, normalize)
    else:
        mp = B.eval_material_point(scene, mat)
    # EvalShadingNormal (Common.cuh:1433-1438): glass keeps the normal,
    # everything else flips it toward the outgoing direction
    flip = (dot(n, outgoing) < 0) & (mp.mtype != B.GLASS)
    n = torch.where(flip[..., None], -n, n)
    return _Shade(position=pos, normal=n, mp=mp)


def _emission_at_hit(scene, hit: Hit, outgoing):
    """EvalEmission at a secondary hit (NEE branch, PathTrace.cuh:253-256):
    without textures only the shading normal and the material's emission
    matter; with them the whole shading point."""
    if scene.meta.textures_enabled:
        sh = _shading_point(scene, hit, outgoing)
        return B.eval_emission(sh.mp, sh.normal, outgoing)
    prim = torch.clamp(hit.prim, 0, scene.tri_pos.shape[0] - 1)
    inst = torch.clamp(hit.instance, 0, scene.inst_shape.shape[0] - 1)
    mat = torch.clamp(hit.material, 0, scene.mat_type.shape[0] - 1)
    n = normalize(transform_vector(scene.inst_normal_transform[inst],
                                   interp(scene.tri_nrm, prim, hit.u, hit.v)))
    flip = (dot(n, outgoing) < 0) & (scene.mat_type[mat] != B.GLASS)
    n = torch.where(flip[..., None], -n, n)
    return torch.where((dot(n, outgoing) >= 0)[..., None], take_rows(scene.mat_emission, mat), 0.0)


def _offset_origin(position, normal, incoming):
    """Ray origin shift (PathTrace.cuh:240, 304)."""
    side = torch.where(dot(normal, incoming) > 0, 1.0, -1.0)
    return position + side[..., None] * normal * 1e-3


class PathState(NamedTuple):
    radiance: torch.Tensor  # (R,3)
    weight: torch.Tensor    # (R,3)
    active: torch.Tensor    # (R,) bool
    use_mis: torch.Tensor   # (R,) bool
    ro: torch.Tensor        # (R,3)
    rd: torch.Tensor        # (R,3)
    # the medium stack, depth 1 like the reference's single VolumeMaterial
    # (PathTrace.cuh:158-159); untouched unless meta.has_media
    in_volume: torch.Tensor       # (R,) bool
    vol_density: torch.Tensor     # (R,3)
    vol_scattering: torch.Tensor  # (R,3)
    vol_anisotropy: torch.Tensor  # (R,)


def _sample_medium(state: PathState, hit: Hit, rng: RngStream):
    """Transmittance-sample a scatter distance for in-volume lanes
    (PathTrace.cuh:187-202). Returns (state, stay_in_volume, distance). The
    distance is a sample: gradients treat it as a constant."""
    in_vol = state.active & state.in_volume
    dist = M.sample_transmittance(state.vol_density, hit.dist, rng.uniform(), rng.uniform()).detach()
    w = M.eval_transmittance(state.vol_density, dist) / torch.clamp_min(
        M.sample_transmittance_pdf(state.vol_density, dist, hit.dist), 1e-18)[..., None]
    weight = torch.where(in_vol[..., None], state.weight * w, state.weight)
    stay = in_vol & (dist < hit.dist)
    return state._replace(weight=weight), stay, dist


def _volume_scatter(scene, state: PathState, dist, rng: RngStream, intersect_mode: str):
    """In-volume scatter event (PathTrace.cuh:308-335): 50/50 phase
    function or light direction, weighted by the mixed pdf, whose light
    half re-traces every area light over all lanes (sample_lights_pdf).
    Returns (position, incoming, weight multiplier, broke)."""
    pos = state.ro + state.rd * dist[..., None]
    outgoing = -state.rd
    use_phase = rng.uniform() > 0.5
    rng.uniform()  # the reference's unused RNL draw (Common.cuh:1145)
    dir_p = M.sample_phase(state.vol_density, state.vol_anisotropy, outgoing, rng.uniform2())
    rand_l, rand_el = rng.uniform(), rng.uniform()
    dir_l = sample_lights(scene, pos, rand_l, rand_el, rng.uniform2())
    incoming = torch.where(use_phase[..., None], dir_p, dir_l)
    broke = (incoming == 0.0).all(-1)
    ppdf = M.sample_phase_pdf(state.vol_density, state.vol_anisotropy, outgoing, incoming)
    lpdf = sample_lights_pdf(scene, pos, incoming, intersect_mode)
    w = M.eval_phase(state.vol_scattering, state.vol_density, state.vol_anisotropy, outgoing,
                     incoming) / torch.clamp_min(0.5 * ppdf + 0.5 * lpdf, 1e-18)[..., None]
    return pos, incoming, w, broke


# Optional measurement probe (svgf_tpu/render/pathtrace.py:231-240): when it
# is a list, pathtrace appends each bounce's active mask after Russian
# roulette and the dead-lane update, one (R,) bool tensor a bounce, the
# data of scripts/measure_balance.py. None in production, where it costs
# one `is not None` test a bounce. pathtrace_chunked appends chunk by chunk
# (each chunk's bounces in turn, masks of the chunk's lanes).
_ACTIVE_PROBE: list | None = None


def set_active_probe(lst) -> None:
    global _ACTIVE_PROBE
    _ACTIVE_PROBE = lst


def pathtrace(scene, ro, rd, key, lane_ids, bounces: int = 3, clamp: float = 10.0,
              mode: SamplingMode = SamplingMode.MIS, first_hit: Hit | None = None,
              intersect_mode: str = "off", events: dict | None = None):
    """Trace one sample per lane. `key` is the host threefry key of this
    sample (ops.keys); `lane_ids` are the lanes' global ids, which the
    random draws hash. Returns (radiance (R,3), rays_traced): rays_traced
    counts the active lanes of every intersect, and all lanes of each
    `only_instance` re-trace. (svgf_tpu also returns the first hit's
    shading normal, which no caller reads.) `events`: each bounce's parts'
    marks (render.spans)."""
    R = ro.shape[0]
    dev = ro.device
    state = PathState(
        radiance=torch.zeros((R, 3), device=dev),
        weight=torch.ones((R, 3), device=dev),
        active=torch.ones((R,), dtype=torch.bool, device=dev),
        use_mis=torch.zeros((R,), dtype=torch.bool, device=dev),
        ro=ro,
        rd=rd,
        in_volume=torch.zeros((R,), dtype=torch.bool, device=dev),
        vol_density=torch.zeros((R, 3), device=dev),
        vol_scattering=torch.zeros((R, 3), device=dev),
        vol_anisotropy=torch.zeros((R,), device=dev),
    )
    nrays = torch.zeros((), dtype=torch.int64, device=dev)

    if first_hit is not None:
        hit = first_hit
    else:
        hit = intersect_scene(scene, ro, rd, intersect_mode)
        nrays = nrays + R
        spans.mark(events, "trace.primary")
    for b in range(bounces):
        rng = RngStream(fold_in(key, b), lane_ids)
        if mode == SamplingMode.MIS:
            state, next_hit, nb = _bounce_mis(scene, state, hit, rng, intersect_mode, events, b)
        else:
            state, next_hit, nb = _bounce_simple(scene, state, hit, rng, mode, intersect_mode,
                                                 events, b)
        nrays = nrays + nb
        # Russian roulette after bounce 3 (PathTrace.cuh:340-345)
        if b > 3:
            rr = torch.clamp_max(state.weight.amax(-1), 0.99)
            kill = rng.uniform() >= rr
            survive = state.active & ~kill
            state = state._replace(
                active=survive,
                weight=torch.where(
                    survive[..., None],
                    state.weight / torch.clamp_min(rr, 1e-6)[..., None],
                    state.weight,
                ),
            )
        dead = (state.weight.amax(-1) <= 0.0) | ~torch.isfinite(state.weight).all(-1)
        state = state._replace(active=state.active & ~dead)
        if _ACTIVE_PROBE is not None:
            # a fresh tensor each bounce, which no later op writes into
            _ACTIVE_PROBE.append(state.active)
        spans.mark(events, f"trace.b{b}.cull")
        if b + 1 < bounces:
            if next_hit is not None:
                # the MIS bounce traced every active lane's next ray already
                hit = next_hit
            else:
                # a simple-mode bounce leaves the next bounce to trace for itself
                hit = intersect_scene(scene, state.ro, state.rd, intersect_mode,
                                      active=state.active)
                nrays = nrays + state.active.sum()
                spans.mark(events, f"trace.b{b}.intersect")

    radiance = state.radiance
    radiance = torch.where(torch.isfinite(radiance).all(-1, keepdim=True), radiance, 0.0)
    m = radiance.amax(-1)
    scale = torch.where(m > clamp, clamp / torch.clamp_min(m, clamp), 1.0)
    return radiance * scale[..., None], nrays


BLOCK_H, BLOCK_W = 64, 64  # 4,096-pixel blocks of the large-scene lane order


def make_block_order(h: int, w: int, bh: int = BLOCK_H, bw: int = BLOCK_W):
    """Lane reorder: row-major (h*w, ...) <-> (bh x bw)-pixel-block-major
    (svgf_tpu/render/pathtrace.py:354-385).

    A run of row-major lanes spans whole image rows, so its rays fan out
    over the whole scene; block-major lanes give each run of 4,096 lanes a
    compact pixel-block frustum, so the threads of a warp of the scene-BVH
    kernel walk nearly the same nodes. Edge-padded to block multiples:
    padded lanes trace duplicate edge pixels and `inv` crops them.
    Returns (fwd, inv, padded_lane_count)."""
    hp = -(-h // bh) * bh
    wp = -(-w // bw) * bw

    def fwd(x):
        ch = tuple(x.shape[1:])
        x2 = x.reshape((h, w) + ch)
        if hp > h:
            x2 = torch.cat([x2, x2[-1:].expand((hp - h, w) + ch)])
        if wp > w:
            x2 = torch.cat([x2, x2[:, -1:].expand((hp, wp - w) + ch)], dim=1)
        x2 = x2.reshape((hp // bh, bh, wp // bw, bw) + ch)
        return x2.transpose(1, 2).reshape((hp * wp,) + ch)

    def inv(y):
        ch = tuple(y.shape[1:])
        y2 = y.reshape((hp // bh, wp // bw, bh, bw) + ch).transpose(1, 2).reshape((hp, wp) + ch)
        return y2[:h, :w].reshape((h * w,) + ch)

    return fwd, inv, hp * wp


def pathtrace_chunked(scene, ro, rd, key, bounces: int = 3, clamp: float = 10.0,
                      mode: SamplingMode = SamplingMode.MIS, first_hit: Hit | None = None,
                      num_chunks: int = 1, intersect_mode: str = "off", lane_ids=None,
                      block_hw=None, checkpoint: bool = False, events: dict | None = None):
    """Run the wavefront in `num_chunks` sequential lane chunks: peak memory
    scales with the live lane count. Lanes keep their global ids, so the
    result equals the unchunked one. Padding lanes repeat the last ray and
    count in rays_traced, as in svgf_tpu. The active probe
    (`set_active_probe`) receives chunk 0's masks of every bounce, then
    chunk 1's, and so on, each over its chunk's lanes, padding included.

    checkpoint: each chunk runs under torch.utils.checkpoint, so autograd
    keeps a chunk's inputs and traces it again in the backward pass (the
    same draws: they hash the lane ids) instead of keeping its graph.

    block_hw=(h, w): the lanes are an (h, w) image in row-major order; they
    are traced in 64x64 pixel blocks (make_block_order) and returned in
    row-major order. The random draws hash the pixel ids, so per-pixel
    results do not change; the edge-padding lanes trace and count.

    events: each chunk's bounce marks (render.spans); none under
    `checkpoint`, whose recompute would mark twice."""
    R = ro.shape[0]
    if lane_ids is None:
        lane_ids = torch.arange(R, dtype=torch.int64, device=ro.device)
    if block_hw is not None:
        bh, bw = block_hw
        assert bh * bw == R, (block_hw, R)
        fwd, inv, _ = make_block_order(bh, bw)
        rad, nrays = pathtrace_chunked(
            scene, fwd(ro), fwd(rd), key, bounces, clamp, mode,
            None if first_hit is None else Hit(*map(fwd, first_hit)),
            num_chunks, intersect_mode, lane_ids=fwd(lane_ids), checkpoint=checkpoint,
            events=events,
        )
        return inv(rad), nrays
    num_chunks = max(num_chunks, 1)
    rc = -(-R // num_chunks)
    pad = rc * num_chunks - R
    ro, rd, lane_ids = pad_rows(ro, pad), pad_rows(rd, pad), pad_rows(lane_ids, pad)
    if first_hit is not None:
        first_hit = Hit(*(pad_rows(x, pad) for x in first_hit))
    rads, nrays = [], 0
    for k in range(num_chunks):
        s = slice(k * rc, (k + 1) * rc)
        run = lambda s=s: pathtrace(
            scene, ro[s], rd[s], key, lane_ids[s], bounces, clamp, mode,
            None if first_hit is None else first_hit.chunk(s.start, s.stop),
            intersect_mode, None if checkpoint else events,
        )
        rad, nr = torch.utils.checkpoint.checkpoint(run, use_reentrant=False) if checkpoint \
            else run()
        rads.append(rad)
        nrays = nrays + nr
    return torch.cat(rads)[:R], nrays


def _handle_miss(scene, state: PathState, hit: Hit):
    miss = state.active & (hit.dist >= MAX_LENGTH)
    radiance = state.radiance
    if scene.meta.n_envs > 0:
        env = eval_environment(scene, state.rd)
        radiance = radiance + torch.where(miss[..., None], state.weight * env, 0.0)
    return state._replace(radiance=radiance, active=state.active & ~miss)


def _surface_events(scene, state: PathState, hit: Hit, rng: RngStream):
    """What both estimators do first: the miss, the medium event (draws 1-2
    with media), the shading point and the opacity pass-through (one draw
    with opacity). Returns (state, act, stay, vol_dist, passthrough, shade,
    outgoing, the _Shade)."""
    R = state.ro.shape[0]
    state = _handle_miss(scene, state, hit)
    act = state.active
    no = torch.zeros((R,), dtype=torch.bool, device=act.device)
    if scene.meta.has_media:
        # in-volume lanes may scatter before they reach the surface
        state, stay, vol_dist = _sample_medium(state, hit, rng)
    else:
        stay, vol_dist = no, hit.dist
    surf = act & ~stay
    outgoing = -state.rd
    sh = _shading_point(scene, hit, outgoing)
    if scene.meta.has_opacity:
        # opacity pass-through (PathTrace.cuh:219-226)
        passthrough = surf & (sh.mp.opacity < 1.0) & (rng.uniform() >= sh.mp.opacity)
    else:
        passthrough = no
    return state, act, stay, vol_dist, passthrough, surf & ~passthrough, outgoing, sh


def _enter_volume(scene, state: PathState, mp, normal, outgoing, incoming, shade, broke):
    """The medium-stack toggle on transmissive crossings
    (PathTrace.cuh:295-302). Returns (in_volume, density, scattering,
    anisotropy)."""
    enter = (shade & ~broke & B.is_volumetric(mp)
             & (dot(normal, outgoing) * dot(normal, incoming) < 0))
    return (torch.where(enter, ~state.in_volume, state.in_volume),
            torch.where(enter[..., None], mp.density, state.vol_density),
            torch.where(enter[..., None], mp.scattering, state.vol_scattering),
            torch.where(enter, mp.anisotropy, state.vol_anisotropy))


def _bounce_mis(scene, state: PathState, hit: Hit, rng: RngStream, intersect_mode: str,
                events: dict | None = None, b: int = 0):
    """One MIS bounce (PathTrace.cuh:148-351), bounce `b` in its parts'
    marks. Returns (state, next_hit, rays_traced)."""
    R = state.ro.shape[0]
    meta = scene.meta
    types = meta.mat_types_used
    state, act, stay, vol_dist, passthrough, shade, outgoing, sh = _surface_events(
        scene, state, hit, rng)
    mp, normal, position = sh.mp, sh.normal, sh.position

    # emission (only when the MIS bsdf branch didn't already account for it)
    emit = B.eval_emission(mp, normal, outgoing)
    add_emit = shade & ~state.use_mis
    radiance = state.radiance + torch.where(add_emit[..., None], state.weight * emit, 0.0)
    spans.mark(events, f"trace.b{b}.surface")

    delta = B.is_delta(mp)
    weight = state.weight

    # NEE direction (PathTrace.cuh:238-260); its hit gives the light pdf
    rand_l, rand_el = rng.uniform(), rng.uniform()
    dir_l = sample_lights(scene, position, rand_l, rand_el, rng.uniform2())
    l_zero = (dir_l == 0.0).all(-1)
    shifted_l = _offset_origin(position, normal, dir_l)
    bsdf_l = B.eval_bsdf_cos(mp, normal, outgoing, dir_l, types)
    pre_l = shade & ~delta & ~l_zero & (bsdf_l != 0.0).any(-1)
    nrays = pre_l.sum()

    # BSDF-sample direction (PathTrace.cuh:261-268)
    rnl = rng.uniform()
    dir_b = B.sample_bsdf_cos(mp, normal, outgoing, rnl, rng.uniform2(), types)
    b_zero = (dir_b == 0.0).all(-1)
    shifted_b = _offset_origin(position, normal, dir_b)
    bsdf_b = B.eval_bsdf_cos(mp, normal, outgoing, dir_b, types)
    bpdf_b = B.sample_bsdf_cos_pdf(mp, normal, outgoing, dir_b, types)
    pre_b = shade & ~delta & ~l_zero & ~b_zero & (bpdf_b > 0) & (bsdf_b != 0.0).any(-1)
    # the next bounce flies dir_b for every continuing non-delta lane, so
    # the traced set is trace_b and its hit is the next bounce's hit
    trace_b = shade & ~delta & ~l_zero & ~b_zero
    nrays = nrays + trace_b.sum()

    # delta branch (PathTrace.cuh:286-292); its draw is taken even in an
    # all-matte scene to keep svgf_tpu's draw order
    dir_d = B.sample_delta(mp, normal, outgoing, rng.uniform(), types)
    pdf_d = B.sample_delta_pdf(mp, normal, outgoing, dir_d, types)
    w_delta = weight * B.eval_delta(mp, normal, outgoing, dir_d, types) / torch.clamp_min(pdf_d, 1e-18)[..., None]
    d_zero = (dir_d == 0.0).all(-1)

    incoming = torch.where(delta[..., None], dir_d, dir_b)
    # lanes break when their sampled direction is zero (:241,:264)
    broke = torch.where(delta, d_zero, b_zero | l_zero)
    new_ro = _offset_origin(position, normal, incoming)

    in_volume, vol_density, vol_scattering, vol_anisotropy = (
        state.in_volume, state.vol_density, state.vol_scattering, state.vol_anisotropy)
    if meta.has_media:
        in_volume, vol_density, vol_scattering, vol_anisotropy = _enter_volume(
            scene, state, mp, normal, outgoing, incoming, shade, broke)
        # the in-volume scatter event replaces the surface interaction; its
        # light pdf re-traces every area light over all R lanes
        vpos, vdir, vw, vbroke = _volume_scatter(scene, state, vol_dist, rng, intersect_mode)
        nrays = nrays + n_area_lights(meta) * R
        incoming = torch.where(stay[..., None], vdir, incoming)
        new_ro = torch.where(stay[..., None], vpos, new_ro)
        broke = torch.where(stay, vbroke, broke)
    if meta.has_opacity:
        # pass through the surface, direction unchanged (PathTrace.cuh:222-226)
        incoming = torch.where(passthrough[..., None], state.rd, incoming)
        new_ro = torch.where(passthrough[..., None], position + state.rd * 1e-2, new_ro)
        broke = torch.where(passthrough, False, broke)

    spans.mark(events, f"trace.b{b}.sample")

    # ONE batched intersect: [NEE shadow | bsdf sample | other next rays].
    # The third segment exists only for scenes that can make delta,
    # in-volume or pass-through continuation rays (static meta flags).
    seg3 = None
    ros, rds, actives = [shifted_l, shifted_b], [dir_l, dir_b], [pre_l, trace_b]
    if _needs_seg3(meta):
        seg3 = act & ~broke & (delta | stay | passthrough)
        nrays = nrays + seg3.sum()
        ros, rds, actives = ros + [new_ro], rds + [incoming], actives + [seg3]
    hitN = intersect_scene(scene, torch.cat(ros), torch.cat(rds), intersect_mode,
                           active=torch.cat(actives))
    spans.mark(events, f"trace.b{b}.intersect")
    shadow = hitN.chunk(0, R)
    mis_hit = hitN.chunk(R, 2 * R)

    lpdf_l = sample_lights_pdf_from_hit(scene, shifted_l, dir_l, shadow)
    bpdf_l = B.sample_bsdf_cos_pdf(mp, normal, outgoing, dir_l, types)
    safe_l = lpdf_l > 0
    misw_l = torch.where(safe_l, power_heuristic(lpdf_l, bpdf_l), 0.0) / torch.where(
        safe_l, torch.clamp_min(lpdf_l, 1e-18), 1.0
    )
    nee_ok = pre_l & safe_l & (misw_l != 0)
    shadow_miss = shadow.dist >= MAX_LENGTH
    if meta.n_envs > 0:
        emis_miss = eval_environment(scene, dir_l)
    else:
        emis_miss = torch.zeros((R, 3), device=position.device)
    emis_hit = _emission_at_hit(scene, shadow, -dir_l)
    emis = torch.where(shadow_miss[..., None], emis_miss, emis_hit)
    radiance = radiance + torch.where(
        nee_ok[..., None], weight * bsdf_l * emis * misw_l[..., None], 0.0
    )

    # BSDF-sample branch (PathTrace.cuh:261-284): the MIS hit supplies the
    # light pdf of dir_b
    lpdf_b = sample_lights_pdf_from_hit(scene, shifted_b, dir_b, mis_hit)
    safe_b = bpdf_b > 0
    misw_b = torch.where(safe_b, power_heuristic(bpdf_b, lpdf_b), 0.0) / torch.where(
        safe_b, torch.clamp_min(bpdf_b, 1e-18), 1.0
    )
    mis_cond = pre_b & (misw_b != 0)
    mis_miss = mis_hit.dist >= MAX_LENGTH
    if meta.n_envs > 0:
        emis_b = torch.where(mis_miss[..., None], eval_environment(scene, dir_b), 0.0)
    else:
        emis_b = torch.zeros((R, 3), device=position.device)
    # raw Material.Emission at the hit — no orientation test (:276)
    hm = torch.clamp(mis_hit.material, 0, scene.mat_type.shape[0] - 1)
    emis_b = torch.where(mis_miss[..., None], emis_b, take_rows(scene.mat_emission, hm))
    radiance = radiance + torch.where(
        mis_cond[..., None], weight * bsdf_b * emis_b * misw_b[..., None], 0.0
    )
    w_bsdf = weight * torch.where(safe_b[..., None], bsdf_b, 0.0) / torch.where(
        safe_b, torch.clamp_min(bpdf_b, 1e-18), 1.0
    )[..., None]

    new_weight = torch.where(
        delta[..., None], w_delta, torch.where(mis_cond[..., None], w_bsdf, weight)
    )
    use_mis = torch.where(delta, False, mis_cond)
    if meta.has_media:
        new_weight = torch.where(stay[..., None], state.weight * vw, new_weight)
        use_mis = torch.where(stay, False, use_mis)
    if meta.has_opacity:
        new_weight = torch.where(passthrough[..., None], state.weight, new_weight)
        use_mis = torch.where(passthrough, False, use_mis)

    new_state = PathState(
        radiance=radiance,
        weight=torch.where(act[..., None], new_weight, state.weight),
        active=act & ~broke,
        use_mis=torch.where(act, use_mis, state.use_mis),
        ro=torch.where(act[..., None], new_ro, state.ro),
        rd=torch.where(act[..., None], incoming, state.rd),
        in_volume=torch.where(act, in_volume, state.in_volume),
        vol_density=vol_density,
        vol_scattering=vol_scattering,
        vol_anisotropy=vol_anisotropy,
    )
    # every active lane's next hit is traced: dir_b lanes reuse the MIS
    # segment (the identical ray), delta, in-volume and pass-through lanes
    # take segment 3
    next_hit = mis_hit
    if seg3 is not None:
        m3 = delta | stay | passthrough
        next_hit = Hit(*(torch.where(m3, x, y) for x, y in zip(hitN.chunk(2 * R, 3 * R), mis_hit)))
    spans.mark(events, f"trace.b{b}.mis")
    return new_state, next_hit, nrays


def _needs_seg3(meta) -> bool:
    """Whether a MIS bounce's batched intersect carries the third segment:
    the scene can make delta, in-volume or pass-through continuation rays."""
    return (meta.has_media or meta.has_opacity
            or any(t in meta.mat_types_used for t in (B.PBR, B.GLASS, B.VOLUMETRIC)))


def n_area_lights(meta) -> int:
    """Static count of a scene's instance (area) lights: each costs one
    only_instance re-trace inside sample_lights_pdf (Common.cuh:635-715)."""
    return sum(1 for inst in meta.light_instance if inst >= 0)


def _bounce_simple(scene, state: PathState, hit: Hit, rng: RngStream, mode: SamplingMode,
                   intersect_mode: str, events: dict | None = None, b: int = 0):
    """BSDF / LIGHT / BOTH estimators (PathTrace.cuh:353-556), with the same
    media (:396-411, :504-540) and opacity (:430-437) handling as MIS,
    bounce `b` in its parts' marks (its sample part holds the light pdf's
    re-trace). Returns (state, None: the next bounce traces for itself,
    rays_traced)."""
    R = state.ro.shape[0]
    meta = scene.meta
    types = meta.mat_types_used
    state, act, stay, vol_dist, passthrough, shade, outgoing, sh = _surface_events(
        scene, state, hit, rng)
    mp, normal, position = sh.mp, sh.normal, sh.position

    emit = B.eval_emission(mp, normal, outgoing)
    radiance = state.radiance + torch.where(shade[..., None], state.weight * emit, 0.0)
    spans.mark(events, f"trace.b{b}.surface")

    delta = B.is_delta(mp)

    # light-sampling estimator; its pdf re-traces each area light over all R lanes
    rand_l, rand_el = rng.uniform(), rng.uniform()
    dir_l = sample_lights(scene, position, rand_l, rand_el, rng.uniform2())
    l_zero = (dir_l == 0.0).all(-1)
    nrays = n_area_lights(meta) * R
    lpdf = sample_lights_pdf(scene, position, dir_l, intersect_mode)
    w_light = B.eval_bsdf_cos(mp, normal, outgoing, dir_l, types) / torch.clamp_min(lpdf, 1e-18)[..., None]
    light_bad = l_zero | (lpdf <= 0)

    # bsdf-sampling estimator
    rnl = rng.uniform()
    dir_b = B.sample_bsdf_cos(mp, normal, outgoing, rnl, rng.uniform2(), types)
    b_zero = (dir_b == 0.0).all(-1)
    bpdf = B.sample_bsdf_cos_pdf(mp, normal, outgoing, dir_b, types)
    w_bsdf = B.eval_bsdf_cos(mp, normal, outgoing, dir_b, types) / torch.clamp_min(bpdf, 1e-18)[..., None]

    if mode == SamplingMode.LIGHT:
        use_light = torch.ones((R,), dtype=torch.bool, device=position.device)
    elif mode == SamplingMode.BSDF:
        use_light = torch.zeros((R,), dtype=torch.bool, device=position.device)
    else:  # BOTH: 50/50 per lane (PathTrace.cuh:469)
        use_light = rng.uniform() > 0.5

    incoming_nd = torch.where(use_light[..., None], dir_l, dir_b)
    w_nd = torch.where(use_light[..., None], w_light, w_bsdf)
    broke_nd = torch.where(use_light, light_bad, b_zero)

    # delta branch
    dir_d = B.sample_delta(mp, normal, outgoing, rng.uniform(), types)
    pdf_d = B.sample_delta_pdf(mp, normal, outgoing, dir_d, types)
    w_delta = B.eval_delta(mp, normal, outgoing, dir_d, types) / torch.clamp_min(pdf_d, 1e-18)[..., None]
    d_zero = (dir_d == 0.0).all(-1)

    incoming = torch.where(delta[..., None], dir_d, incoming_nd)
    w_mult = torch.where(delta[..., None], w_delta, w_nd)
    broke = torch.where(delta, d_zero, broke_nd)
    new_ro = _offset_origin(position, normal, incoming)
    new_weight = state.weight * w_mult

    in_volume, vol_density, vol_scattering, vol_anisotropy = (
        state.in_volume, state.vol_density, state.vol_scattering, state.vol_anisotropy)
    if meta.has_media:
        in_volume, vol_density, vol_scattering, vol_anisotropy = _enter_volume(
            scene, state, mp, normal, outgoing, incoming, shade, broke)
        vpos, vdir, vw, vbroke = _volume_scatter(scene, state, vol_dist, rng, intersect_mode)
        nrays = nrays + n_area_lights(meta) * R
        incoming = torch.where(stay[..., None], vdir, incoming)
        new_weight = torch.where(stay[..., None], state.weight * vw, new_weight)
        new_ro = torch.where(stay[..., None], vpos, new_ro)
        broke = torch.where(stay, vbroke, broke)
    if meta.has_opacity:
        incoming = torch.where(passthrough[..., None], state.rd, incoming)
        new_weight = torch.where(passthrough[..., None], state.weight, new_weight)
        new_ro = torch.where(passthrough[..., None], position + state.rd * 1e-2, new_ro)
        broke = torch.where(passthrough, False, broke)

    new_state = PathState(
        radiance=radiance,
        weight=torch.where(act[..., None], new_weight, state.weight),
        active=act & ~broke,
        use_mis=state.use_mis,
        ro=torch.where(act[..., None], new_ro, state.ro),
        rd=torch.where(act[..., None], incoming, state.rd),
        in_volume=torch.where(act, in_volume, state.in_volume),
        vol_density=vol_density,
        vol_scattering=vol_scattering,
        vol_anisotropy=vol_anisotropy,
    )
    spans.mark(events, f"trace.b{b}.sample")
    return new_state, None, nrays
