"""Wavefront path tracer (svgf_tpu/render/pathtrace.py; reference
src/PathTrace.cuh).

Every bounce is one step over the whole lane batch: all lanes intersect
together, all lanes shade together, termination is a mask. The MIS
estimator (PathTrace.cuh:148-351) batches the NEE shadow ray and the BSDF
sample into one intersect, and the BSDF sample's hit is the next bounce's
hit. Random draws come from the counter-based RngStream in svgf_tpu's
call order, so each lane gets the JAX tracer's numbers bit for bit.

Ported: surface scenes with MATTE materials and area lights under the MIS
estimator, with the pixel-block lane order of large scenes. Media,
opacity, textures, normal maps and the BSDF/LIGHT/BOTH estimators
(`_bounce_simple`) are not, and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svgf_tpu_torch.config import SamplingMode
from svgf_tpu_torch.ops import bsdf as B
from svgf_tpu_torch.ops.geometry import MAX_LENGTH, dot, normalize, transform_point, transform_vector
from svgf_tpu_torch.ops.intersect import Hit, intersect_scene
from svgf_tpu_torch.ops.keys import fold_in
from svgf_tpu_torch.ops.lights import eval_environment, interp, sample_lights, sample_lights_pdf_from_hit
from svgf_tpu_torch.ops.sampling import RngStream, power_heuristic
from svgf_tpu_torch.render.gbuffer import pad_rows


class _Shade(NamedTuple):
    position: torch.Tensor  # (R,3) world shading position
    normal: torch.Tensor    # (R,3) shading normal, flipped toward outgoing
    mp: B.MaterialPoint


def _shading_point(scene, hit: Hit, outgoing) -> _Shade:
    """Geometry + material evaluation at a hit (Common.cuh:1422-1479)."""
    prim = torch.clamp(hit.prim, 0, scene.tri_pos.shape[0] - 1)
    inst = torch.clamp(hit.instance, 0, scene.inst_shape.shape[0] - 1)
    mat = torch.clamp(hit.material, 0, scene.mat_type.shape[0] - 1)
    pos = transform_point(scene.inst_transform[inst], interp(scene.tri_pos, prim, hit.u, hit.v))
    n = normalize(transform_vector(scene.inst_normal_transform[inst],
                                   interp(scene.tri_nrm, prim, hit.u, hit.v)))
    mp = B.eval_material_point(scene, mat)
    # EvalShadingNormal (Common.cuh:1433-1438): glass keeps the normal,
    # everything else flips it toward the outgoing direction
    flip = (dot(n, outgoing) < 0) & (mp.mtype != B.GLASS)
    n = torch.where(flip[..., None], -n, n)
    return _Shade(position=pos, normal=n, mp=mp)


def _emission_at_hit(scene, hit: Hit, outgoing):
    """EvalEmission at a secondary hit (NEE branch, PathTrace.cuh:253-256):
    only the shading normal and the material's emission matter."""
    prim = torch.clamp(hit.prim, 0, scene.tri_pos.shape[0] - 1)
    inst = torch.clamp(hit.instance, 0, scene.inst_shape.shape[0] - 1)
    mat = torch.clamp(hit.material, 0, scene.mat_type.shape[0] - 1)
    n = normalize(transform_vector(scene.inst_normal_transform[inst],
                                   interp(scene.tri_nrm, prim, hit.u, hit.v)))
    flip = (dot(n, outgoing) < 0) & (scene.mat_type[mat] != B.GLASS)
    n = torch.where(flip[..., None], -n, n)
    return torch.where((dot(n, outgoing) >= 0)[..., None], scene.mat_emission[mat], 0.0)


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


def _check_supported(scene, mode) -> None:
    meta = scene.meta
    unported = [name for name, on in (
        ("participating media", meta.has_media),
        ("opacity pass-through", meta.has_opacity),
        ("scene textures", meta.textures_enabled),
        ("normal maps", meta.has_normal_maps),
        (f"sampling mode {SamplingMode(mode).name}", mode != SamplingMode.MIS),
    ) if on]
    if unported:
        raise NotImplementedError(
            f"not ported to svgf_tpu_torch yet: {', '.join(unported)}"
        )


def pathtrace(scene, ro, rd, key, lane_ids, bounces: int = 3, clamp: float = 10.0,
              mode: SamplingMode = SamplingMode.MIS, first_hit: Hit | None = None,
              intersect_mode: str = "off"):
    """Trace one sample per lane. `key` is the host threefry key of this
    sample (ops.keys); `lane_ids` are the lanes' global ids, which the
    random draws hash. Returns (radiance (R,3), rays_traced): rays_traced
    counts the active lanes of every intersect. (svgf_tpu also returns the
    first hit's shading normal, which no caller reads.)"""
    _check_supported(scene, mode)
    R = ro.shape[0]
    dev = ro.device
    state = PathState(
        radiance=torch.zeros((R, 3), device=dev),
        weight=torch.ones((R, 3), device=dev),
        active=torch.ones((R,), dtype=torch.bool, device=dev),
        use_mis=torch.zeros((R,), dtype=torch.bool, device=dev),
        ro=ro,
        rd=rd,
    )
    nrays = torch.zeros((), dtype=torch.int64, device=dev)

    if first_hit is not None:
        hit = first_hit
    else:
        hit = intersect_scene(scene, ro, rd, intersect_mode)
        nrays = nrays + R
    for b in range(bounces):
        rng = RngStream(fold_in(key, b), lane_ids)
        state, next_hit, nb = _bounce_mis(scene, state, hit, rng, intersect_mode)
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
        # the MIS bounce traced every active lane's next ray already
        hit = next_hit

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
                      block_hw=None):
    """Run the wavefront in `num_chunks` sequential lane chunks: peak memory
    scales with the live lane count. Lanes keep their global ids, so the
    result equals the unchunked one. Padding lanes repeat the last ray and
    count in rays_traced, as in svgf_tpu.

    block_hw=(h, w): the lanes are an (h, w) image in row-major order; they
    are traced in 64x64 pixel blocks (make_block_order) and returned in
    row-major order. The random draws hash the pixel ids, so per-pixel
    results do not change; the edge-padding lanes trace and count."""
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
            num_chunks, intersect_mode, lane_ids=fwd(lane_ids),
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
        rad, nr = pathtrace(
            scene, ro[s], rd[s], key, lane_ids[s], bounces, clamp, mode,
            None if first_hit is None else first_hit.chunk(s.start, s.stop),
            intersect_mode,
        )
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


def _bounce_mis(scene, state: PathState, hit: Hit, rng: RngStream, intersect_mode: str):
    """One MIS bounce (PathTrace.cuh:148-351) for surface scenes. Returns
    (state, next_hit, rays_traced)."""
    R = state.ro.shape[0]
    types = scene.meta.mat_types_used
    state = _handle_miss(scene, state, hit)
    act = state.active
    shade = act

    outgoing = -state.rd
    sh = _shading_point(scene, hit, outgoing)
    mp, normal, position = sh.mp, sh.normal, sh.position

    # emission (only when the MIS bsdf branch didn't already account for it)
    emit = B.eval_emission(mp, normal, outgoing)
    add_emit = shade & ~state.use_mis
    radiance = state.radiance + torch.where(add_emit[..., None], state.weight * emit, 0.0)

    delta = B.is_delta(mp)
    weight = state.weight

    # NEE direction (PathTrace.cuh:238-260); draws 1-4 of the bounce
    rand_l, rand_el = rng.uniform(), rng.uniform()
    dir_l = sample_lights(scene, position, rand_l, rand_el, rng.uniform2())
    l_zero = (dir_l == 0.0).all(-1)
    shifted_l = _offset_origin(position, normal, dir_l)
    bsdf_l = B.eval_bsdf_cos(mp, normal, outgoing, dir_l, types)
    pre_l = shade & ~delta & ~l_zero & (bsdf_l != 0.0).any(-1)
    nrays = pre_l.sum()

    # BSDF-sample direction (PathTrace.cuh:261-268); draws 5-7
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

    # delta branch (PathTrace.cuh:286-292); draw 8, taken even in an
    # all-matte scene to keep svgf_tpu's draw order
    dir_d = B.sample_delta(mp, normal, outgoing, rng.uniform(), types)
    pdf_d = B.sample_delta_pdf(mp, normal, outgoing, dir_d, types)
    w_delta = weight * B.eval_delta(mp, normal, outgoing, dir_d, types) / torch.clamp_min(pdf_d, 1e-18)[..., None]
    d_zero = (dir_d == 0.0).all(-1)

    incoming = torch.where(delta[..., None], dir_d, dir_b)
    # lanes break when their sampled direction is zero (:241,:264)
    broke = torch.where(delta, d_zero, b_zero | l_zero)
    new_ro = _offset_origin(position, normal, incoming)

    # ONE batched intersect: [NEE shadow | bsdf sample]
    hitN = intersect_scene(
        scene,
        torch.cat([shifted_l, shifted_b]),
        torch.cat([dir_l, dir_b]),
        intersect_mode,
        active=torch.cat([pre_l, trace_b]),
    )
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
    if scene.meta.n_envs > 0:
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
    if scene.meta.n_envs > 0:
        emis_b = torch.where(mis_miss[..., None], eval_environment(scene, dir_b), 0.0)
    else:
        emis_b = torch.zeros((R, 3), device=position.device)
    # raw Material.Emission at the hit — no orientation test (:276)
    hm = torch.clamp(mis_hit.material, 0, scene.mat_type.shape[0] - 1)
    emis_b = torch.where(mis_miss[..., None], emis_b, scene.mat_emission[hm])
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
    new_state = PathState(
        radiance=radiance,
        weight=torch.where(act[..., None], new_weight, state.weight),
        active=act & ~broke,
        use_mis=torch.where(act, use_mis, state.use_mis),
        ro=torch.where(act[..., None], new_ro, state.ro),
        rd=torch.where(act[..., None], incoming, state.rd),
    )
    return new_state, mis_hit, nrays
