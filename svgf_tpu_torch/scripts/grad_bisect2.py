"""Where a non-finite camera gradient enters one MIS bounce: the port's copy
of svgf_tpu's scripts/grad_bisect2.py.

The gradient with respect to `cam_frame` of each intermediate of the MIS
bounce (render/pathtrace.py's estimator, written out stage by stage) on
the primary rays of the Cornell box at 24x16, one stage a row (STAGES).
The primary, shadow and BSDF-sample intersects take the intersector
`timing.kernel_mode(device)`, K5 on the card, as svgf_tpu's script runs
its Pallas kernel: a stage calls it 0-3 times. The random draws are the
stream `fold_in(key(0), 0)` on the lane ids 0..R-1. Rows are
grad_bisect.Row; main prints svgf_tpu's table, then the card line and one
JSON line of the rows without their gradients.

Usage: python -m svgf_tpu_torch.scripts.grad_bisect2 [height width]
(on the card; main(device="cpu") runs the plain versions on the CPU).
"""

from __future__ import annotations

import dataclasses

import torch

from svgf_tpu_torch.scripts.grad_bisect import H, W, bisect, cornell_arrays, parse_size

STAGES = ("rays", "hit_t", "hit_uv", "sh_pos", "sh_nrm", "emit", "dir_l", "bsdf_l", "lpdf_l",
          "bpdf_l", "misw_l", "emis_hit", "nee", "dir_b", "bpdf_b", "lpdf_b", "misw_b", "mis",
          "delta")

# the intersects a stage makes through `mode` (K5 launches on the card):
# the primary from hit_t on, the shadow ray's from lpdf_l, the BSDF
# sample's from lpdf_b; 33 over the 19 stages
K5_CALLS = {s: sum(STAGES.index(s) >= STAGES.index(first)
                   for first in ("hit_t", "lpdf_l", "lpdf_b")) for s in STAGES}


def stage(arrays, cam_frame, upto: str, h: int, w: int, mode: str):
    """svgf_tpu's loss at stage `upto` of cam_frame."""
    from svgf_tpu_torch.ops import bsdf as B
    from svgf_tpu_torch.ops.geometry import MAX_LENGTH, clip
    from svgf_tpu_torch.ops.intersect import intersect_scene
    from svgf_tpu_torch.ops.keys import fold_in, key
    from svgf_tpu_torch.ops.lights import sample_lights, sample_lights_pdf_from_hit
    from svgf_tpu_torch.ops.sampling import RngStream, power_heuristic
    from svgf_tpu_torch.render.gbuffer import camera_rays
    from svgf_tpu_torch.render.pathtrace import _emission_at_hit, _offset_origin, _shading_point

    if upto not in STAGES:
        raise ValueError(upto)
    cam = 0
    sc = dataclasses.replace(arrays, cam_frame=cam_frame)
    ro, rd = camera_rays(sc.cam_frame[cam], sc.cam_proj[cam], h, w)
    R = ro.shape[0]
    if upto == "rays":
        return (rd ** 2).mean()
    hit = intersect_scene(sc, ro, rd, mode)
    if upto == "hit_t":
        return torch.where(hit.dist < MAX_LENGTH, hit.dist, 0.0).mean()
    if upto == "hit_uv":
        return (hit.u ** 2 + hit.v ** 2).mean()
    outgoing = -rd
    sh = _shading_point(sc, hit, outgoing)
    if upto == "sh_pos":
        return (sh.position ** 2).mean()
    if upto == "sh_nrm":
        return (sh.normal ** 2).mean()
    mp, normal, position = sh.mp, sh.normal, sh.position
    emit = B.eval_emission(mp, normal, outgoing)
    if upto == "emit":
        return emit.mean()
    rng = RngStream(fold_in(key(0), 0), torch.arange(R, device=ro.device))
    dir_l = sample_lights(sc, position, rng.uniform(), rng.uniform(), rng.uniform2())
    if upto == "dir_l":
        return (dir_l ** 2).mean()
    l_zero = (dir_l == 0.0).all(-1)
    shifted_l = _offset_origin(position, normal, dir_l)
    bsdf_l = B.eval_bsdf_cos(mp, normal, outgoing, dir_l)
    if upto == "bsdf_l":
        return bsdf_l.mean()
    shade = hit.dist < MAX_LENGTH
    delta = B.is_delta(mp)
    pre_l = shade & ~delta & ~l_zero & (bsdf_l != 0.0).any(-1)
    shadow = intersect_scene(sc, shifted_l, dir_l, mode, active=pre_l)
    lpdf_l = sample_lights_pdf_from_hit(sc, shifted_l, dir_l, shadow)
    if upto == "lpdf_l":
        return lpdf_l.mean()
    bpdf_l = B.sample_bsdf_cos_pdf(mp, normal, outgoing, dir_l)
    if upto == "bpdf_l":
        return bpdf_l.mean()
    safe_l = lpdf_l > 0
    misw_l = (torch.where(safe_l, power_heuristic(lpdf_l, bpdf_l), 0.0)
              / torch.where(safe_l, clip(lpdf_l, 1e-20), 1.0))
    if upto == "misw_l":
        return misw_l.mean()
    nee_ok = pre_l & safe_l & (misw_l != 0)
    emis_hit = _emission_at_hit(sc, shadow, -dir_l)
    if upto == "emis_hit":
        return emis_hit.mean()
    nee = torch.where(nee_ok[..., None], bsdf_l * emis_hit * misw_l[..., None], 0.0)
    if upto == "nee":
        return nee.mean()
    # the BSDF branch
    dir_b = B.sample_bsdf_cos(mp, normal, outgoing, rng.uniform(), rng.uniform2())
    if upto == "dir_b":
        return (dir_b ** 2).mean()
    b_zero = (dir_b == 0.0).all(-1)
    shifted_b = _offset_origin(position, normal, dir_b)
    bsdf_b = B.eval_bsdf_cos(mp, normal, outgoing, dir_b)
    bpdf_b = B.sample_bsdf_cos_pdf(mp, normal, outgoing, dir_b)
    if upto == "bpdf_b":
        return bpdf_b.mean() + bsdf_b.mean()
    pre_b = shade & ~delta & ~l_zero & ~b_zero & (bpdf_b > 0) & (bsdf_b != 0.0).any(-1)
    mis_hit = intersect_scene(sc, shifted_b, dir_b, mode, active=pre_b)
    lpdf_b = sample_lights_pdf_from_hit(sc, shifted_b, dir_b, mis_hit)
    if upto == "lpdf_b":
        return lpdf_b.mean()
    safe_b = bpdf_b > 0
    misw_b = (torch.where(safe_b, power_heuristic(bpdf_b, lpdf_b), 0.0)
              / torch.where(safe_b, clip(bpdf_b, 1e-20), 1.0))
    if upto == "misw_b":
        return misw_b.mean()
    hm = torch.clamp(mis_hit.material, 0, sc.mat_type.shape[0] - 1)
    emis_b = torch.where((mis_hit.dist >= MAX_LENGTH)[..., None], 0.0, sc.mat_emission[hm])
    mis_cond = pre_b & (misw_b != 0)
    misr = torch.where(mis_cond[..., None], bsdf_b * emis_b * misw_b[..., None], 0.0)
    if upto == "mis":
        return misr.mean()
    # the delta branch
    dir_d = B.sample_delta(mp, normal, outgoing, rng.uniform())
    pdf_d = B.sample_delta_pdf(mp, normal, outgoing, dir_d)
    return (B.eval_delta(mp, normal, outgoing, dir_d) / clip(pdf_d, 1e-20)[..., None]).mean()


def main(argv=None, device="cuda", height: int = H, width: int = W) -> list:
    from svgf_tpu_torch.scripts.timing import kernel_mode, report

    h, w = parse_size(argv, height, width)
    arrays = cornell_arrays(h, w, device)
    mode = kernel_mode(device)
    rows = bisect({s: (lambda cf, s=s: stage(arrays, cf, s, h, w, mode)) for s in STAGES},
                  arrays.cam_frame, width=10)
    report("grad_bisect2", device, [r.summary() for r in rows], height=h, width=w)
    return rows


if __name__ == "__main__":
    main()
