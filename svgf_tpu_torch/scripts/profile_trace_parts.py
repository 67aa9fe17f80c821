"""The trace stage's building blocks, each timed alone: the port's copy of
svgf_tpu's scripts/profile_trace_parts.py.

At a fixed lane count R (default 1920*1080/8 = 259,200, the Cornell
box's 16:9 camera rays tiled to R) each part of a bounce runs K times a
rep: the intersector through K5 and through the plain dense sweep, K5 on
an all-inactive mask, the shading point, light sampling and its pdf, the
BSDF's sample, evaluation and pdf, six uniform draws, and one whole MIS
bounce on the route a frame takes (whose one batched intersect traces the
shadow ray and the BSDF sample together): on the card the shading kernels
around it (render/pathtrace.py _bounce_mis_kernels), on the CPU the plain
_bounce_mis. Each part gets timing.timed's figures: device
ms, host ms and, on the card, its device kernels, and the kernel launches
the wrappers counted in a rep. The labels are svgf_tpu's ("pallas" is K5,
"xla dense" the plain sweep). Eager PyTorch does not merge repeated calls,
so the parts need not perturb their inputs from one iteration to the next
as svgf_tpu's do inside one jit.

Usage: python -m svgf_tpu_torch.scripts.profile_trace_parts [R] [K]
"""

from __future__ import annotations

import sys


def part_inputs(R: int, device):
    """(the Cornell arrays, R camera rays (ro, rd), their lane ids) as
    svgf_tpu's script makes them: the first R of a 1920-wide 16:9 camera's
    rays, tiled when fewer."""
    import torch

    from svgf_tpu_torch.render.gbuffer import camera_rays
    from svgf_tpu_torch.scenes.cornell import cornell_box

    scene = cornell_box()
    scene.cameras[0].aspect = 16 / 9
    arrays = scene.flatten(device=device)
    h = max(R // 1920, 1)
    ro, rd = camera_rays(arrays.cam_frame[0], arrays.cam_proj[0], h, 1920)
    if ro.shape[0] < R:
        reps = -(-R // ro.shape[0])
        ro, rd = ro.repeat(reps, 1), rd.repeat(reps, 1)
    return arrays, ro[:R].contiguous(), rd[:R].contiguous(), torch.arange(R, device=device)


def main(argv=None, device="cuda") -> list:
    import torch

    from svgf_tpu_torch.config import SamplingMode
    from svgf_tpu_torch.kernels.shade import takes_kernels
    from svgf_tpu_torch.ops import bsdf as B
    from svgf_tpu_torch.ops.intersect import intersect_scene
    from svgf_tpu_torch.ops.keys import key
    from svgf_tpu_torch.ops.lights import sample_lights, sample_lights_pdf_from_hit
    from svgf_tpu_torch.ops.sampling import RngStream
    from svgf_tpu_torch.render.pathtrace import (
        _bounce_mis, _bounce_mis_kernels, _shading_point, _start_state,
    )
    from svgf_tpu_torch.scripts.timing import fmt, kernel_mode, report, timed

    argv = sys.argv[1:] if argv is None else argv
    R = int(argv[0]) if len(argv) > 0 else 1920 * 1080 // 8
    K = int(argv[1]) if len(argv) > 1 else 24
    mode = kernel_mode(device)
    print(f"device: {device}  R={R}  K={K}  kernels: {mode}", flush=True)
    arrays, ro, rd, ids = part_inputs(R, device)
    k0 = key(0)
    mt = arrays.meta.mat_types_used
    rows = []

    def part(label, fn):
        rows.append(timed(fn, K, reps=6, device=device).row(label))
        print(fmt(rows[-1]), flush=True)

    with torch.no_grad():
        hit0 = intersect_scene(arrays, ro, rd, mode)
        pos = ro + rd * (hit0.dist * 0.5)[:, None]
        sh = _shading_point(arrays, hit0, -rd)
        none = torch.zeros((R,), dtype=torch.bool, device=device)

        def lights():
            rng = RngStream(k0, ids)
            return sample_lights(arrays, pos, rng.uniform(), rng.uniform(), rng.uniform2())

        def bsdf():
            rng = RngStream(k0, ids)
            d = B.sample_bsdf_cos(sh.mp, sh.normal, -rd, rng.uniform(), rng.uniform2(), mt)
            return (B.eval_bsdf_cos(sh.mp, sh.normal, -rd, d, mt),
                    B.sample_bsdf_cos_pdf(sh.mp, sh.normal, -rd, d, mt))

        def rngs():
            rng = RngStream(k0, ids)
            acc = torch.zeros((R,), device=device)
            for _ in range(6):
                acc = acc + rng.uniform()
            return acc

        def bounce():
            # the route pathtrace takes for this scene and policy
            st = _start_state(ro, rd)
            if takes_kernels(arrays.meta, SamplingMode.MIS, mode, device):
                rays = torch.zeros((), dtype=torch.int64, device=device)
                return _bounce_mis_kernels(arrays, st, hit0, k0, ids, rays, mode)
            return _bounce_mis(arrays, st, hit0, RngStream(k0, ids), mode)

        part("intersect_scene (pallas)", lambda: intersect_scene(arrays, ro, rd, mode))
        part("intersect_scene (xla dense)", lambda: intersect_scene(arrays, ro, rd, "off"))
        part("intersect_scene (all-inactive)",
             lambda: intersect_scene(arrays, ro, rd, mode, active=none))
        part("_shading_point", lambda: _shading_point(arrays, hit0, -rd))
        part("sample_lights", lights)
        part("sample_lights_pdf_from_hit",
             lambda: sample_lights_pdf_from_hit(arrays, pos, rd, hit0))
        part("bsdf sample+eval+pdf", bsdf)
        part("12x rng uniform draws", rngs)
        part("one full MIS bounce", bounce)
    report("profile_trace_parts", device, rows, lanes=R, iters=K)
    return rows


if __name__ == "__main__":
    main()
