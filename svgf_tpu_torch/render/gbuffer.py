"""G-buffer primary-visibility pass (svgf_tpu/render/gbuffer.py).

Primary rays cast at pixel centres fill the reference's G-buffer channels
(GBuffer.{vert,frag}, App.cu:378-413): position, normal, barycentrics,
instance, motion from reprojecting the hit through the previous camera,
and the screen-space depth derivative. svgf_tpu's MXU one-hot gathers
become plain indexing.
"""

from __future__ import annotations

import torch

from svgf_tpu_torch.ops.geometry import (
    MAX_LENGTH, abs_, normalize, transform_point, transform_vector,
)
from svgf_tpu_torch.ops.intersect import Hit, intersect_scene
from svgf_tpu_torch.ops.lights import interp
from svgf_tpu_torch.render import spans
from svgf_tpu_torch.render.types import GBuffer


def camera_rays(cam_frame, cam_proj, h: int, w: int, jitter=None, row0: int = 0,
                h_total: int | None = None, col0: int = 0, w_total: int | None = None):
    """Primary rays through pixel centres (+ optional per-pixel jitter in
    pixels, (h, w, 2)), as flat (h*w, 3) origins and directions (reference
    GetRay, Common.cuh:333-343). With row0/h_total (col0/w_total) the rays
    are those of the pixel rectangle [row0, row0+h) x [col0, col0+w) of an
    (h_total, w_total) image: a band of the row-sharded route."""
    dev = cam_frame.device
    h_total = h if h_total is None else h_total
    w_total = w if w_total is None else w_total
    r = (torch.arange(h, dtype=torch.float32, device=dev) + row0)[:, None].expand(h, w)
    c = (torch.arange(w, dtype=torch.float32, device=dev) + col0)[None, :].expand(h, w)
    if jitter is None:
        jx = jy = 0.0
    else:
        jx, jy = jitter[..., 0], jitter[..., 1]
    # multiply by the float32 reciprocal, as XLA compiles svgf_tpu's division
    # by the constant image size: rays through a corner edge of the scene
    # then pick the same side as in svgf_tpu
    one = torch.ones((), device=dev)
    u = (c + 0.5 + jx) * (one / w_total)
    v = 1.0 - (r + 0.5 + jy) * (one / h_total)     # NDC y is up
    x = (2.0 * u - 1.0) / cam_proj[0, 0]
    y = (2.0 * v - 1.0) / cam_proj[1, 1]
    d = normalize(torch.stack([x, y, -torch.ones_like(x)], dim=-1))
    rd = transform_vector(cam_frame, d)
    ro = torch.broadcast_to(cam_frame[:3, 3], (h, w, 3))
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


def project_to_pixel(cam_frame, cam_proj, pos, h: int, w: int):
    """World position -> (px, py) pixel coords (y down), perspective divide."""
    return _project_view(torch.linalg.inv(cam_frame), cam_proj, pos, h, w)


def _project_view(view, cam_proj, pos, h: int, w: int):
    """project_to_pixel with the camera frame's inverse `view` given: the
    G-buffer inverts each frame once for all its chunks."""
    p_view = transform_point(view, pos)
    clip = transform_point(cam_proj, p_view)
    wc = -p_view[..., 2]  # P[3] row = (0,0,-1,0)
    # degenerate lanes (point on the camera plane) divide by 1, not a floor
    bad = torch.abs(wc) < 1e-18
    num = torch.where(bad[..., None], 0.0, clip[..., :2])
    den = torch.where(bad, 1.0, wc)
    ndc = num / den[..., None]
    px = (ndc[..., 0] + 1.0) * 0.5 * w
    py = (1.0 - ndc[..., 1]) * 0.5 * h
    return px, py


def _gbuffer_rays(scene, frame, view, prev_view, proj, ro, rd, h, w, mode, events=None):
    """Per-ray G-buffer fields (everything except the depth derivative)."""
    hit = intersect_scene(scene, ro, rd, mode)
    spans.mark(events, "gbuffer.intersect")
    ok = hit.dist < MAX_LENGTH

    prim = torch.clamp(hit.prim, 0, scene.tri_pos.shape[0] - 1)
    inst = torch.clamp(hit.instance, 0, scene.inst_shape.shape[0] - 1)
    pos = transform_point(scene.inst_transform[inst], interp(scene.tri_pos, prim, hit.u, hit.v))
    nrm = normalize(transform_vector(scene.inst_normal_transform[inst],
                                     interp(scene.tri_nrm, prim, hit.u, hit.v)))
    dp = pos - frame[:3, 3]
    depth = torch.sqrt((dp * dp).sum(-1))

    px_cur, py_cur = _project_view(view, proj, pos, h, w)
    px_prev, py_prev = _project_view(prev_view, proj, pos, h, w)
    motion = torch.stack([px_prev - px_cur, py_prev - py_cur], dim=-1)

    okf = ok[..., None]
    minus1 = torch.full_like(hit.instance, -1)
    fields = (
        torch.where(okf, pos, 0.0),
        torch.where(okf, nrm, 0.0),
        torch.where(okf, motion, 0.0),
        torch.where(ok, depth, 0.0),
        torch.where(okf, torch.stack([hit.u, hit.v], -1), 0.0),
        torch.where(ok, hit.instance, minus1),
        torch.where(ok, hit.prim, minus1),
        torch.where(ok, hit.material, minus1),
    )
    spans.mark(events, "gbuffer.fill")
    return fields


def pad_rows(x, pad: int):
    """Append `pad` copies of the last row (svgf_tpu's chunk padding)."""
    return x if pad == 0 else torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])


def raster_gbuffer(scene, cam_idx: int, h: int, w: int, num_chunks: int = 1,
                   mode: str = "off", block: bool = False, row0: int = 0,
                   h_total: int | None = None, col0: int = 0,
                   w_total: int | None = None, events: dict | None = None) -> GBuffer:
    """Trace primary visibility and fill every G-buffer channel, in
    `num_chunks` sequential ray chunks. `mode` is the intersector policy;
    `block` traces the rays in 64x64 pixel blocks, the lane order of large
    scenes (render.pathtrace.make_block_order). row0/h_total (col0/w_total)
    render the pixel rectangle [row0, row0+h) x [col0, col0+w) of the full
    image; the depth derivative at its last row and column is then the
    clamped one, which the sharded route replaces. `events`: the parts'
    marks (render.spans)."""
    h_total = h if h_total is None else h_total
    w_total = w if w_total is None else w_total
    frame = scene.cam_frame[cam_idx]
    proj = scene.cam_proj[cam_idx]
    view = torch.linalg.inv(frame)
    prev_view = torch.linalg.inv(scene.cam_prev_frame[cam_idx])
    ro, rd = camera_rays(frame, proj, h, w, row0=row0, h_total=h_total, col0=col0,
                         w_total=w_total)
    unblock = None
    if block:
        from svgf_tpu_torch.render.pathtrace import make_block_order

        fwd, unblock, _ = make_block_order(h, w)
        ro, rd = fwd(ro), fwd(rd)
    R = ro.shape[0]
    num_chunks = max(num_chunks, 1)
    rc = -(-R // num_chunks)
    pad = rc * num_chunks - R
    ro, rd = pad_rows(ro, pad), pad_rows(rd, pad)
    spans.mark(events, "gbuffer.rays")
    parts = [
        _gbuffer_rays(scene, frame, view, prev_view, proj,
                      ro[k * rc:(k + 1) * rc], rd[k * rc:(k + 1) * rc], h_total, w_total, mode,
                      events)
        for k in range(num_chunks)
    ]
    fields = [torch.cat(f)[:R] if num_chunks > 1 else f[0] for f in zip(*parts)]
    if unblock is not None:
        fields = [unblock(f) for f in fields]
    pos, nrm, motion, z, uv, inst, prim, mat = fields

    z = z.reshape(h, w)
    # dFdx/dFdy analogue: forward differences, clamped at the border
    dzx = abs_(torch.diff(z, dim=1, append=z[:, -1:]))
    dzy = abs_(torch.diff(z, dim=0, append=z[-1:, :]))
    depth_deriv = torch.maximum(dzx, dzy)

    return GBuffer(
        position=pos.reshape(h, w, 3),
        normal=nrm.reshape(h, w, 3),
        motion=motion.reshape(h, w, 2),
        depth=z,
        depth_deriv=torch.where(z > 0.0, depth_deriv, 0.0),
        uv=uv.reshape(h, w, 2),
        instance=inst.reshape(h, w),
        prim=prim.reshape(h, w),
        material=mat.reshape(h, w),
    )


def gbuffer_first_hit(gbuf: GBuffer) -> Hit:
    """MakeFirstIsect (Common.cuh:1542-1568): rebuild the primary-hit record
    from G-buffer channels; empty pixels get a MAX_LENGTH miss."""
    ok = (gbuf.instance >= 0).reshape(-1)
    zero = torch.zeros_like(gbuf.instance.reshape(-1))
    return Hit(
        dist=torch.where(ok, gbuf.depth.reshape(-1).float(), MAX_LENGTH),
        u=gbuf.uv[..., 0].reshape(-1).float(),
        v=gbuf.uv[..., 1].reshape(-1).float(),
        prim=torch.where(ok, gbuf.prim.reshape(-1), zero),
        instance=torch.where(ok, gbuf.instance.reshape(-1), zero),
        material=torch.where(ok, gbuf.material.reshape(-1), zero),
    )
