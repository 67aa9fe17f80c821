"""The four SVGF stages, plain: temporal accumulation with reprojection,
the 7x7 moments fallback, the 5x5 a-trous chain with iteration-0
feedback, and TAA with the sRGB encode. Each keeps the renderer's tap order
and its quirks (clamped loads, truncated motion, the 4/h variance boost,
squared a-trous variance weights)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.geometry import luminance, to_srgb

INVALID_DEPTH = 1e30


def _load01(img):
    return torch.clamp(img.float(), 0.0, 1.0)


def _depth(depth):
    depth = depth.float()
    return torch.where(depth == 0.0, INVALID_DEPTH, depth)


def _shift(x, dy: int, dx: int):
    return torch.roll(x, shifts=(-dy, -dx), dims=(0, 1))


def _inside(h: int, w: int, dy: int, dx: int, device):
    r = torch.arange(h, device=device)[:, None] + dy
    c = torch.arange(w, device=device)[None, :] + dx
    return (r >= 0) & (r < h) & (c >= 0) & (c < w)


def _weight(z_c, z_p, phi_depth, n_c, n_p, phi_normal, l_c, l_p, phi_l):
    w_normal = torch.pow(torch.clamp((n_c * n_p).sum(-1), 0.0, 1.0), phi_normal)
    zero = phi_depth == 0.0
    w_z = torch.where(zero, 0.0, torch.abs(z_c - z_p) / torch.where(zero, 1.0, phi_depth))
    w_l = torch.abs(l_c - l_p) / phi_l
    return torch.exp(-torch.clamp(w_l, 0.0) - torch.clamp(w_z, 0.0)) * w_normal


class Temporal(NamedTuple):
    color: torch.Tensor        # (H, W, 4)
    moments: torch.Tensor      # (H, W, 2)
    history_len: torch.Tensor  # (H, W) i32
    reprojected: torch.Tensor  # (H, W) bool


def temporal(current, prev_color, gbuf, prev_gbuf, prev_moments, prev_history,
             depth_threshold: float, normal_threshold: float, history_cap: int) -> Temporal:
    h, w = current.shape[:2]
    dev = current.device
    cur = _load01(current[..., :3])
    motion = gbuf.motion.float()
    r = torch.arange(h, device=dev, dtype=torch.int32)[:, None]
    c = torch.arange(w, device=dev, dtype=torch.int32)[None, :]
    px = c + motion[..., 0].to(torch.int32)
    py = r + motion[..., 1].to(torch.int32)
    on_screen = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    flat = (torch.clamp(py, 0, h - 1) * w + torch.clamp(px, 0, w - 1)).reshape(-1)

    def gather(x):
        x = x.float()
        return x.reshape((h * w,) + x.shape[2:])[flat].reshape((h, w) + x.shape[2:])

    z_cur = _depth(gbuf.depth)
    z_prev = _depth(gather(prev_gbuf.depth))
    valid = (on_screen & (torch.abs(z_prev - z_cur) <= depth_threshold)
             & (gbuf.instance.float() == gather(prev_gbuf.instance))
             & ((gbuf.normal.float() * gather(prev_gbuf.normal)).sum(-1) >= normal_threshold))
    prev_col = _load01(gather(prev_color)[..., :3])
    hist_prev = gather(prev_history).to(torch.int32)
    mom_prev = gather(prev_moments)
    history = torch.where(valid, torch.clamp_max(hist_prev + 1, history_cap), 1).to(torch.int32)
    alpha = torch.where(valid, 1.0 / history.float(), 1.0)
    lum = luminance(cur)
    mom_cur = torch.stack([lum, lum * lum], dim=-1)
    mom_prev = torch.where(valid[..., None], mom_prev, 0.0)
    moments = mom_prev + (mom_cur - mom_prev) * alpha[..., None]
    variance = torch.clamp(moments[..., 1] - moments[..., 0] ** 2, 0.0)
    prev_col = torch.where(valid[..., None], prev_col, 0.0)
    new_col = prev_col + (cur - prev_col) * alpha[..., None]
    out = torch.clamp(torch.cat([new_col, variance[..., None]], dim=-1), 0.0, 1.0)
    return Temporal(out, moments, history, valid)


def moments_fallback(color, moments, gbuf, history_len, phi_colour: float, phi_normal: float):
    h, w = color.shape[:2]
    dev = color.device
    illum = color.float()
    mom = moments.float()
    l_center = luminance(illum[..., :3])
    z = _depth(gbuf.depth)
    n = gbuf.normal.float()
    phi_depth = torch.clamp(gbuf.depth_deriv.float(), 1e-8) * 3.0
    sum_w = torch.zeros((h, w), device=dev)
    sum_illum = torch.zeros((h, w, 3), device=dev)
    sum_mom = torch.zeros((h, w, 2), device=dev)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            dist = float((dx * dx + dy * dy) ** 0.5)
            illum_p = _shift(illum[..., :3], dy, dx)
            mom_p = _shift(mom, dy, dx)
            wgt = _weight(z, _shift(z, dy, dx), phi_depth * dist, n, _shift(n, dy, dx),
                          phi_normal, l_center, luminance(illum_p), phi_colour)
            wgt = torch.where(_inside(h, w, dy, dx, dev), wgt, 0.0)
            sum_w = sum_w + wgt
            sum_illum = sum_illum + illum_p * wgt[..., None]
            sum_mom = sum_mom + mom_p * wgt[..., None]
    sum_w = torch.clamp(sum_w, 1e-6)
    f_illum = sum_illum / sum_w[..., None]
    f_mom = sum_mom / sum_w[..., None]
    hist = torch.clamp_min(history_len.float(), 1.0)
    variance = (f_mom[..., 1] - f_mom[..., 0] ** 2) * (4.0 / hist)
    fallback = torch.cat([f_illum, variance[..., None]], dim=-1)
    use = (history_len < 4) & (z < INVALID_DEPTH)
    return torch.where(use[..., None], fallback, illum)


_KERNEL_1D = (1.0, 2.0 / 3.0, 1.0 / 6.0)


def atrous_step(img, gbuf, step: int, phi_colour: float, phi_normal: float):
    h, w = img.shape[:2]
    dev = img.device
    center = _load01(img)
    l_center = luminance(center[..., :3])
    z = _depth(gbuf.depth)
    n = gbuf.normal.float()
    phi_l = phi_colour * torch.sqrt(torch.clamp(1e-10 + center[..., 3], 0.0))
    phi_depth = torch.clamp(gbuf.depth_deriv.float(), 1e-6) * step
    sum_w = torch.ones((h, w), device=dev)
    sum_c = center
    for dy in (-2, -1, 0, 1, 2):
        for dx in (-2, -1, 0, 1, 2):
            if dx == 0 and dy == 0:
                continue
            oy, ox = dy * step, dx * step
            kernel = float(_KERNEL_1D[abs(dx)] * _KERNEL_1D[abs(dy)])
            dist = float((dx * dx + dy * dy) ** 0.5)
            pix = _load01(_shift(img, oy, ox))
            wgt = _weight(z, _shift(z, oy, ox), phi_depth * dist, n, _shift(n, oy, ox),
                          phi_normal, l_center, luminance(pix[..., :3]), phi_l)
            wgt = torch.where(_inside(h, w, oy, ox, dev), wgt * kernel, 0.0)
            sum_w = sum_w + wgt
            sum_c = sum_c + torch.stack([wgt, wgt, wgt, wgt * wgt], dim=-1) * pix
    filtered = sum_c / torch.stack([sum_w, sum_w, sum_w, sum_w * sum_w], dim=-1)
    return torch.where((z >= INVALID_DEPTH)[..., None], center, filtered)


def atrous(img, gbuf, steps: int, phi_colour: float, phi_normal: float):
    """(final, feedback): feedback is iteration 0's output."""
    feedback = out = img
    for i in range(steps):
        out = atrous_step(out, gbuf, 1 << i, phi_colour, phi_normal)
        if i == 0:
            feedback = out
    return out, feedback


_YUV_ENC = ((0.299, 0.587, 0.114), (-0.14713, -0.28886, 0.436), (0.615, -0.51499, -0.10001))
_YUV_DEC = ((1.0, 0.0, 1.13983), (1.0, -0.39465, -0.58060), (1.0, 2.03211, 0.0))


def _yuv(rgb, mat):
    ch = [rgb[..., 0], rgb[..., 1], rgb[..., 2]]
    return torch.stack([m[0] * ch[0] + m[1] * ch[1] + m[2] * ch[2] for m in mat], dim=-1)


def taa(filtered, history):
    h, w = filtered.shape[:2]
    dev = filtered.device
    last = _load01(history)
    in0 = _load01(filtered)[..., :3]
    mix = torch.clamp(last[..., 3], None, 0.5)
    aa = last[..., :3]
    aa = torch.sqrt(torch.clamp(aa * aa + (in0 * in0 - aa * aa) * mix[..., None], 1e-12))
    rgb_in = filtered[..., :3]
    rows, cols = torch.arange(h, device=dev), torch.arange(w, device=dev)
    neigh = []
    for dy, dx in [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)]:
        rr = torch.clamp(rows + dy, 0, h - 1)
        cc = torch.clamp(cols + dx, 0, w - 1)
        neigh.append(_load01(rgb_in[rr][:, cc]))
    enc = lambda x: _yuv(torch.clamp(x, 0.0) * torch.clamp(x, 0.0), _YUV_ENC)
    aa_yuv = enc(aa)
    in_yuv = [enc(in0)] + [enc(x) for x in neigh]
    first5, rest4 = torch.stack(in_yuv[:5]), torch.stack(in_yuv[5:])
    min_c, max_c = first5.amin(0), first5.amax(0)
    min_c = 0.5 * min_c + 0.5 * torch.minimum(rest4.amin(0), min_c)
    max_c = 0.5 * max_c + 0.5 * torch.maximum(rest4.amax(0), max_c)
    rgb = torch.sqrt(torch.clamp(_yuv(torch.minimum(torch.maximum(aa_yuv, min_c), max_c),
                                      _YUV_DEC), 1e-12))
    rgb = torch.where(torch.isfinite(rgb).all(-1, keepdim=True), rgb, 0.0)
    out = torch.cat([to_srgb(rgb), torch.ones((h, w, 1), device=dev)], dim=-1)
    return torch.clamp(out, 0.0, 1.0)


def chain(radiance, gbuf, prev, sv: dict):
    """The four stages on one frame: (temporal, moments_out, atrous_out,
    final (H, W, 4), feedback). `prev` holds color, moments, history_len,
    taa_history and gbuffer; `sv` the SVGF settings."""
    t = temporal(radiance, prev["color"], gbuf, prev["gbuffer"], prev["moments"],
                 prev["history_len"], sv["depth_threshold"], sv["normal_threshold"],
                 sv["history_length"])
    m = moments_fallback(t.color, t.moments, gbuf, t.history_len, sv["phi_colour"], sv["phi_normal"])
    a, feedback = atrous(m, gbuf, sv["spatial_filter_steps"], sv["phi_colour"], sv["phi_normal"])
    if sv["spatial_filter_steps"] == 0:
        feedback = t.color
    return t, m, a, taa(a, prev["taa_history"]), feedback
