"""SVGF filter stages, plain torch (svgf_tpu/render/svgf.py; reference
src/Filter.cuh).

These are the plain versions of the CUDA kernels in svgf_tpu_torch/csrc
(temporal_filter_band is the motion-bounded band reprojection of the
row-sharded route): the CPU tests hold them against the JAX stages, and
chip_smoke.py holds each kernel against them on the card. Each stage keeps
its JAX twin's operation and tap order, and every reference quirk that twin
reproduces (clamped loads, truncated motion vectors, the 4/h variance
boost, squared a-trous variance weights, iteration-0 feedback).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svgf_tpu_torch.ops.geometry import abs_, clip, div, luminance, to_srgb
from svgf_tpu_torch.render.types import GBuffer

INVALID_DEPTH = 1e30


def load01(img):
    """imageLoad clamp (Filter.cuh:71-83): values clamped to [0,1] on read."""
    return clip(img.float(), 0.0, 1.0)


def store01(img):
    """imageStore clamp (Filter.cuh:55-69)."""
    return clip(img, 0.0, 1.0)


def get_depth(depth):
    """GetDepth (Filter.cuh:199-207): depth==0 -> 1e30 sentinel."""
    depth = depth.float()
    return torch.where(depth == 0.0, INVALID_DEPTH, depth)


def _shift(x, dy: int, dx: int):
    """Value of x at (r+dy, c+dx); border values are garbage (mask with _inside)."""
    return torch.roll(x, shifts=(-dy, -dx), dims=(0, 1))


def _inside(h: int, w: int, dy: int, dx: int, device):
    """Mask: is (r+dy, c+dx) inside the image."""
    r = torch.arange(h, device=device)[:, None] + dy
    c = torch.arange(w, device=device)[None, :] + dx
    return (r >= 0) & (r < h) & (c >= 0) & (c < w)


def compute_weight(z_c, z_p, phi_depth, n_c, n_p, phi_normal, l_c, l_p, phi_l):
    """Edge-stopping weight (Filter.cuh:407-427), shared by moments + a-trous."""
    w_normal = torch.pow(clip((n_c * n_p).sum(-1), 0.0, 1.0), phi_normal)
    zero = phi_depth == 0.0
    w_z = torch.where(zero, 0.0, div(abs_(z_c - z_p), torch.where(zero, 1.0, phi_depth)))
    w_l = abs_(l_c - l_p) / phi_l
    return torch.exp(-clip(w_l, 0.0) - clip(w_z, 0.0)) * w_normal


# ---------------------------------------------------------------------------
# 1. temporal filter (Filter.cuh:359-404 + LoadPreviousData :225-258)
# ---------------------------------------------------------------------------


class TemporalResult(NamedTuple):
    color: torch.Tensor        # (H, W, 4) rgb + variance, clamped to [0,1]
    moments: torch.Tensor      # (H, W, 2)
    history_len: torch.Tensor  # (H, W) i32
    reprojected: torch.Tensor  # (H, W) bool — the disocclusion mask


BOUND_Y = 8    # K7's motion bound in rows (svgf_tpu/kernels/temporal_pallas.py:46)
BOUND_X = 63   # and in columns


def temporal_filter(current, prev_color, gbuf: GBuffer, prev_gbuf: GBuffer,
                    prev_moments, prev_history, depth_threshold: float,
                    normal_threshold: float, history_base_length: int,
                    row0: int = 0, col0: int = 0, prev_row0: int = 0, prev_col0: int = 0,
                    full_h: int | None = None, full_w: int | None = None,
                    motion_bound: tuple[int, int] | None = None) -> TemporalResult:
    """Reproject the previous frame at pixel + trunc(motion) and blend with
    an EMA of rate 1/history (svgf_tpu/render/svgf.py:103). The prev_*
    state may be stored at any float dtype; it is read as float32.

    `row0`/`col0` place this band's first pixel in the full image. The
    prev_* arrays cover the full image (the default) or a window of it
    whose first pixel is global (`prev_row0`, `prev_col0`); a target
    outside the window counts as off-screen. `full_h`/`full_w` give the
    image size for the on-screen test (default: the prev window's). With
    no `motion_bound` the gather is unbounded; with (my, mx) a motion
    beyond |my| or |mx| pixels is a disocclusion, as in K7
    (temporal_filter_band)."""
    h, w = current.shape[:2]
    h_prev, w_prev = prev_color.shape[:2]
    full_h = h_prev if full_h is None else full_h
    full_w = w_prev if full_w is None else full_w
    dev = current.device
    cur = load01(current[..., :3])

    motion = gbuf.motion.float()
    r = torch.arange(h, device=dev, dtype=torch.int32)[:, None] + row0
    c = torch.arange(w, device=dev, dtype=torch.int32)[None, :] + col0
    # ivec2 cast truncates toward zero (Filter.cuh:232); motion is (x, y)
    mx = motion[..., 0].to(torch.int32)
    my = motion[..., 1].to(torch.int32)
    px, py = c + mx, r + my
    on_screen = (px >= 0) & (px < full_w) & (py >= 0) & (py < full_h)
    # window-local coordinates into the prev arrays
    px, py = px - prev_col0, py - prev_row0
    on_screen = on_screen & (px >= 0) & (px < w_prev) & (py >= 0) & (py < h_prev)
    if motion_bound is not None:
        by, bx = motion_bound
        on_screen = on_screen & (my >= -by) & (my <= by) & (mx >= -bx) & (mx <= bx)
    flat = (torch.clamp(py, 0, h_prev - 1) * w_prev + torch.clamp(px, 0, w_prev - 1)).reshape(-1)

    def gather(x):
        x = x.float()
        return x.reshape((h_prev * w_prev,) + x.shape[2:])[flat].reshape((h, w) + x.shape[2:])

    z_cur = get_depth(gbuf.depth)
    z_prev = get_depth(gather(prev_gbuf.depth))
    depth_ok = torch.abs(z_prev - z_cur) <= depth_threshold
    mesh_ok = gbuf.instance.float() == gather(prev_gbuf.instance)
    normal_ok = (gbuf.normal.float() * gather(prev_gbuf.normal)).sum(-1) >= normal_threshold
    valid = on_screen & depth_ok & mesh_ok & normal_ok

    prev_col = load01(gather(prev_color)[..., :3])
    hist_prev = gather(prev_history).to(torch.int32)
    mom_prev = gather(prev_moments)

    history = torch.where(
        valid, torch.clamp_max(hist_prev + 1, history_base_length), 1
    ).to(torch.int32)
    alpha = torch.where(valid, 1.0 / history.float(), 1.0)

    lum = luminance(cur)
    mom_cur = torch.stack([lum, lum * lum], dim=-1)
    mom_prev = torch.where(valid[..., None], mom_prev, 0.0)
    moments = mom_prev + (mom_cur - mom_prev) * alpha[..., None]
    variance = clip(moments[..., 1] - moments[..., 0] ** 2, 0.0)

    prev_col = torch.where(valid[..., None], prev_col, 0.0)
    new_col = prev_col + (cur - prev_col) * alpha[..., None]

    out = store01(torch.cat([new_col, variance[..., None]], dim=-1))
    return TemporalResult(color=out, moments=moments, history_len=history, reprojected=valid)


def temporal_filter_band(current, prev_color, gbuf: GBuffer, prev_gbuf: GBuffer,
                         prev_moments, prev_history, depth_threshold: float,
                         normal_threshold: float, history_base_length: int,
                         row0: int, h_total: int) -> TemporalResult:
    """The temporal filter of one row band under K7's motion bound
    (svgf_tpu/kernels/temporal_pallas.py:80-88): the band's first row is
    global `row0` of an `h_total`-row image, and the prev_* arrays are a
    window of Hs + 2*BOUND_Y rows whose first row is global row0 - BOUND_Y
    (zero outside the image). A target is gathered when it is on the
    screen and |my| <= BOUND_Y, |mx| <= BOUND_X; any other motion is a
    disocclusion. The whole frame is the band row0=0, h_total=H with
    BOUND_Y zero rows above and below."""
    return temporal_filter(current, prev_color, gbuf, prev_gbuf, prev_moments, prev_history,
                           depth_threshold, normal_threshold, history_base_length,
                           row0=row0, prev_row0=row0 - BOUND_Y, full_h=h_total,
                           motion_bound=(BOUND_Y, BOUND_X))


# ---------------------------------------------------------------------------
# 2. spatial moments fallback (Filter.cuh:430-525)
# ---------------------------------------------------------------------------


def filter_moments(color, moments, gbuf: GBuffer, history_len,
                   phi_colour: float, phi_normal: float):
    """7x7 cross-bilateral re-estimation of illumination + variance for
    pixels with history < 4 and valid depth; pass-through otherwise."""
    h, w = color.shape[:2]
    dev = color.device
    illum = color.float()  # read raw (Half4ToVec4, no clamp :450)
    mom = moments.float()
    l_center = luminance(illum[..., :3])
    z = get_depth(gbuf.depth)
    n = gbuf.normal.float()
    phi_depth = clip(gbuf.depth_deriv.float(), 1e-8) * 3.0

    sum_w = torch.zeros((h, w), device=dev)
    sum_illum = torch.zeros((h, w, 3), device=dev)
    sum_mom = torch.zeros((h, w, 2), device=dev)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            dist = float((dx * dx + dy * dy) ** 0.5)
            illum_p = _shift(illum[..., :3], dy, dx)
            mom_p = _shift(mom, dy, dx)
            wgt = compute_weight(
                z, _shift(z, dy, dx), phi_depth * dist, n, _shift(n, dy, dx),
                phi_normal, l_center, luminance(illum_p), phi_colour,
            )
            wgt = torch.where(_inside(h, w, dy, dx, dev), wgt, 0.0)
            sum_w = sum_w + wgt
            sum_illum = sum_illum + illum_p * wgt[..., None]
            sum_mom = sum_mom + mom_p * wgt[..., None]

    sum_w = clip(sum_w, 1e-6)
    f_illum = sum_illum / sum_w[..., None]
    f_mom = sum_mom / sum_w[..., None]
    hist = torch.clamp_min(history_len.float(), 1.0)
    variance = (f_mom[..., 1] - f_mom[..., 0] ** 2) * (4.0 / hist)
    fallback = torch.cat([f_illum, variance[..., None]], dim=-1)

    # invalid-depth (background) pixels pass through, as in the a-trous step
    use_fallback = (history_len < 4) & (z < INVALID_DEPTH)
    return torch.where(use_fallback[..., None], fallback, illum)


# ---------------------------------------------------------------------------
# 3. a-trous wavelet iteration (Filter.cuh:527-624)
# ---------------------------------------------------------------------------

_KERNEL_1D = (1.0, 2.0 / 3.0, 1.0 / 6.0)  # Filter.cuh:540


def atrous_iteration(img, gbuf: GBuffer, step: int, phi_colour: float, phi_normal: float):
    """One 5x5 edge-stopping wavelet iteration with dilation `step`."""
    h, w = img.shape[:2]
    dev = img.device
    center = load01(img)                       # imageLoad clamps (:543)
    l_center = luminance(center[..., :3])
    variance = center[..., 3]
    z = get_depth(gbuf.depth)
    n = gbuf.normal.float()
    phi_l = phi_colour * torch.sqrt(clip(1e-10 + variance, 0.0))
    phi_depth = clip(gbuf.depth_deriv.float(), 1e-6) * step

    # center pre-accumulated with weight 1 (:565-568)
    sum_w = torch.ones((h, w), device=dev)
    sum_c = center
    for dy in (-2, -1, 0, 1, 2):
        for dx in (-2, -1, 0, 1, 2):
            if dx == 0 and dy == 0:
                continue
            oy, ox = dy * step, dx * step
            kernel = float(_KERNEL_1D[abs(dx)] * _KERNEL_1D[abs(dy)])
            dist = float((dx * dx + dy * dy) ** 0.5)
            pix = load01(_shift(img, oy, ox))
            wgt = compute_weight(
                z, _shift(z, oy, ox), phi_depth * dist, n, _shift(n, oy, ox),
                phi_normal, l_center, luminance(pix[..., :3]), phi_l,
            )
            wgt = torch.where(_inside(h, w, oy, ox, dev), wgt * kernel, 0.0)
            # variance channel uses squared weights (:606-608)
            w4 = torch.stack([wgt, wgt, wgt, wgt * wgt], dim=-1)
            sum_w = sum_w + wgt
            sum_c = sum_c + w4 * pix

    norm = torch.stack([sum_w, sum_w, sum_w, sum_w * sum_w], dim=-1)
    filtered = sum_c / norm
    # invalid depth -> pass-through (:554-558)
    return torch.where((z >= INVALID_DEPTH)[..., None], center, filtered)


def wavelet_filter(img, gbuf: GBuffer, steps: int, phi_colour: float, phi_normal: float):
    """The wavelet loop (App.cu:491-514): `steps` iterations with step
    1, 2, 4, .... Returns (final, feedback, second_last): `feedback` is
    iteration 0's output (next frame's temporal history, Filter.cuh:619-622)."""
    feedback = prev = out = img
    for i in range(steps):
        prev = out
        out = atrous_iteration(out, gbuf, 1 << i, phi_colour, phi_normal)
        if i == 0:
            feedback = out
    return out, feedback, prev


# ---------------------------------------------------------------------------
# 4. TAA + sRGB (Filter.cuh:288-357)
# ---------------------------------------------------------------------------

# PAL YUV matrices, applied as scalar arithmetic in svgf_tpu's order.
_YUV_ENC = (
    (0.299, 0.587, 0.114),
    (-0.14713, -0.28886, 0.436),
    (0.615, -0.51499, -0.10001),
)
_YUV_DEC = (
    (1.0, 0.0, 1.13983),
    (1.0, -0.39465, -0.58060),
    (1.0, 2.03211, 0.0),
)


def _encode_pal_yuv(rgb):
    rgb = clip(rgb, 0.0)
    rgb = rgb * rgb
    ch = [rgb[..., 0], rgb[..., 1], rgb[..., 2]]
    return torch.stack(
        [m[0] * ch[0] + m[1] * ch[1] + m[2] * ch[2] for m in _YUV_ENC], dim=-1
    )


def _decode_pal_yuv(yuv):
    ch = [yuv[..., 0], yuv[..., 1], yuv[..., 2]]
    rgb = torch.stack(
        [m[0] * ch[0] + m[1] * ch[1] + m[2] * ch[2] for m in _YUV_DEC], dim=-1
    )
    return torch.sqrt(clip(rgb, 1e-12))


def taa(filtered, history):
    """Temporal antialiasing + sRGB (the main path's tonemap). `history` is
    the previous TAA output at any float dtype. The mix rate is fixed at 0.5
    (the reference's adaptive rate is dead code, PARITY.md)."""
    h, w = filtered.shape[:2]
    dev = filtered.device
    last = load01(history)
    in0 = load01(filtered)[..., :3]

    mix_rate = clip(last[..., 3], None, 0.5)
    aa = last[..., :3]
    aa = aa * aa + (in0 * in0 - aa * aa) * mix_rate[..., None]
    aa = torch.sqrt(clip(aa, 1e-12))

    rgb_in = filtered[..., :3]
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    neigh = []
    for dy, dx in [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)]:
        # border: clamped point sampling (imageLoad coordinate clamp :73-74)
        rr = torch.clamp(rows + dy, 0, h - 1)
        cc = torch.clamp(cols + dx, 0, w - 1)
        neigh.append(load01(rgb_in[rr][:, cc]))

    aa_yuv = _encode_pal_yuv(aa)
    in_yuv = [_encode_pal_yuv(in0)] + [_encode_pal_yuv(x) for x in neigh]
    first5 = torch.stack(in_yuv[:5])
    rest4 = torch.stack(in_yuv[5:])
    min_c = first5.amin(0)
    max_c = first5.amax(0)
    min_c = 0.5 * min_c + 0.5 * torch.minimum(rest4.amin(0), min_c)
    max_c = 0.5 * max_c + 0.5 * torch.maximum(rest4.amax(0), max_c)

    aa_yuv = torch.minimum(torch.maximum(aa_yuv, min_c), max_c)
    rgb = _decode_pal_yuv(aa_yuv)
    ok = torch.isfinite(rgb).all(-1, keepdim=True)
    rgb = torch.where(ok, rgb, 0.0)  # NaN scrub (:351)
    out = torch.cat([to_srgb(rgb), torch.ones((h, w, 1), device=dev)], dim=-1)
    return store01(out)
