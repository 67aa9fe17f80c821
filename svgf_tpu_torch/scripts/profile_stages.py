"""Each SVGF filter stage timed alone: the port's copy of svgf_tpu's
scripts/profile_stages.py, the counterpart of the reference's per-frame
timer prints (App.cu:697-731).

On seeded random inputs at the frame's size (default 1080x1920), K = 10
calls a rep of each stage: the plain versions (render/svgf.py; svgf_tpu's
"XLA" rows), the plain index gather of temporal's 12-channel payload, and
the kernels through their wrappers (kernels/filter.py; svgf_tpu's "Pallas"
rows): K1, K2, the à-trous step of widths 1 and 16 (K9b's wrapper, K3's
step kernel), K3's 5-step chain and K4. svgf_tpu's "pack_prev_planes
alone" row has no counterpart: the port keeps its state in one HWC layout
and packs nothing. Each row: timing.timed's figures, the port function it
times under "port" (printed beside the row).

The labels are svgf_tpu's, but its "Pallas" rows time its band kernels:
temporal_filter_pallas (K7), filter_moments_pallas (K8), taa_pallas (K10),
and atrous_iteration_pallas (K9b) for the single steps and, five times,
for the chain. The port's rows of those labels time the full-frame
kernels K1, K2 and K4, K9b's wrapper for the single steps and K3's chain,
so a row is compared with svgf_tpu's of the same label only by function,
not by kernel.

Usage: python -m svgf_tpu_torch.scripts.profile_stages [height width]
"""

from __future__ import annotations

import sys

import numpy as np

K = 10


def stage_inputs(h: int, w: int, device):
    """svgf_tpu's script's inputs from numpy's generator under seed 0:
    (gbuf, img (h, w, 4), prev_moments, prev_hist)."""
    import torch

    from svgf_tpu_torch.render.types import GBuffer

    rng = np.random.default_rng(0)
    n = rng.standard_normal((h, w, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    gbuf = GBuffer.zeros(h, w, device=device)._replace(
        depth=f32(rng.uniform(1.0, 5.0, (h, w))),
        depth_deriv=f32(rng.uniform(1e-4, 1e-2, (h, w))),
        normal=f32(n),
        instance=torch.zeros((h, w), dtype=torch.int32, device=device),
        motion=f32(rng.uniform(-2, 2, (h, w, 2))),
    )
    img = f32(rng.uniform(0, 1, (h, w, 4)))
    prev_moments = f32(rng.uniform(0, 0.5, (h, w, 2)))
    prev_hist = torch.as_tensor(rng.integers(1, 24, (h, w)).astype(np.int32), device=device)
    return gbuf, img, prev_moments, prev_hist


def main(argv=None, device="cuda") -> list:
    import torch

    from svgf_tpu_torch.kernels import filter as KF
    from svgf_tpu_torch.render import svgf
    from svgf_tpu_torch.scripts.timing import fmt, report, timed

    argv = sys.argv[1:] if argv is None else argv
    h = int(argv[0]) if len(argv) > 0 else 1080
    w = int(argv[1]) if len(argv) > 1 else 1920
    print(f"device: {device}  frame: {w}x{h}", flush=True)
    gbuf, img, prev_moments, prev_hist = stage_inputs(h, w, device)
    cur = img[..., :3].contiguous()
    rows = []

    def report_row(label, port, fn):
        rows.append(timed(fn, K, device=device).row(label, port=port))
        print(fmt(rows[-1]), flush=True)

    # temporal's gather on its own: the 12-channel payload at pixel + trunc(motion)
    r = torch.arange(h, device=device)[:, None]
    c = torch.arange(w, device=device)[None, :]
    py = torch.clamp(r + gbuf.motion[..., 1].to(torch.int32), 0, h - 1)
    px = torch.clamp(c + gbuf.motion[..., 0].to(torch.int32), 0, w - 1)
    flat_idx = (py * w + px).reshape(-1)

    def gather12():
        packed = torch.cat([img, img, img], dim=-1).reshape(h * w, 12)
        return packed[flat_idx].reshape(h, w, 12)[..., :4]

    with torch.no_grad():
        report_row("temporal (XLA, packed gather)", "render/svgf.py temporal_filter",
                   lambda: svgf.temporal_filter(cur, img, gbuf, gbuf, prev_moments, prev_hist,
                                                0.8, 0.9, 24))
        report_row("gather alone (12ch f32)", "index gather", gather12)
        report_row("moments 7x7 (XLA)", "render/svgf.py filter_moments",
                   lambda: svgf.filter_moments(img, prev_moments, gbuf, prev_hist, 10.0, 128.0))
        report_row("atrous step=1 (XLA)", "render/svgf.py atrous_iteration",
                   lambda: svgf.atrous_iteration(img, gbuf, 1, 10.0, 128.0))
        report_row("taa (XLA)", "render/svgf.py taa", lambda: svgf.taa(img, img))

        report_row("temporal (Pallas)", "kernels/filter.py temporal_filter (K1)",
                   lambda: KF.temporal_filter(cur, img, gbuf, gbuf, prev_moments, prev_hist,
                                              0.8, 0.9, 24))
        report_row("taa (Pallas)", "kernels/filter.py taa (K4)", lambda: KF.taa(img, img))
        report_row("moments 7x7 (Pallas)", "kernels/filter.py filter_moments (K2)",
                   lambda: KF.filter_moments(img, prev_moments, gbuf, prev_hist, 10.0, 128.0))
        for s in (1, 16):
            report_row(f"atrous step={s} (Pallas)", "kernels/filter.py atrous_iteration (K9b)",
                       lambda s=s: KF.atrous_iteration(img, gbuf, s, 10.0, 128.0))
        report_row("atrous chain x5 (Pallas)", "kernels/filter.py wavelet_filter (K3)",
                   lambda: KF.wavelet_filter(img, gbuf, 5, 10.0, 128.0))
    report("profile_stages", device, rows, height=h, width=w)
    return rows


if __name__ == "__main__":
    main()
