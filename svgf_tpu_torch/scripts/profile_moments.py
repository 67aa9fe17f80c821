"""K2's fallback cost alone: the port's copy of svgf_tpu's
scripts/profile_moments.py.

Times K2 (kernels/filter.py filter_moments) at 1080p on the geometry of
bench.py's steady-state frame (profile_filter.make_bench_inputs) with three
history fields: (a) all 24, every pixel passes through (the kernel's floor);
(b) all 1, every pixel takes the 7x7 fallback; (c) bench-like bands, history
1 in columns [0.55w, 0.58w) and the last 64. K = 10 calls a rep, best of
10, with timing.timed's figures. The fallback's cost a fallback pixel is
((b) - (a)) / (h*w), by the events and by the kernel alone. svgf_tpu
reports it per tile of its planar layout; the port has no tiles, so it
reports it per pixel.

Usage: python -m svgf_tpu_torch.scripts.profile_moments
(main also takes `height` / `width` and `device`.)
"""

from __future__ import annotations

import numpy as np

K = 10


def history_cases(h: int, w: int) -> dict:
    """svgf_tpu's three history fields, by their labels."""
    bands = np.full((h, w), 24, np.int32)
    bands[:, int(0.55 * w):int(0.58 * w)] = 1
    bands[:, -64:] = 1   # the right-edge disocclusion band of a pan
    return {"all history=24 (pass-through)": np.full((h, w), 24, np.int32),
            "all history=1 (all fallback)": np.full((h, w), 1, np.int32),
            "bench-like bands": bands}


def main(argv=None, device="cuda", height: int = 1080, width: int = 1920) -> list:
    import torch

    from svgf_tpu_torch.config import SVGFConfig
    from svgf_tpu_torch.kernels import filter as KF
    from svgf_tpu_torch.scripts.profile_filter import make_bench_inputs
    from svgf_tpu_torch.scripts.timing import fmt, report, timed

    h, w = height, width
    sv = SVGFConfig()
    print(f"device: {device}  frame: {w}x{h}", flush=True)
    _, gbuf, _ = make_bench_inputs(h, w, device)
    rng = np.random.default_rng(0)
    color = torch.as_tensor(rng.uniform(0, 1, (h, w, 4)).astype(np.float32), device=device)
    mom = torch.as_tensor(rng.uniform(0, 0.5, (h, w, 2)).astype(np.float32), device=device)

    rows = []
    with torch.no_grad():
        for label, hist in history_cases(h, w).items():
            hist = torch.as_tensor(hist, device=device)
            fn = lambda hist=hist: KF.filter_moments(color, mom, gbuf, hist, sv.phi_colour,
                                                     sv.phi_normal)
            rows.append(timed(fn, K, reps=10, device=device).row(
                label, fallback_pixels=int((hist < 4).sum())))
            print(fmt(rows[-1]), flush=True)
    a, b = rows[0], rows[1]
    per_pixel = {"events_ns": (b["device_ms"] - a["device_ms"]) / (h * w) * 1e6}
    if a["svgf_ms"] is not None and b["svgf_ms"] is not None:
        per_pixel["alone_ns"] = (b["svgf_ms"] - a["svgf_ms"]) / (h * w) * 1e6
    print(f"pixels={h * w} (no tiles in the port: the cost is per fallback pixel, not per "
          f"tile); fallback cost a pixel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in per_pixel.items()), flush=True)
    report("profile_moments", device, rows, height=h, width=w, fallback_cost_per_pixel=per_pixel)
    return rows


if __name__ == "__main__":
    main()
