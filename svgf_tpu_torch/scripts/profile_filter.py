"""The filter chain at 1080p, each stage's wrapper against its kernel alone:
the port's copy of svgf_tpu's scripts/profile_filter.py.

svgf_tpu's script splits each stage into its kernel and the packing and
layout around it. The port packs nothing, so its layout cost is its
wrappers': each row gives the wrapper's time (CUDA events, device and
host, timing.timed) beside the hand kernels' device time alone
(torch.profiler, `svgf_ms`), K = 5 calls a rep, best of 10, for K1, K2,
K3's chain of 1, 2 and 5 steps, K4 and the whole `filter_chain`, on the
port's copy of bench.py's steady-state orbit frame (`make_bench_inputs`).
svgf_tpu's "pack_prev_planes" row has no counterpart.

Usage: python -m svgf_tpu_torch.scripts.profile_filter
(main also takes `height` / `width` and `device`.)
"""

from __future__ import annotations

import numpy as np

K = 5


def make_bench_inputs(h: int, w: int, device="cuda"):
    """A steady-state orbit frame, the port's copy of bench.py's
    make_bench_inputs: smooth geometry with depth edges, a smooth
    mostly-horizontal motion field, and a warmed-up temporal state whose
    G-buffer is the current one, with history at its cap but for a ~3%
    disoccluded band (history 1-3). Returns (radiance (h, w, 3), gbuf,
    state). The state is fp16, the production state dtype (bench.py keeps
    its state in fp32 and packs an fp16 planar copy, which the kernels read)."""
    import torch

    from svgf_tpu_torch.render.types import GBuffer, TemporalState

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u, v = xx / w, yy / h

    # smooth depth with a few object edges; horizontal instance bands, so the
    # mostly-horizontal motion crosses an edge only near a band boundary
    depth = 2.0 + 1.5 * np.sin(3 * u * np.pi) * np.cos(2 * v * np.pi) + v
    instance = (np.floor(6 * v) % 4).astype(np.int32)
    depth = depth + 0.7 * instance
    depth_deriv = np.abs(np.gradient(depth, axis=1)) + 1e-4

    theta = 0.7 * u + 0.2 * v
    nrm = np.stack([np.sin(theta), np.cos(theta), 0.5 + 0.3 * np.sin(5 * v)], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)

    # orbit-camera motion: a mostly-horizontal pan with parallax by depth
    mx = np.trunc(28.0 / depth * (0.8 + 0.4 * u))
    my = np.trunc(4.0 * (v - 0.5))
    motion = np.stack([mx, my], axis=-1).astype(np.float32)

    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    gbuf = GBuffer.zeros(h, w, device=device)._replace(
        depth=f32(depth), depth_deriv=f32(depth_deriv), normal=f32(nrm),
        instance=torch.as_tensor(instance, device=device), motion=f32(motion),
    )

    hist = np.full((h, w), 24, np.int32)
    band = slice(int(0.55 * w), int(0.58 * w))
    hist[:, band] = rng.integers(1, 4, (h, hist[:, band].shape[1]))
    radiance = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)

    state = TemporalState.initial(h, w, torch.float16, device)._replace(
        color=f32(rng.uniform(0, 1, (h, w, 4))).to(torch.float16),
        moments=f32(rng.uniform(0, 0.5, (h, w, 2))).to(torch.float16),
        history_len=torch.as_tensor(hist, device=device),
        taa_history=f32(rng.uniform(0, 1, (h, w, 4))).to(torch.float16),
        gbuffer=gbuf.to_dtype(torch.float16),
    )
    return f32(radiance), gbuf, state


def main(argv=None, device="cuda", height: int = 1080, width: int = 1920) -> list:
    import torch

    from svgf_tpu_torch.config import RenderConfig, SVGFConfig
    from svgf_tpu_torch.kernels import filter as KF
    from svgf_tpu_torch.render.pipeline import filter_chain
    from svgf_tpu_torch.scripts.timing import fmt, kernel_mode, report, timed

    h, w = height, width
    print(f"device: {device}  frame: {w}x{h}", flush=True)
    config = RenderConfig(width=w, height=h, svgf=SVGFConfig(spatial_filter_steps=5),
                          use_pallas=kernel_mode(device))
    sv = config.svgf
    radiance, gbuf, state = make_bench_inputs(h, w, device)
    rows = []

    def t(label, port, fn):
        rows.append(timed(fn, K, reps=10, device=device).row(label, port=port))
        r = rows[-1]
        split = "" if r["svgf_ms"] is None else \
            f"  wrapper - kernels alone {r['device_ms'] - r['svgf_ms']:.4f} ms"
        print(fmt(r) + split, flush=True)

    def temporal():
        return KF.temporal_filter(radiance, state.color, gbuf, state.gbuffer, state.moments,
                                  state.history_len, depth_threshold=sv.depth_threshold,
                                  normal_threshold=sv.normal_threshold,
                                  history_base_length=sv.history_length)

    with torch.no_grad():
        print("== temporal ==", flush=True)
        t("temporal kernel (pre-packed)", "kernels/filter.py temporal_filter (K1)", temporal)
        tres = temporal()
        moments = lambda: KF.filter_moments(tres.color, tres.moments, gbuf, tres.history_len,
                                            phi_colour=sv.phi_colour, phi_normal=sv.phi_normal)
        print("== moments ==", flush=True)
        t("moments kernel", "kernels/filter.py filter_moments (K2)", moments)
        mom = moments()
        print("== a-trous ==", flush=True)
        for steps in (1, 2, 5):
            t(f"atrous chain steps={steps}", "kernels/filter.py wavelet_filter (K3)",
              lambda s=steps: KF.wavelet_filter(mom, gbuf, s, sv.phi_colour, sv.phi_normal))
        print("== taa ==", flush=True)
        t("taa kernel", "kernels/filter.py taa (K4)", lambda: KF.taa(mom, state.taa_history))
        print("== whole chain (pipeline.filter_chain) ==", flush=True)
        t("filter_chain", "render/pipeline.py filter_chain",
          lambda: filter_chain(radiance, gbuf, state, config)[3])
    report("profile_filter", device, rows, height=h, width=w)
    return rows


if __name__ == "__main__":
    main()
