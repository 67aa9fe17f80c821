#!/usr/bin/env python3
"""Smoke test of svgf_tpu_torch on one CUDA card.

Run from the root of the repository:

    python3 chip_smoke.py

Phases, each failing loudly (no phase catches an exception):
  1. the card: CUDA must be available; prints nvidia-smi's name and power limit;
  2. build: compiles svgf_tpu_torch/csrc into one library (prints seconds and
     ptxas' register report);
  3. each filter kernel against its plain torch version on the card at
     1920x1080, on seeded inputs with disocclusions, background and large
     motion; prints both times (CUDA events) and the errors;
  4. the main path: Renderer.step on the Cornell box at 1920x1080, 5 a-trous
     steps, fp16 state, for FRAMES frames with a small camera orbit, through
     the kernels; checks the launch counts per frame, that the image is finite
     and in [0, 1], and that the last frame matches the same frames run
     through the plain versions; prints frame and per-stage milliseconds and
     rays traced.
The last lines are the nvidia-smi line, a JSON line of the kernels, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 1080, 1920
FRAMES = 4
# 2 lane chunks: (2 x 1,036,800 rays) x 36 triangles per intersect temporary.
# The plain torch trace is launch-bound, so fewer, larger chunks are faster
# (PERF.md section 5).
TRACE_CHUNKS = 2
TIMED_ITERS = 20

# name, source, the TPU kernel it replaces (svgf_tpu, file:line of the function)
KERNELS = (
    ("temporal", "svgf_tpu_torch/csrc/temporal.cu", "svgf_tpu/kernels/planar.py:454"),
    ("moments", "svgf_tpu_torch/csrc/moments.cu", "svgf_tpu/kernels/planar.py:721"),
    ("atrous", "svgf_tpu_torch/csrc/atrous.cu", "svgf_tpu/kernels/planar.py:918"),
    ("taa", "svgf_tpu_torch/csrc/taa.cu", "svgf_tpu/kernels/planar.py:1153"),
)


def log(*args) -> None:
    print(*args, flush=True)


def check_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def build_kernels() -> float:
    from svgf_tpu_torch.kernels import build

    t0 = time.perf_counter()
    _, report = build.build(("-Xptxas", "-v"))
    build.library()
    seconds = time.perf_counter() - t0
    for line in report.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("ptxas:", line.strip())
    log(f"build: {seconds:.3f} s")
    return seconds


def cuda_ms(fn, iters: int = TIMED_ITERS) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def frame_inputs(seed: int = 0):
    """A 1080p frame's radiance, G-buffer and fp16 previous state, from a
    seeded NumPy generator. The current G-buffer is the previous one seen
    through the motion vectors (plus depth noise), so most pixels
    reproject; 10% land on another instance (disocclusions), 20% are
    background, motion is mostly within (6, 40) px and 5% of pixels move
    up to 300 px (the unbounded gather)."""
    from svgf_tpu_torch.render.types import GBuffer, TemporalState

    rng = np.random.default_rng(seed)
    n_prev = rng.standard_normal((H, W, 3))
    n_prev /= np.linalg.norm(n_prev, axis=-1, keepdims=True)
    depth_prev = rng.uniform(1, 5, (H, W))
    inst_prev = rng.integers(0, 3, (H, W))
    far = rng.uniform(size=(H, W)) < 0.05
    motion = np.stack([
        np.where(far, rng.uniform(-300, 300, (H, W)), np.trunc(rng.uniform(-40, 40, (H, W)))),
        np.where(far, rng.uniform(-300, 300, (H, W)), np.trunc(rng.uniform(-6, 6, (H, W)))),
    ], axis=-1)
    py = np.clip(np.arange(H)[:, None] + np.trunc(motion[..., 1]).astype(int), 0, H - 1)
    px = np.clip(np.arange(W)[None, :] + np.trunc(motion[..., 0]).astype(int), 0, W - 1)
    depth = depth_prev[py, px] + rng.uniform(-0.05, 0.05, (H, W))
    n = n_prev[py, px]
    inst = np.where(rng.uniform(size=(H, W)) < 0.1, (inst_prev[py, px] + 1) % 3, inst_prev[py, px])
    bg = rng.uniform(size=(H, W)) < 0.2
    depth = np.where(bg, 0.0, depth)
    n = np.where(bg[..., None], 0.0, n)
    inst = np.where(bg, -1, inst)

    cuda = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device="cuda")
    gbuf = GBuffer.zeros(H, W, device="cuda")._replace(
        depth=cuda(depth), depth_deriv=cuda(rng.uniform(1e-4, 1e-2, (H, W))),
        normal=cuda(n), instance=cuda(inst, torch.int32), motion=cuda(motion),
    )
    f16 = torch.float16
    state = TemporalState(
        color=cuda(rng.uniform(0, 1, (H, W, 4)), f16),
        moments=cuda(rng.uniform(0, 0.5, (H, W, 2)), f16),
        history_len=cuda(rng.integers(1, 24, (H, W)), torch.int32),
        taa_history=cuda(rng.uniform(0, 1, (H, W, 4)), f16),
        gbuffer=GBuffer.zeros(H, W, f16, device="cuda")._replace(
            depth=cuda(depth_prev, f16), normal=cuda(n_prev, f16),
            instance=cuda(inst_prev, torch.int32),
        ),
        frame_idx=0,
    )
    return cuda(rng.uniform(0, 1, (H, W, 3))), gbuf, state


def assert_stage(name, got, want, exact_tol=None):
    """Per-stage tolerances of tests/test_planar.py assert_stage_parity:
    atol 3e-5 for the temporal stage; downstream of the variance-guided
    weights, mean < 1e-4 and no pixel above 2e-2."""
    d = (got.float() - want.float()).abs()
    max_err, mean_err = float(d.max()), float(d.mean())
    log(f"  {name}: max_abs_err {max_err:.3e} mean_abs_err {mean_err:.3e}")
    if exact_tol is not None:
        assert max_err <= exact_tol, (name, max_err)
    else:
        assert mean_err < 1e-4, (name, mean_err)
        assert float((d > 2e-2).float().mean()) == 0.0, (name, max_err)
    return max_err


def check_kernels() -> dict:
    from svgf_tpu_torch.config import SVGFConfig
    from svgf_tpu_torch.kernels import filter as K
    from svgf_tpu_torch.render import svgf as P

    sv = SVGFConfig(spatial_filter_steps=5)
    radiance, gbuf, state = frame_inputs()
    t_args = (radiance, state.color, gbuf, state.gbuffer, state.moments, state.history_len,
              sv.depth_threshold, sv.normal_threshold, sv.history_length)
    results = {}

    log("kernel vs plain, 1920x1080:")
    tk, tp = K.temporal_filter(*t_args), P.temporal_filter(*t_args)
    err = max(assert_stage("temporal.color", tk.color, tp.color, 3e-5),
              assert_stage("temporal.moments", tk.moments, tp.moments, 3e-5))
    assert torch.equal(tk.history_len, tp.history_len), "temporal history"
    assert torch.equal(tk.reprojected, tp.reprojected), "temporal reprojected"
    log(f"  temporal: {float(tp.reprojected.float().mean()) * 100:.2f}% reprojected")
    results["temporal"] = (err, lambda: K.temporal_filter(*t_args), lambda: P.temporal_filter(*t_args))

    m_args = (tp.color, tp.moments, gbuf, tp.history_len, sv.phi_colour, sv.phi_normal)
    mp = P.filter_moments(*m_args)
    err = assert_stage("moments", K.filter_moments(*m_args), mp)
    results["moments"] = (err, lambda: K.filter_moments(*m_args), lambda: P.filter_moments(*m_args))

    a_args = (mp, gbuf, sv.spatial_filter_steps, sv.phi_colour, sv.phi_normal)
    ak, ap = K.wavelet_filter(*a_args), P.wavelet_filter(*a_args)
    err = max(assert_stage("atrous.final", ak[0], ap[0]),
              assert_stage("atrous.feedback", ak[1], ap[1]))
    results["atrous"] = (err, lambda: K.wavelet_filter(*a_args), lambda: P.wavelet_filter(*a_args))

    x_args = (ap[0], state.taa_history)
    err = assert_stage("taa", K.taa(*x_args), P.taa(*x_args))
    results["taa"] = (err, lambda: K.taa(*x_args), lambda: P.taa(*x_args))

    timed = {}
    for name, (err, kernel, plain) in results.items():
        # plain, kernel, kernel, plain: both sides see the same card state
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
        timed[name] = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}
        log(f"  {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms"
            + (" (5-step chain)" if name == "atrous" else ""))
    return timed


def run_frames(use_pallas: str):
    """FRAMES frames of the 1080p Cornell box with a small orbit between
    frames. Returns (last FrameOutputs, per-frame stage milliseconds)."""
    from svgf_tpu_torch.config import RenderConfig, SVGFConfig
    from svgf_tpu_torch.core.camera import orbit_frame
    from svgf_tpu_torch.render.pipeline import Renderer
    from svgf_tpu_torch.scenes.cornell import cornell_box

    cfg = RenderConfig(
        width=W, height=H, svgf=SVGFConfig(spatial_filter_steps=5), state_dtype="float16",
        keep_taps=False, use_pallas=use_pallas, use_pallas_intersect="off",
        trace_chunks=TRACE_CHUNKS,
    )
    r = Renderer(cornell_box(aspect=16 / 9), cfg, device="cuda")
    stages = []
    out = None
    for f in range(FRAMES):
        if f:
            r.update_camera(orbit_frame([0.0, 0.0, 0.0], 3.4, theta=0.01 * f, phi=0.0))
        events = {}
        torch.cuda.synchronize()
        out = r.step(events)
        torch.cuda.synchronize()
        names = list(events)
        ms = {b: events[a].elapsed_time(events[b]) for a, b in zip(names, names[1:])}
        ms["frame"] = events[names[0]].elapsed_time(events[names[-1]])
        stages.append(ms)
    return out, stages


def check_main_path() -> dict:
    from svgf_tpu_torch.kernels import filter as K

    K.reset_launches()
    out, stages = run_frames("on")
    launches = dict(K.LAUNCHES)
    log(f"main path launches over {FRAMES} frames: {launches}")
    expect = {"temporal": FRAMES, "moments": FRAMES, "atrous": 5 * FRAMES, "taa": FRAMES}
    assert launches == expect, (launches, expect)

    final = out.final
    assert final.shape == (H, W, 3), final.shape
    assert bool(torch.isfinite(final).all()), "non-finite final image"
    assert float(final.min()) >= 0.0 and float(final.max()) <= 1.0, "final image outside [0, 1]"
    m = out.metrics
    log(f"metrics (frame {FRAMES}): coverage {float(m.coverage_pct):.2f}% disoccluded "
        f"{float(m.disoccluded_pct):.2f}% mean history {float(m.mean_history):.3f} "
        f"rays_traced {int(m.rays_traced)}")
    assert float(m.coverage_pct) > 50.0, "the camera does not see the box"
    assert float(final.mean()) > 0.05, "the final image is black"

    plain_out, plain_stages = run_frames("off")
    d = (final - plain_out.final).abs()
    log(f"frame {FRAMES} final, kernels vs plain on the card: max {float(d.max()):.3e} "
        f"mean {float(d.mean()):.3e}")
    assert float(d.mean()) < 1e-3 and float(d.max()) <= 5e-2, (float(d.mean()), float(d.max()))

    for label, st in (("kernels", stages), ("plain", plain_stages)):
        med = {k: statistics.median(s[k] for s in st[1:]) for k in st[0]}
        log(f"{label} frame ms (median of frames 2-{FRAMES}): {med['frame']:.3f}; per stage: "
            + ", ".join(f"{k} {v:.3f}" for k, v in med.items() if k != "frame"))
        log(f"{label} frame ms, every frame: {[round(s['frame'], 3) for s in st]}")
    return launches


def main() -> int:
    smi = check_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    timed = check_kernels()
    launches = check_main_path()
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **timed[name]}
        for name, src, rep in KERNELS
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
