#!/usr/bin/env python3
"""Smoke test of svgf_tpu_torch on one CUDA card.

Run from the root of the repository:

    python3 chip_smoke.py

Phases, each failing loudly (no phase catches an exception):
  1. the card: CUDA must be available; prints nvidia-smi's name and power limit;
  2. build: compiles svgf_tpu_torch/csrc, one nvcc per source started
     together, into one library (prints seconds and ptxas' register report);
  3. each filter kernel (K1-K4) against its plain torch version on the card
     at 1920x1080, on seeded inputs with disocclusions, background and large
     motion; prints both times (CUDA events) and the errors, K3's step
     kernel alone at each of the chain's five widths, and K2 again on an
     input whose fallback pixels lie in disocclusion bands; K1 and K4 again
     with bf16 and fp32 state, and K4 bit for bit with each history type on
     colour and history with NaN and out-of-range pixels; K4 with each
     history type through its wrapper and alone;
  4. the dense intersector kernel (K5) against its plain version on the
     1080p Cornell box: the primary rays and 2,073,600 seeded secondary rays
     from inside the box, plain and with an active mask, a per-ray tmax and
     only_instance=3; on each case the Hit the kernel writes against the
     torch recompute of its winner (bit for bit on every lane); one call
     without grad is one device kernel, and with grad it keeps the graph;
  5. the scene-BVH intersector kernel (K6) against its plain walk on the
     104,884-triangle stress terrain: the 2,088,960 block-ordered 1080p
     primary rays and 65,536 scrambled rays (plain, and with an active mask
     and tmax, and only_instance=1); on each case the Hit the kernel writes
     against the torch recompute of its winner (bit for bit on every lane);
     one call without grad is one device kernel; prints Mrays/s, the kernel
     alone on both ray sets, and the visits a ray of the skip-link walk
     and of the kernel's nearest-first walk (with a warp's most); its bound
     is on its own records and tests, with the same formula on the
     skip-link walk's counts beside it (`yardstick_bound_ms`);
  6. the main path: Renderer.step on the Cornell box at 1920x1080, 5 a-trous
     steps, fp16 state, for FRAMES frames with a small camera orbit, through
     the kernels; checks the launch counts per frame, that the image is finite
     and in [0, 1], and that the last frame matches the same frames run
     through the plain versions; prints frame and per-stage milliseconds and
     rays traced, and profiles one more frame (the device's busy share and
     the operations with the most device time, and its device time and
     kernel count against the frame's before K5 wrote its Hit); then the
     same frames with bfloat16 state, with the same launch counts, against
     the plain route's;
  7. the stress path: the same on the stress terrain at 1920x1080 through
     the kernels (K1-K4, K6), and kernels against plain at 480x270;
  8. the band kernels of the row-sharded route (K7-K10) at 1080p: the frame
     cut into four 270-row bands, each band's halos cut from the whole-frame
     tensors as its neighbours would send them (zero rows, or edge rows for
     TAA, beyond the image); each kernel against its plain version on every
     band and on the one 1080-row band of a one-rank route, the stitched
     bands against the whole-frame K1, K2, K3-step and K4 outputs (K8,
     K9b and K10 with max error 0); times of each band and of the
     whole-frame band; K7 and K10 again with bf16 and fp32 state;
  9. the row-sharded route: torch.distributed on NCCL with one rank on
     cuda:0, make_sharded_step for FRAMES Cornell 1080p frames as in phase
     6; checks the launches per frame (K7 1, K8 1, K9b 5, K10 1, and the
     intersector's), the image, and frame FRAMES against the unsharded
     Renderer's; prints frame and stage milliseconds; then the same
     frames with bf16 state;
 10. K2's block gate and list against the same kernel without them, on
     the test frame and on the inputs of Cornell frames 2-4 and 16 and
     terrain frames 4 and 16: the fallback layout each sees, both kernels
     alone, and their outputs bit for bit equal;
 11. K6 on a scene BVH deeper than its 64-entry stack: the nested scene
     (100 heightfield sheets nested one in the next, depth 79; its walks
     keep the entries past the stack in K6's global scratch) on its 480x270
     primary rays and SCRAMBLED rays against the plain walk; on its 1080p
     primary rays the Hit against the recompute of its winner, visits a
     ray, Mrays/s and K6 alone, and K6's bound on them (the terrain's
     formula; the kernels line carries it and K6 alone as
     nested_bound_ms, nested_alone_ms); FRAMES 1080p frames through the
     kernels with launch counts, and a frame of kernels against plain at
     480x270 with one bounce (the plain walk is a host loop of thousands
     of steps on this scene);
 12. materials: Renderer.step on the materials scene (scenes/materials.py:
     PBR, mirror, glass and volumetric blocks, textured and normal-mapped
     walls with alpha, an environment) at 1920x1080 through K1-K5 for
     FRAMES frames of the Cornell orbit, with the launch counts that
     expected_launches derives from its SceneMeta (K5 also once per area
     light, bounce and chunk for the scatter event's only_instance
     re-trace), the image, frame FRAMES against the plain route's; prints
     frame and stage ms, rays traced, the K5 lanes a call, peak memory and
     a profiled frame beside the MATTE Cornell frame's; K5 alone on the
     frame's 3R-lane call and its only_instance call, with their bounds.
     Then the terrain with its material made PBR (the same arrays, the
     material fields replaced), whose bounces add a third segment: FRAMES
     1080p frames through K1-K4 and K6 with launch counts, K6 alone on its
     3R-lane call with its bound, and one frame of kernels against plain at
     480x270.
 14. gradients and the train steps (runs before 13): (a) the Cornell train
     step at 1920x1080 (3 bounces MIS, 5 a-trous steps, TAA, fp32 state,
     the plain filters: the filter kernels refuse autograd) with K5
     picking the winners and torch recomputing t/u/v, over {mat_colour,
     mat_emission, cam_frame} against a seeded target from a state one
     frame warm: finite loss and gradients, a colour gradient for every
     non-emissive material the camera sees, 8 K5 launches, forward,
     backward and step ms, peak memory, two identical steps' largest
     gradient difference, the step checkpointed (render_frame's
     checkpoint=True) and through the plain intersector (checkpointed)
     under the parity policy, the device kernels of the forward and the
     backward; (b) finite differences at 480x270 at the JAX tests' steps
     and bars (the camera's x and z translation on the interior-masked
     loss; the white wall's albedo and the light's emission through (c)
     the 4-frame orbit that differentiates through the carried state);
     (d) the terrain's 1080p train step with K6 ({mat_colour, cam_frame}),
     and at 480x270 against the plain walk under the parity policy; (e)
     make_train_step and (f) make_tiled_train_step on one NCCL rank (a
     1 x 1 tile mesh) against (a), and FRAMES tiled frames against the
     unsharded ones; (g) a frame on the kernel route with mat_colour
     requiring grad raises KernelAutogradError.
 13. scene I/O and edits (runs last: it moves the terrain's light):
     (a) the Cornell box at 1920x1080 through K1-K5, fp16 state, for 4
     frames, a wall recoloured by Renderer.update_material before frame 3
     (no packed scene made, K5's launches a frame unchanged) and the tall
     block moved by update_instance_transform before frame 4 (one packed
     scene made), frame 4 against the plain route with the same edits;
     prints each edit's host ms and the frames after them against frame
     2; (b) a checkpoint after frame 2 (io.save_checkpoint), a new
     Renderer resumed from it (io.load_checkpoint) renders frames 3-4
     with the same poses and edits, equal to the uninterrupted frames with
     max error 0, with fp16 and with bf16 state; prints the save and load
     seconds and the file's size; (c) Renderer.add_asset of a small OBJ
     (the frame stays on K5) and of a binary PLY of a 19,602-triangle
     heightfield (past DENSE_MAX_TRIS: the large-scene layout and K6),
     FRAMES frames with the launches expected_launches derives from the
     new SceneMeta, and a 480x270 frame of kernels against plain; (d) the
     terrain's light moved and scaled on phase 5's arrays (its stitched
     scene BVH, cluster bounds and light CDF rebuilt): K6 on its 1080p
     primary rays against the plain walk and the recompute of its winner,
     with the edit's host seconds, the repack's ms and the new depth; (e)
     the materials scene through io.save_scene_npz / load_scene_npz, its
     1080p frame 1 through K1-K5 equal to the original's bit for bit.
 15. the native builder, the per-shape walk and the orbit renderer (runs
     before 13): (a) the host library (csrc_host/bvh_builder.cpp, g++) and
     its build seconds (built right after the kernels); (b) the terrain
     flattened with the native builder, the port's default (phases 5-14
     keep the NumPy terrain and nested scene, pinned with SVGF_NATIVE=0):
     host seconds against phase 5's, both trees' node counts and depths,
     K6 on its 1080p primary and scrambled rays against the plain walk of
     the same tree (phase 5's bars, the Hit bit for bit), K6 alone and the
     records a ray visits on both trees, FRAMES 1080p frames through K1-K4
     and K6 with their launches and frame FRAMES against the plain route;
     (c) phase 13's asset import (an OBJ, then the 19,602-triangle PLY)
     with the native builder: add_asset's seconds, FRAMES frames through
     K6 and a 480x270 frame against plain; (d) on the native terrain K6
     with only_instance against the plain route's per-instance BLAS walk
     (traverse_shape), and intersect_brute_force on 4,096 rays against K6;
     (e) python -m svgf_tpu_torch.scripts.render_orbit's main on the
     Cornell box at 1920x1080 for ORBIT_FRAMES frames (frame ms, K1-K5
     launches a frame, the PNGs) and at its 640x360 default, then --resume
     for 3 frames, whose last frame equals the same frames rendered from
     the first run's state in memory (max error 0).
 16. svgf_tpu's quick start with only the package name changed (runs
     after phase 6): `from svgf_tpu_torch import RenderConfig`, `from
     svgf_tpu_torch.scenes import cornell_box`, Renderer on its default
     device at 640x360 with the configuration's defaults, then at
     __graft_entry__.entry()'s 512x288 (3 bounces, batch 1, 5 a-trous
     steps, fp16 state): FRAMES frames each with K1-K5's launches held to
     expected_launches, the image, frame FRAMES against the plain route
     (phase 6's bars), the frame ms beside the card's name and power
     limit; Hit.none on the card by default, and SceneArrays' counts of the
     card's arrays equal to the host flatten's.
 17. the measuring tools (svgf_tpu_torch/scripts/, runs before 13), each
     main on the card at its defaults: measure_balance (8 bands of the
     360x640 Cornell frame, 5 bounces) through K5 against the plain route
     (every band's live fraction within 1e-3); profile_trace at 1080p over
     48, 32, 8, 4, 2 and 1 trace chunks, the first frame's radiance equal
     at every count (max error 0), then the G-buffer alone;
     profile_trace_parts (259,200 lanes, 24 calls a rep), profile_stages
     (1080p), profile_filter (bench.py's frame) and profile_moments (three
     history fields); every row's launches in one rep held to what the part
     launches (K5 24 times for "intersect_scene (pallas)", none for the
     plain sweep), the profiler's record of every launch of the row's
     session, every time finite and > 0; prints each tool's rows and one
     JSON line of them beside the card's name and power limit.
 18. the gradient-debugging tools (svgf_tpu_torch/scripts/grad_bisect.py,
     grad_bisect2.py, grad_fd_explore.py; runs before 13): (a) each main on
     the card at its own size (24x16, 24x16, 40x32) against the same main
     on the CPU in this process: row names and finite flags equal, each
     cam_frame gradient within parallel/checks.py GRAD_RTOL of the largest
     (2e-2 for the rows the CPU tests show a rounding decides: hit_uv and
     the two frame rows), the FD rows' autograd values within 2e-3 and
     every relative FD error below 0.05, the interior mask equal, the
     primary rays' K5 winners against the CPU's plain sweep with the
     lanes that differ printed; (b) at 1920x1080
     grad_bisect's four K5 rows and grad_bisect2's 19 stages through K5
     against the same losses on the plain dense sweep on the card: finite
     flags equal, the gradients within GRAD_RTOL (2e-2 for the rows after
     the first shadow intersect only where the shadow or BSDF-sample
     winners differ, those lanes printed). Every row's K5 launches held to
     the tool's K5_CALLS; each row prints its forward + backward ms (CUDA
     events) and peak memory.
Each kernel-alone time, device-kernel count and profiled frame comes from
svgf_tpu_torch/scripts/timing.py profile_calls (a warm-up call and a
marker kernel a session, sessions repeated until the profiler recorded
every launch); a kernel-alone time fails unless it did.
Every kernel's row carries its bound: the larger of the bytes it must move
over 3.35 TB/s and its FP32 operations on these inputs over 67 TFLOP/s
(the H100 SXM's published peaks at 700 W).
The last lines are the nvidia-smi line, a JSON line of the kernels, and
{"ok": true, "device": {...}}.

`compare_times()` times the kernels a redesign should move with only the
wrappers' public calls and the helpers the phases time them with
(`time_call`, `timed_frames`), so that it can time an earlier checkout of the
port too: from that checkout's root,
    python3 -c "import importlib.util as u; s = u.spec_from_file_location('c', '<this file>'); \
c = u.module_from_spec(s); s.loader.exec_module(c); c.compare_times()"
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H, W = 1080, 1920
DEVICE = "cuda"
FRAMES = 4
# a frame of the steady state, where only disocclusions have history < 4
LATER_FRAME = 16
# 2 lane chunks: the 1080p frame's trace in two halves (PERF.md section 5).
TRACE_CHUNKS = 2
TIMED_ITERS = 20
STRESS_N = 230                # stress_scene(n=230): 104,884 world triangles
SMALL_H, SMALL_W = 270, 480   # the stress path's kernels-vs-plain frames
SCRAMBLED = 65536

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12       # H100 SXM FP32 outside the tensor cores
# FP32 operations of each function on its inputs, counted from the kernel
# sources (add, sub, mul, div, min, max, abs, compare, sqrt/exp/pow: one each)
OPS_TEMPORAL = 60        # a pixel
OPS_MOMENTS_TAP = 46     # a tap (49) of a fallback pixel; pass-through pixels none
OPS_ATROUS_TAP = 52      # a tap (24) of a valid-depth pixel, per step
OPS_TAA = 170            # a pixel (a PAL-YUV encode, the box's 48 min/max, mix, decode, sRGB)
OPS_MT = 55              # a ray-triangle test (Moller-Trumbore, verdict, best-so-far)
OPS_SLAB = 28            # a scene-BVH box test (slab test, verdict); K6 makes two a record
OPS_RECOMPUTE = 53       # a ray: the recompute of the winner's t/u/v
# the profiled Cornell 1080p frame's device time (ms) and device kernels
# when K5's wrapper still gathered and recomputed each Hit in torch
# (PERF.md section 5), the yardstick of the frame's launches
CORNELL_FRAME_BEFORE = (60.547, 6102)

# name, source, the TPU kernel it replaces (svgf_tpu, file:line of the function)
KERNELS = (
    ("temporal", "svgf_tpu_torch/csrc/temporal.cu", "svgf_tpu/kernels/planar.py:454"),
    ("moments", "svgf_tpu_torch/csrc/moments.cu", "svgf_tpu/kernels/planar.py:721"),
    ("atrous", "svgf_tpu_torch/csrc/atrous.cu", "svgf_tpu/kernels/planar.py:918"),
    ("taa", "svgf_tpu_torch/csrc/taa.cu", "svgf_tpu/kernels/planar.py:1153"),
    ("intersect_dense", "svgf_tpu_torch/csrc/intersect_dense.cu",
     "svgf_tpu/kernels/intersect_pallas.py:561"),
    ("intersect_clustered", "svgf_tpu_torch/csrc/intersect_clustered.cu",
     "svgf_tpu/kernels/intersect_pallas.py:489"),
    ("temporal_band", "svgf_tpu_torch/csrc/temporal.cu", "svgf_tpu/kernels/temporal_pallas.py:190"),
    ("moments_band", "svgf_tpu_torch/csrc/moments.cu", "svgf_tpu/kernels/moments_pallas.py:174"),
    # K9a, the HWC chain, is K3's function in the port's one layout: one call
    ("atrous_chain", "svgf_tpu_torch/csrc/atrous.cu", "svgf_tpu/kernels/atrous_pallas.py:324"),
    ("atrous_iteration", "svgf_tpu_torch/csrc/atrous.cu", "svgf_tpu/kernels/atrous_pallas.py:412"),
    ("taa_band", "svgf_tpu_torch/csrc/taa.cu", "svgf_tpu/kernels/taa_pallas.py:116"),
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


def cuda_ms(fn, iters: int = TIMED_ITERS, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_alone_ms(fn, iters: int = TIMED_ITERS, per_call: int | None = None) -> float:
    """Device milliseconds per fn() of the svgf:: kernels it launches, by
    torch.profiler (svgf_tpu_torch/scripts/timing.py profile_calls): the
    kernels alone, without the wrapper's host time or the gaps between
    launches that it leaves. Fails unless the profiler recorded every
    launch. `per_call`: the launches a call of fn for a launcher that no
    wrapper counts."""
    from svgf_tpu_torch.scripts.timing import profile_calls

    p = profile_calls(fn, iters, per_call=per_call)
    assert p.seen == p.launched > 0, f"the profiler saw {p.seen} of {p.launched} kernel launches"
    return sum(e.time_range.elapsed_us() for e in p.events if "svgf::" in e.name) / 1e3 / iters


def time_call(fn) -> dict:
    """fn()'s mean ms through its wrapper (events) and its kernels alone
    (profiler): the times that compare_times and the phases share."""
    return {"ms": cuda_ms(fn), "alone_ms": kernel_alone_ms(fn)}


def time_pair(name, kernel, plain, iters=TIMED_ITERS, plain_iters=TIMED_ITERS, plain_warmup=3):
    """Kernel and plain in turns plain, kernel, kernel, plain, so both see
    the same card state; returns {"ms", "plain_ms"}."""
    p1 = cuda_ms(plain, plain_iters, plain_warmup)
    k1, k2 = cuda_ms(kernel, iters), cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, plain_iters, plain_warmup)
    log(f"  {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over its memory rate, or operations
    over its FP32 rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": int(n_bytes), "bound_ops": int(n_ops)}


def cuda(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=DEVICE)


# ---------------------------------------------------------------------------
# K1-K4: the filter stages
# ---------------------------------------------------------------------------


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

    gbuf = GBuffer.zeros(H, W, device=DEVICE)._replace(
        depth=cuda(depth), depth_deriv=cuda(rng.uniform(1e-4, 1e-2, (H, W))),
        normal=cuda(n), instance=cuda(inst, torch.int32), motion=cuda(motion),
    )
    f16 = torch.float16
    state = TemporalState(
        color=cuda(rng.uniform(0, 1, (H, W, 4)), f16),
        moments=cuda(rng.uniform(0, 0.5, (H, W, 2)), f16),
        history_len=cuda(rng.integers(1, 24, (H, W)), torch.int32),
        taa_history=cuda(rng.uniform(0, 1, (H, W, 4)), f16),
        gbuffer=GBuffer.zeros(H, W, f16, device=DEVICE)._replace(
            depth=cuda(depth_prev, f16), normal=cuda(n_prev, f16),
            instance=cuda(inst_prev, torch.int32),
        ),
        frame_idx=0,
    )
    return cuda(rng.uniform(0, 1, (H, W, 3))), gbuf, state


# the state types a RenderConfig offers, as the kernels name them
STATE_TYPES = {"fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32}
# K4/K10 against svgf.taa: the same operations in the same order; powf
# and sqrtf may round an ulp apart from torch's (the filter kernels' bar)
TAA_TOL = 5.6e-6


def state_as(state, dtype):
    """frame_inputs' previous state with its float fields at `dtype`."""
    cast = lambda x: x.to(dtype) if x.is_floating_point() else x
    return state._replace(color=cast(state.color), moments=cast(state.moments),
                          taa_history=cast(state.taa_history),
                          gbuffer=type(state.gbuffer)(*map(cast, state.gbuffer)))


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


def with_outliers(x, rng):
    """x with 2% of its values drawn from [-1, 2) and 0.1% NaN."""
    y = x.float().cpu().numpy()
    u = rng.uniform(size=y.shape)
    y[u < 0.02] = rng.uniform(-1.0, 2.0, int((u < 0.02).sum()))
    y[u < 0.001] = np.nan
    return torch.as_tensor(y, device=x.device).to(x.dtype)


def check_filter_kernels() -> dict:
    from svgf_tpu_torch.config import SVGFConfig
    from svgf_tpu_torch.kernels import filter as K
    from svgf_tpu_torch.render import svgf as P

    sv = SVGFConfig(spatial_filter_steps=5)
    radiance, gbuf, state = frame_inputs()
    t_args = (radiance, state.color, gbuf, state.gbuffer, state.moments, state.history_len,
              sv.depth_threshold, sv.normal_threshold, sv.history_length)
    results = {}
    px = H * W

    log("filter kernels vs plain, 1920x1080:")
    tk, tp = K.temporal_filter(*t_args), P.temporal_filter(*t_args)
    err = max(assert_stage("temporal.color", tk.color, tp.color, 3e-5),
              assert_stage("temporal.moments", tk.moments, tp.moments, 3e-5))
    assert torch.equal(tk.history_len, tp.history_len), "temporal history"
    assert torch.equal(tk.reprojected, tp.reprojected), "temporal reprojected"
    log(f"  temporal: {float(tp.reprojected.float().mean()) * 100:.2f}% reprojected")
    b = bound(nbytes(radiance, state.color, gbuf.depth, gbuf.normal, gbuf.instance, gbuf.motion,
                     state.gbuffer.depth, state.gbuffer.normal, state.gbuffer.instance,
                     state.moments, state.history_len, *tp), px * OPS_TEMPORAL)
    results["temporal"] = (err, b, lambda: K.temporal_filter(*t_args),
                           lambda: P.temporal_filter(*t_args))

    m_args = moments_cases(tp, gbuf)["scattered"]
    mp = P.filter_moments(*m_args)
    err = check_moments("moments", K.filter_moments(*m_args), mp, tp.history_len, gbuf)
    results["moments"] = (err, moments_bound(m_args, mp), lambda: K.filter_moments(*m_args),
                          lambda: P.filter_moments(*m_args))

    a_args = (mp, gbuf, sv.spatial_filter_steps, sv.phi_colour, sv.phi_normal)
    ak, ap = K.wavelet_filter(*a_args), P.wavelet_filter(*a_args)
    err = max(assert_stage("atrous.final", ak[0], ap[0], 1e-5),
              assert_stage("atrous.feedback", ak[1], ap[1], 1e-5))
    valid = int((gbuf.depth != 0).sum())
    b = bound(nbytes(mp, gbuf.depth, gbuf.depth_deriv, gbuf.normal, *ap),
              sv.spatial_filter_steps * valid * 24 * OPS_ATROUS_TAP)
    results["atrous"] = (err, b, lambda: K.wavelet_filter(*a_args),
                         lambda: P.wavelet_filter(*a_args))

    x_args = (ap[0], state.taa_history)
    xp = P.taa(*x_args)
    err = assert_stage("taa", K.taa(*x_args), xp, TAA_TOL)
    results["taa"] = (err, bound(nbytes(*x_args, xp), px * OPS_TAA), lambda: K.taa(*x_args),
                      lambda: P.taa(*x_args))

    # K1 and K4 with the state at the other types a RenderConfig offers
    for label in ("bf16", "fp32"):
        st = state_as(state, STATE_TYPES[label])
        args = (radiance, st.color, gbuf, st.gbuffer, st.moments, st.history_len, *t_args[6:])
        tk2, tp2 = K.temporal_filter(*args), P.temporal_filter(*args)
        assert_stage(f"temporal, {label} state: color", tk2.color, tp2.color, 3e-5)
        assert_stage(f"temporal, {label} state: moments", tk2.moments, tp2.moments, 3e-5)
        assert torch.equal(tk2.history_len, tp2.history_len), (label, "temporal history")
        assert torch.equal(tk2.reprojected, tp2.reprojected), (label, "temporal reprojected")
        assert_stage(f"taa, {label} history", K.taa(ap[0], st.taa_history),
                     P.taa(ap[0], st.taa_history), TAA_TOL)
        t = time_call(lambda: K.temporal_filter(*args))
        log(f"  temporal, {label} state: {t['ms']:.5f} ms through the wrapper, {t['alone_ms']:.5f} "
            "ms alone")
    # K4 where the clamps it leaves out and the box's NaN rule count (csrc/taa.cu):
    # NaN and out-of-range colour and history, bit for bit
    rng = np.random.default_rng(5)
    odd = with_outliers(ap[0], rng)
    for label, dtype in STATE_TYPES.items():
        hist = with_outliers(state.taa_history.to(dtype), rng)
        got, want = K.taa(odd, hist), P.taa(odd, hist)
        black = float((want[..., :3] == 0).all(-1).float().mean())
        assert torch.equal(got, want), (label, float((got - want).abs().nan_to_num(1.0).max()))
        log(f"  taa, {label} history, NaN and out-of-range colour and history: bit-equal to "
            f"plain ({100 * black:.3f}% of pixels black)")

    timed = {}
    for name, (err, b, kernel, plain) in results.items():
        t = time_pair(name + (" (5-step chain)" if name == "atrous" else ""), kernel, plain)
        # no single PyTorch call computes these edge-stopping stencils
        timed[name] = {"max_abs_err": err, **t, **b, "library_ms": None}
        log(f"  {name}: bound {b['bound_ms']:.4f} ms by {b['bound_by']}; the kernel alone "
            f"(profiler) {kernel_alone_ms(kernel):.4f} ms")
    atrous_step_times(mp, gbuf)
    timed["moments"]["banded"] = moments_banded_times(tp, gbuf)
    timed["taa"].update(taa_times(ap[0], state))
    return timed


def taa_times(img, state) -> dict:
    """K4 at 1080p with fp16, bf16 and fp32 history: through its wrapper
    (events) and alone (profiler), each with its bound."""
    from svgf_tpu_torch.kernels import filter as K

    log(f"K4 (taa) at {W}x{H}, {K.TAA_TILE} tiles:")
    res = {}
    for label, dtype in STATE_TYPES.items():
        hist = state.taa_history.to(dtype)
        fn = lambda: K.taa(img, hist)
        b = bound(nbytes(img, hist, fn()), H * W * OPS_TAA)
        t = time_call(fn)
        res[label] = {**t, "bound_ms": b["bound_ms"]}
        log(f"  {label} history: {t['ms']:.5f} ms through the wrapper, {t['alone_ms']:.5f} ms alone; "
            f"bound {b['bound_ms']:.5f} ms by {b['bound_by']} ({100 * b['bound_ms'] / t['alone_ms']:.1f}% "
            f"of it alone)")
    return res


def check_moments(label, got, want, history_len, gbuf) -> float:
    """K2 or K8 against the plain filter_moments: the stage bars and a max
    error of at most 1e-5 (the same arithmetic, expf ulps apart)."""
    fallback = int(((history_len < 4) & (gbuf.depth != 0)).sum())
    log(f"  {label}: {fallback} fallback pixels ({100 * fallback / history_len.numel():.2f}%)")
    err = assert_stage(label, got, want)
    assert err <= 1e-5, (label, err)
    return err


def moments_bound(m_args, out) -> dict:
    color, moments, gbuf, history_len = m_args[:4]
    fallback = int(((history_len < 4) & (gbuf.depth != 0)).sum())
    return bound(nbytes(color, moments, gbuf.depth, gbuf.depth_deriv, gbuf.normal, history_len, out),
                 fallback * 49 * OPS_MOMENTS_TAP)


def moments_cases(tp, gbuf) -> dict:
    """K2's arguments on the 1080p test frame after K1 (`tp`): its
    scattered fallback pixels, and banded_history's disocclusion bands."""
    from svgf_tpu_torch.config import SVGFConfig

    sv = SVGFConfig(spatial_filter_steps=5)
    return {name: (tp.color, tp.moments, gbuf, hist, sv.phi_colour, sv.phi_normal)
            for name, hist in (("scattered", tp.history_len),
                               ("banded", banded_history(tp.history_len)))}


def banded_history(history_len):
    """history_len with its fallback pixels (history < 4) in 25-pixel
    disocclusion bands along slanted edges, as a moving object leaves them
    in a real frame, instead of scattered pixel by pixel: history 1 in
    the bands, at least 4 elsewhere. With frame_inputs' background about
    as many fallback pixels as the scattered case."""
    h, w = history_len.shape
    r = torch.arange(h, device=history_len.device)[:, None]
    c = torch.arange(w, device=history_len.device)[None, :]
    band = (c + r // 3) % 128 < 25
    return torch.where(band, torch.ones_like(history_len), torch.clamp_min(history_len, 4))


def moments_banded_times(tp, gbuf) -> dict:
    """K2 on the 1080p frame with banded fallback pixels (banded_history):
    against its plain version, its time by events (wrapper included) and
    alone, and its bound."""
    from svgf_tpu_torch.kernels import filter as K
    from svgf_tpu_torch.render import svgf as P

    m_args = moments_cases(tp, gbuf)["banded"]
    kernel, plain = lambda: K.filter_moments(*m_args), lambda: P.filter_moments(*m_args)
    want = plain()
    err = check_moments("moments, banded fallback", kernel(), want, m_args[3], gbuf)
    b = moments_bound(m_args, want)
    t = time_pair("moments, banded fallback", kernel, plain)
    alone = kernel_alone_ms(kernel)
    log(f"  moments, banded fallback: bound {b['bound_ms']:.4f} ms by {b['bound_by']}; the kernel "
        f"alone (profiler) {alone:.4f} ms")
    return {"max_abs_err": err, **t, "alone_ms": alone, "bound_ms": b["bound_ms"]}


@contextlib.contextmanager
def recording_moments(calls: list):
    """While the block runs, each filter_moments call of the kernels route
    also appends its (args, kwargs) to `calls`."""
    from svgf_tpu_torch.kernels import filter as K

    wrapper = K.filter_moments

    def record(*args, **kw):
        calls.append((args, kw))
        return wrapper(*args, **kw)

    K.filter_moments = record
    try:
        yield
    finally:
        K.filter_moments = wrapper


def frame_moments_inputs(label, scene, orbit, frames) -> dict:
    """K2's inputs at each of `frames` (counted from 1) of one run of the
    kernels route at 1080p from frame 0's camera: {"<label> frame <f>":
    (args, kwargs)}."""
    calls = []
    with recording_moments(calls):
        run_frames(scene, orbit, H, W, "on", TRACE_CHUNKS, frames=max(frames))
    return {f"{label} frame {f}": calls[f - 1] for f in frames}


def fallback_layout(history_len, depth) -> dict:
    """What K2's gate and list see: the fallback share, the share of blocks
    (32 x 16 tiles) that pass the gate, the pixels a passing block lists,
    and the warp passes of 49 taps with the list (ceil(n / 32) a block)
    and without it (each 32-pixel tile row that holds a fallback pixel)."""
    from svgf_tpu_torch.kernels.filter import MOMENTS_TILE

    ty, tx = MOMENTS_TILE
    fb = (history_len < 4) & (depth != 0)
    h, w = fb.shape
    gy, gx = -(-h // ty), -(-w // tx)
    grid = torch.zeros((gy * ty, gx * tx), dtype=torch.int32, device=fb.device)
    grid[:h, :w] = fb.to(torch.int32)
    rows = grid.view(gy, ty, gx, tx).sum(3)   # fallback pixels of each tile row
    n = rows.sum(1)
    passing = n > 0
    return {"fallback_pct": 100 * float(fb.float().mean()),
            "blocks_passing_pct": 100 * float(passing.float().mean()),
            "listed_a_passing_block": float(n[passing].float().mean()) if bool(passing.any()) else 0.0,
            "warp_passes_list": int(((n + 31) // 32).sum()),
            "warp_passes_in_place": int((rows > 0).sum())}


def moments_design_times(args, kw) -> dict:
    """K2's kernel with its gate and list (compact, the wrappers' call) and
    without them (in place), alone by the profiler, in turns: list, in
    place, in place, list. The two must write the same bits."""
    from svgf_tpu_torch.kernels import filter as K

    with_list = lambda: K._launch_moments(*args, **kw, compact=True)
    in_place = lambda: K._launch_moments(*args, **kw, compact=False)
    assert torch.equal(with_list(), in_place()), "K2 with and without its list differ"
    l1, p1, p2, l2 = (kernel_alone_ms(fn, per_call=1)
                      for fn in (with_list, in_place, in_place, with_list))
    return {"list_ms": (l1 + l2) / 2, "in_place_ms": (p1 + p2) / 2}


def check_moments_designs(cases: dict) -> dict:
    """K2's block gate and list against the same staged kernel without
    them, on each case's inputs {label: (args, kwargs)}: the test frame's
    scattered and banded fallback pixels, and the main path's own frames
    (Cornell 2-4, its timed frames, where nearly every covered pixel still
    has history < 4, and later frames, where only disocclusions do). Equal
    bits from both hold the kernel's own list: a pixel listed twice or
    not at all would differ."""
    log(f"K2 with its block gate and list against in place (no gate, each thread its own "
        f"pixels), the kernel alone (profiler), {W}x{H}:")
    res = {}
    for label, (args, kw) in cases.items():
        lay = fallback_layout(args[3], args[2].depth)
        t = moments_design_times(args, kw)
        log(f"  {label}: {lay['fallback_pct']:.2f}% fallback, {lay['blocks_passing_pct']:.2f}% of "
            f"blocks pass the gate listing {lay['listed_a_passing_block']:.1f} pixels each; warp "
            f"passes of 49 taps {lay['warp_passes_list']} listed, {lay['warp_passes_in_place']} in "
            f"place; list {t['list_ms']:.4f} ms, in place {t['in_place_ms']:.4f} ms "
            f"({t['in_place_ms'] / t['list_ms']:.3f}x)")
        res[label] = {**lay, **t}
    return res


def atrous_step_times(img, gbuf) -> dict:
    """K3's step kernel alone (profiler) and through its wrapper (events),
    one step of each width of the 5-step chain on the 1080p frame, with
    each step's bound (K3's per-step bytes and operations)."""
    from svgf_tpu_torch.config import SVGFConfig
    from svgf_tpu_torch.kernels import filter as K

    sv = SVGFConfig(spatial_filter_steps=5)
    valid = int((gbuf.depth != 0).sum())
    times = {}
    log("K3 step by step, 1920x1080:")
    for st in ATROUS_STEPS:
        step = lambda: K.atrous_iteration(img, gbuf, st, sv.phi_colour, sv.phi_normal)
        out = step()
        b = bound(nbytes(img, gbuf.depth, gbuf.depth_deriv, gbuf.normal, out),
                  valid * 24 * OPS_ATROUS_TAP)
        times[st] = {"alone_ms": kernel_alone_ms(step), "ms": cuda_ms(step), "bound_ms": b["bound_ms"]}
        log(f"  step {st}: alone {times[st]['alone_ms']:.4f} ms, wrapper {times[st]['ms']:.4f} ms, "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    return times


# ---------------------------------------------------------------------------
# K7-K10: the band kernels of the row-sharded route
# ---------------------------------------------------------------------------

NBANDS = 4                        # 270-row bands of the 1080p frame
ATROUS_STEPS = (1, 2, 4, 8, 16)   # K9b's steps in a 5-step frame


def halo_rows(x, r0: int, r1: int, halo: int, mode: str):
    """Rows [r0 - halo, r1 + halo) of the whole-frame tensor x, as the
    band's neighbours would send them; beyond the image, zero rows ("zero")
    or the image's edge row ("edge")."""
    h = x.shape[0]
    lo, hi = max(r0 - halo, 0), min(r1 + halo, h)
    fill = lambda rows, edge: (torch.zeros_like(x[:rows]) if mode == "zero"
                               else edge.expand((rows,) + tuple(x.shape[1:])))
    parts = [fill(lo - (r0 - halo), x[:1]), x[lo:hi], fill(r1 + halo - hi, x[-1:])]
    return torch.cat(parts).contiguous()


def temporal_band_call(radiance, gbuf, state, r0: int, r1: int) -> tuple:
    """K7 on the band [r0, r1) with its prev window of `state` (at the
    state's type): (kernel, plain, crop, bound)."""
    from svgf_tpu_torch.config import SVGFConfig
    from svgf_tpu_torch.kernels import filter as K
    from svgf_tpu_torch.render import svgf as P
    from svgf_tpu_torch.render.types import GBuffer

    sv = SVGFConfig(spatial_filter_steps=5)
    by = P.BOUND_Y
    zero = lambda x: halo_rows(x, r0, r1, by, "zero")
    g = GBuffer(*(x[r0:r1].contiguous() for x in gbuf))
    win = GBuffer(*(zero(x) for x in state.gbuffer))
    t_args = (radiance[r0:r1].contiguous(), zero(state.color), g, win, zero(state.moments),
              zero(state.history_len), sv.depth_threshold, sv.normal_threshold,
              sv.history_length, r0, H)
    px = (r1 - r0) * W
    t_bytes = nbytes(t_args[0], g.depth, g.normal, g.instance, g.motion, t_args[1], win.depth,
                     win.normal, win.instance, t_args[4], t_args[5]) + px * (16 + 8 + 4 + 1)
    return (lambda: K.temporal_filter_band(*t_args), lambda: P.temporal_filter_band(*t_args),
            lambda x: x, bound(t_bytes, px * OPS_TEMPORAL))


def taa_band_call(a_full, history, r0: int, r1: int) -> tuple:
    """K10 on the band [r0, r1) of the a-trous output and the TAA history
    (at its type), each extended by one edge row: (kernel, plain, crop,
    bound)."""
    from svgf_tpu_torch.kernels import filter as K
    from svgf_tpu_torch.render import svgf as P

    x_args = (halo_rows(a_full, r0, r1, 1, "edge"), halo_rows(history, r0, r1, 1, "edge"))
    px = (r1 - r0 + 2) * W
    return (lambda: K.taa_band(*x_args), lambda: P.taa(*x_args), lambda x: x[1:x.shape[0] - 1],
            bound(nbytes(*x_args) + px * 16, px * OPS_TAA))


def band_calls(radiance, gbuf, state, t_full, m_full, a_full, r0: int, r1: int) -> dict:
    """K7, K8, K9b (the five steps) and K10 on the band [r0, r1) of the
    frame: {name: (kernel, plain, crop, bound)}; `crop` keeps the band's
    rows of a result."""
    from svgf_tpu_torch.config import SVGFConfig
    from svgf_tpu_torch.kernels import filter as K
    from svgf_tpu_torch.render import svgf as P
    from svgf_tpu_torch.render.types import GBuffer

    sv = SVGFConfig(spatial_filter_steps=5)
    zero = lambda x, halo: halo_rows(x, r0, r1, halo, "zero")
    ext_gbuf = lambda halo: GBuffer(*(zero(x, halo) for x in gbuf))
    px = lambda halo: (r1 - r0 + 2 * halo) * W
    crop = lambda halo: (lambda x: x[halo:x.shape[0] - halo])

    g3 = ext_gbuf(3)
    m_args = (zero(t_full.color, 3), zero(t_full.moments, 3), g3,
              zero(torch.clamp_min(t_full.history_len, 1), 3), sv.phi_colour, sv.phi_normal)
    fallback = int(((m_args[3] < 4) & (g3.depth != 0)).sum())
    m_bytes = nbytes(*m_args[:2], g3.depth, g3.depth_deriv, g3.normal, m_args[3]) + px(3) * 16

    a_args = {st: (zero(m_full, 2 * st), ext_gbuf(2 * st), st, sv.phi_colour, sv.phi_normal)
              for st in ATROUS_STEPS}
    a_bytes = sum(nbytes(a[0], a[1].depth, a[1].depth_deriv, a[1].normal) + px(2 * st) * 16
                  for st, a in a_args.items())
    a_ops = sum(int((a[1].depth != 0).sum()) * 24 * OPS_ATROUS_TAP for a in a_args.values())
    a_crop = lambda outs: [crop(2 * st)(o) for st, o in zip(ATROUS_STEPS, outs)]

    return {
        "temporal_band": temporal_band_call(radiance, gbuf, state, r0, r1),
        "moments_band": (lambda: K.filter_moments_band(*m_args), lambda: P.filter_moments(*m_args),
                         crop(3), bound(m_bytes, fallback * 49 * OPS_MOMENTS_TAP)),
        "atrous_iteration": (lambda: [K.atrous_iteration(*a_args[st]) for st in ATROUS_STEPS],
                             lambda: [P.atrous_iteration(*a_args[st]) for st in ATROUS_STEPS],
                             a_crop, bound(a_bytes, a_ops)),
        "taa_band": taa_band_call(a_full, state.taa_history, r0, r1),
    }


def check_band_outputs(label, name, got, want) -> float:
    """A band kernel against its plain version on the same band."""
    if name == "temporal_band":
        assert torch.equal(got.history_len, want.history_len), (label, "history")
        assert torch.equal(got.reprojected, want.reprojected), (label, "reprojected")
        return max(assert_stage(f"{label} color", got.color, want.color, 3e-5),
                   assert_stage(f"{label} moments", got.moments, want.moments, 3e-5))
    if name == "atrous_iteration":
        return max(assert_stage(f"{label} step {st}", g, w)
                   for st, g, w in zip(ATROUS_STEPS, got, want))
    err = assert_stage(label, got, want)
    assert name != "moments_band" or err <= 1e-5, (label, err)
    assert name != "taa_band" or err <= TAA_TOL, (label, err)
    return err


def check_band_kernels() -> dict:
    """Phase 8: K7-K10 on the four 270-row bands of the 1080p frame and on
    the whole-frame band of a one-rank route."""
    from svgf_tpu_torch.config import SVGFConfig
    from svgf_tpu_torch.kernels import filter as K
    from svgf_tpu_torch.render.svgf import BOUND_X, BOUND_Y

    sv = SVGFConfig(spatial_filter_steps=5)
    radiance, gbuf, state = frame_inputs()
    # the whole-frame K1-K4 outputs: the bands' inputs and their reference
    t_full = K.temporal_filter(radiance, state.color, gbuf, state.gbuffer, state.moments,
                               state.history_len, sv.depth_threshold, sv.normal_threshold,
                               sv.history_length)
    m_full = K.filter_moments(t_full.color, t_full.moments, gbuf, t_full.history_len,
                              sv.phi_colour, sv.phi_normal)
    a_full = K.wavelet_filter(m_full, gbuf, 5, sv.phi_colour, sv.phi_normal)[0]
    steps_full = [K.atrous_iteration(m_full, gbuf, st, sv.phi_colour, sv.phi_normal)
                  for st in ATROUS_STEPS]    # the K3 step kernel on the whole frame
    x_full = K.taa(a_full, state.taa_history)
    motion = gbuf.motion.to(torch.int32)
    in_bound = (motion[..., 1].abs() <= BOUND_Y) & (motion[..., 0].abs() <= BOUND_X)

    hb = H // NBANDS
    bands = [(b * hb, (b + 1) * hb) for b in range(NBANDS)] + [(0, H)]
    stitched = {name: [] for name in ("temporal_band", "moments_band", "atrous_iteration", "taa_band")}
    results = {name: {"bands": []} for name in stitched}
    log(f"band kernels (K7-K10) vs plain, {NBANDS} bands of {hb} rows and the {H}-row band, "
        f"{W} wide; {100 * float(in_bound.float().mean()):.2f}% of pixels within the motion bound:")
    for r0, r1 in bands:
        whole = (r0, r1) == (0, H)
        for name, (kernel, plain, crop, b) in band_calls(radiance, gbuf, state, t_full, m_full,
                                                         a_full, r0, r1).items():
            label = f"{name} rows [{r0}, {r1})"
            got = kernel()
            err = check_band_outputs(label, name, got, plain())
            t = time_pair(label, kernel, plain)
            log(f"  {label}: bound {b['bound_ms']:.4f} ms by {b['bound_by']}; the kernel alone "
                f"(profiler) {kernel_alone_ms(kernel):.4f} ms")
            if whole:   # the shapes the one-rank route gives: the row of the JSON line
                results[name].update({"max_abs_err": err, **t, **b, "library_ms": None})
            else:
                results[name]["bands"].append({"rows": [r0, r1], **t, "bound_ms": b["bound_ms"]})
                stitched[name].append(crop(got))

    log("stitched bands vs the whole-frame kernels:")
    check_stitched_temporal("temporal", stitched["temporal_band"], t_full, in_bound)
    assert_stage("moments", torch.cat(stitched["moments_band"]), m_full, 0.0)  # zero rows add 0
    for k, st in enumerate(ATROUS_STEPS):   # a zero-halo tap adds exactly 0
        assert_stage(f"atrous step {st}", torch.cat([o[k] for o in stitched["atrous_iteration"]]),
                     steps_full[k], 0.0)
    # the edge rows make each band's taps the whole frame's: the same bits
    assert_stage("taa", torch.cat(stitched["taa_band"]), x_full, 0.0)
    check_band_state_types(radiance, gbuf, state, a_full, bands, in_bound)
    return results


def check_stitched_temporal(label, bands, t_full, in_bound) -> None:
    """K7's stitched bands against the whole-frame K1 within K7's motion
    bound; beyond it every pixel is a disocclusion."""
    color = torch.cat([t.color for t in bands])
    moments = torch.cat([t.moments for t in bands])
    history = torch.cat([t.history_len for t in bands])
    valid = torch.cat([t.reprojected for t in bands])
    ib = in_bound
    assert_stage(f"{label} color (within the bound)", color[ib], t_full.color[ib], 3e-5)
    assert_stage(f"{label} moments (within the bound)", moments[ib], t_full.moments[ib], 3e-5)
    assert torch.equal(history[ib], t_full.history_len[ib]), (label, "history")
    assert torch.equal(valid[ib], t_full.reprojected[ib]), (label, "reprojected")
    assert not bool(valid[~ib].any()) and bool((history[~ib] == 1).all()), (label, "out of the bound")
    log(f"  {label}: {int((~ib).sum())} pixels beyond the bound, all disoccluded "
        f"({int((t_full.reprojected & ~ib).sum())} of them reprojected by K1's unbounded gather)")


def check_band_state_types(radiance, gbuf, state, a_full, bands, in_bound) -> None:
    """K7 and K10 with the state at bf16 and fp32 on each band against
    their plain versions, and their stitched bands against the whole-frame
    K1 and K4 at the same type (K10: max error 0)."""
    from svgf_tpu_torch.config import SVGFConfig
    from svgf_tpu_torch.kernels import filter as K

    sv = SVGFConfig(spatial_filter_steps=5)
    for label in ("bf16", "fp32"):
        st = state_as(state, STATE_TYPES[label])
        log(f"band kernels K7 and K10 with {label} state:")
        t_full = K.temporal_filter(radiance, st.color, gbuf, st.gbuffer, st.moments,
                                   st.history_len, sv.depth_threshold, sv.normal_threshold,
                                   sv.history_length)
        x_full = K.taa(a_full, st.taa_history)
        stitched = {"temporal_band": [], "taa_band": []}
        for r0, r1 in bands:
            calls = {"temporal_band": temporal_band_call(radiance, gbuf, st, r0, r1),
                     "taa_band": taa_band_call(a_full, st.taa_history, r0, r1)}
            for name, (kernel, plain, crop, _) in calls.items():
                got = kernel()
                check_band_outputs(f"{name} {label} rows [{r0}, {r1})", name, got, plain())
                if (r0, r1) != (0, H):
                    stitched[name].append(crop(got))
                if (r0, label) == (0, "bf16"):
                    t = time_call(kernel)
                    log(f"  {name} {label} rows [{r0}, {r1}): {t['ms']:.5f} ms through the wrapper, "
                        f"{t['alone_ms']:.5f} ms alone")
        check_stitched_temporal(f"stitched {label} temporal", stitched["temporal_band"], t_full,
                                in_bound)
        assert_stage(f"stitched {label} taa", torch.cat(stitched["taa_band"]), x_full, 0.0)


# ---------------------------------------------------------------------------
# K5, K6: the intersectors
# ---------------------------------------------------------------------------


def compare_hits(label, got, want, t0, active=None):
    """Kernel (got) against plain (want) on the active lanes: whether each
    lane hits and, where both hit, the winning triangle; dist/u/v where
    they agree, dist where both hit. Inactive lanes report t0 on both.
    Returns the numbers the callers hold to their bars."""
    if active is not None:
        assert torch.equal(got.dist[~active], t0[~active]), label
        assert torch.equal(want.dist[~active], t0[~active]), label
        got, want, t0 = (type(got)(*(x[active] for x in got)), type(want)(*(x[active] for x in want)),
                         t0[active])
    hit, hit_got = want.dist < t0, got.dist < t0
    same = (got.prim == want.prim) & (got.instance == want.instance)
    agree = (hit == hit_got) & (~hit | same)
    both = hit & hit_got
    err = max(float((getattr(got, f) - getattr(want, f))[agree].abs().max()) for f in ("dist", "u", "v"))
    rel = ((got.dist - want.dist).abs() / want.dist)[both]
    stats = {
        "lanes": int(t0.numel()), "hits": int(hit.sum()), "hit_sets_differ": int((hit != hit_got).sum()),
        "winners_differ": int((~agree).sum()), "agree": float(agree.float().mean()),
        "max_abs_err": err,
        "both_hit_max_dist_err": float((got.dist - want.dist)[both].abs().max()) if both.any() else 0.0,
        "rel_max": float(rel.max()) if both.any() else 0.0,
        "rel_below_1e-5": float((rel < 1e-5).float().mean()) if both.any() else 1.0,
    }
    log(f"  {label}: " + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                                   for k, v in stats.items()))
    return stats


def device_kernels(fn, calls: int = 10) -> tuple[list, int]:
    """(names of the device kernels the profiler saw in `calls` calls of
    fn(), the kernel launches the wrappers counted in them)."""
    from svgf_tpu_torch.scripts.timing import profile_calls

    p = profile_calls(fn, calls, cpu=True)
    return [e.name for e in p.events], p.launched


def dense_call_bound(ro, rd, active, out, n_tris: int) -> dict:
    """K5's bound on one call: rays, mask and Hit once, the swept
    triangles' records once; OPS_MT a ray and swept triangle of the active
    rays, OPS_RECOMPUTE a ray."""
    n_active = ro.shape[0] if active is None else int(active.sum())
    extra = () if active is None else (active,)
    return bound(nbytes(ro, rd, *extra, *out) + n_tris * (9 + 3) * 4,
                 n_active * n_tris * OPS_MT + ro.shape[0] * OPS_RECOMPUTE)


def check_dense_kernel() -> dict:
    """K5 against intersect_dense on the 1080p Cornell box. Bars: hit/miss
    sets and winners agree on >= 99.99% of the active lanes (a ray through
    an edge shared by two triangles may pick either under another
    rounding); where they agree dist/u/v to 1e-5; where both hit, dist to
    1e-3. The kernel's Hit equals, on every lane and bit for bit, the torch
    recompute of its winner (hit_from_winner), which the wrapper takes
    when autograd needs t/u/v; without grad a call is one launch of K5 and
    no torch recompute."""
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.ops.geometry import normalize
    from svgf_tpu_torch.ops.intersect import hit_from_winner, intersect_dense, start_dist
    from svgf_tpu_torch.render.gbuffer import camera_rays
    from svgf_tpu_torch.scenes.cornell import cornell_box

    arrays = cornell_box(aspect=W / H).flatten(device=DEVICE)
    n_tris = arrays.meta.n_world_tris
    R = H * W
    ro_p, rd_p = camera_rays(arrays.cam_frame[0], arrays.cam_proj[0], H, W)
    rng = np.random.default_rng(1)
    ro_s = cuda(rng.uniform(-0.95, 0.95, (R, 3)))
    rd_np = rng.standard_normal((R, 3))
    rd_s = normalize(cuda(rd_np))
    rd_np[:, 1] = np.abs(rd_np[:, 1])
    rd_up = normalize(cuda(rd_np))        # towards the ceiling light
    active = cuda(rng.uniform(size=R) < 0.7, torch.bool)
    tmax = cuda(rng.uniform(0.2, 2.5, R))

    log(f"K5 intersect_dense vs plain, Cornell ({n_tris} triangles), {R} rays a case:")
    cases = (
        ("primary", ro_p, rd_p, {}),
        ("secondary", ro_s, rd_s, {}),
        ("secondary, active", ro_s, rd_s, {"active": active}),
        ("secondary, tmax", ro_s, rd_s, {"tmax": tmax}),
        ("secondary, only_instance=3", ro_s, rd_up, {"only_instance": 3}),
    )
    errs = []
    for label, ro, rd, kw in cases:
        got = KI.intersect_dense_kernel(arrays, ro, rd, **kw)
        want = intersect_dense(arrays, ro, rd, **kw)
        t0 = start_dist(kw.get("tmax"), R, ro.device)
        st = compare_hits(label, got, want, t0, kw.get("active"))
        assert st["agree"] >= 0.9999, (label, st)
        assert st["max_abs_err"] <= 1e-5, (label, st)
        assert st["both_hit_max_dist_err"] <= 1e-3, (label, st)
        if "only_instance" in kw:
            assert st["hits"] > 0 and bool((got.instance[got.dist < t0] == 3).all()), label
        errs.append(st["max_abs_err"])
        # the in-kernel Hit against the recompute of the same launch's winner
        r = KI._rays(ro, rd, kw.get("active"), kw.get("tmax"))
        hit, col = KI.dense_hit(arrays, *r, kw.get("only_instance"), with_col=True)
        rec = hit_from_winner(arrays, ro, rd, col, t0, kw.get("active"))
        differ = {f: int((getattr(hit, f) != getattr(rec, f)).sum()) for f in hit._fields}
        log(f"  {label}: in-kernel Hit vs the recompute of its winner, lanes that differ: {differ}")
        assert not any(differ.values()), (label, differ)
        assert all(torch.equal(a, b) for a, b in zip(got, hit)), label

    names, launched = device_kernels(
        lambda: KI.intersect_dense_kernel(arrays, ro_s, rd_s, active=active))
    log(f"  10 calls without grad: {launched} launches of K5; the profiler saw {len(names)} "
        f"device kernels: {sorted(set(names))}")
    assert launched == 10 and names and all("svgf::intersect_dense" in n for n in names), names
    g_ro = ro_s.clone().requires_grad_(True)
    h = KI.intersect_dense_kernel(arrays, g_ro, rd_s, active=active)
    assert h.dist.requires_grad and h.u.requires_grad, "the recompute route lost the graph"
    names, launched = device_kernels(
        lambda: KI.intersect_dense_kernel(arrays, g_ro, rd_s, active=active))
    log(f"  10 calls with ro requiring grad: {launched} launches of K5; the profiler saw "
        f"{len(names)} device kernels, {sum('svgf::' not in n for n in names)} of them the "
        "torch recompute's")

    # timed at the main path's call: one bounce's batched [shadow | bsdf]
    # rays at 2 lane chunks is 2 x 1,036,800 = 2,073,600 rays with a mask
    kernel = lambda: KI.intersect_dense_kernel(arrays, ro_s, rd_s, active=active)
    plain = lambda: intersect_dense(arrays, ro_s, rd_s, active=active)
    t = time_pair("secondary, active (wrapper: one launch writes the Hit)", kernel, plain)
    alone = kernel_alone_ms(kernel)
    n_active = int(active.sum())
    log(f"  the kernel alone (profiler) {alone:.4f} ms; {n_active} active rays, "
        f"{R / (t['ms'] * 1e3):.1f} Mrays/s through the wrapper")
    b = dense_call_bound(ro_s, rd_s, active, kernel(), n_tris)
    log(f"  bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bound_bytes']} B, {b['bound_ops']} ops)")
    # no single PyTorch call computes a nearest ray-triangle hit
    return {"max_abs_err": max(errs), **t, **b, "library_ms": None, "alone_ms": alone}


@contextlib.contextmanager
def bvh_builder(name: str):
    """SVGF_NATIVE for the block: the NumPy BVH builder ("numpy") or the
    native one ("native", the port's default)."""
    old = os.environ.get("SVGF_NATIVE")
    os.environ["SVGF_NATIVE"] = {"numpy": "0", "native": "1"}[name]
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("SVGF_NATIVE", None)
        else:
            os.environ["SVGF_NATIVE"] = old


def stress_arrays(scene):
    """The stress scene flattened on the card with the NumPy BVH builder
    (the tree PERF.md's K6 rows were measured on), with its host seconds."""
    t_host = time.perf_counter()
    with bvh_builder("numpy"):
        arrays = scene.flatten(device=DEVICE)
    torch.cuda.synchronize()
    log(f"stress_scene(n={STRESS_N}): flatten (NumPy BVH build) {time.perf_counter() - t_host:.3f} s "
        f"host; {arrays.meta.n_world_tris} world triangles, soup {tuple(arrays.world_tris9.shape)}, "
        f"{arrays.wbvh_skip.shape[0]} scene-BVH nodes, {arrays.world_cluster_bounds.shape[0]} clusters")
    assert arrays.meta.soup_leaf_order and arrays.meta.n_world_tris == 2 * (STRESS_N - 1) ** 2 + 2
    return arrays


def stress_rays(arrays):
    """The 2,088,960 block-ordered 1080p primary rays (64x64 blocks) and
    SCRAMBLED seeded rays from above the terrain: {name: (ro, rd)}."""
    from svgf_tpu_torch.ops.geometry import normalize
    from svgf_tpu_torch.render.gbuffer import camera_rays
    from svgf_tpu_torch.render.pathtrace import make_block_order

    fwd, _, _ = make_block_order(H, W)
    ro_p, rd_p = camera_rays(arrays.cam_frame[0], arrays.cam_proj[0], H, W)
    rng = np.random.default_rng(2)
    ro_s = cuda(rng.uniform((-1.8, 0.6, -1.8), (1.8, 1.4, 1.8), (SCRAMBLED, 3)))
    rd_s = normalize(cuda(rng.standard_normal((SCRAMBLED, 3))))
    return {"primary": (fwd(ro_p), fwd(rd_p)), "scrambled": (ro_s, rd_s)}, rng


def visit_counts(label, visits, tests) -> dict:
    """Per-ray counts of a walk: the mean and max a ray, and the mean over
    warps (32 consecutive rays) of the warp's most, which a warp waits for."""
    v = visits.float()
    pad = (-v.numel()) % 32
    warp_max = torch.nn.functional.pad(v, (0, pad)).view(-1, 32).amax(1)
    c = {"visits": float(v.mean()), "visits_max": int(visits.max()),
         "warp_max_visits": float(warp_max.mean()), "tests": float(tests.float().mean())}
    log(f"  {label}: visits a ray mean {c['visits']:.2f} max {c['visits_max']}, a warp's most "
        f"{c['warp_max_visits']:.2f} on average ({c['warp_max_visits'] / c['visits']:.2f}x the "
        f"mean); triangle tests a ray {c['tests']:.2f}")
    return c


def clustered_calls(arrays, rays) -> dict:
    """K6's timed calls, the wrapper on each ray set: {name: fn}."""
    from svgf_tpu_torch.kernels import intersect as KI

    return {name: (lambda ro=ro, rd=rd: KI.intersect_clustered_kernel(arrays, ro, rd))
            for name, (ro, rd) in rays.items()}


def check_k6_hit(arrays, label, ro, rd, kw):
    """The Hit K6 writes on one case against the recompute of its winner,
    bit for bit on every lane, and the wrapper's Hit equal to it. Returns
    the wrapper's Hit."""
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.ops.intersect import hit_from_winner, start_dist

    t0 = start_dist(kw.get("tmax"), ro.shape[0], ro.device)
    r = KI._rays(ro, rd, kw.get("active"), kw.get("tmax"))
    hit, col, _ = KI.bvh_hit(arrays, *r, kw.get("only_instance"), with_col=True)
    rec = hit_from_winner(arrays, ro, rd, col, t0, kw.get("active"))
    differ = {f: int((getattr(hit, f) != getattr(rec, f)).sum()) for f in hit._fields}
    log(f"  {label}: in-kernel Hit vs the recompute of its winner, lanes that differ: {differ}")
    assert not any(differ.values()), (label, differ)
    got = KI.intersect_clustered_kernel(arrays, ro, rd, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, hit)), label
    return got


def check_k6_case(arrays, label, ro, rd, kw) -> float:
    """K6 on one case against traverse_scene_bvh, to check_clustered_kernel's
    bars, and its Hit against the recompute of its winner (check_k6_hit).
    Returns the max error where the winners agree."""
    from svgf_tpu_torch.ops.intersect import start_dist, traverse_scene_bvh

    t0 = start_dist(kw.get("tmax"), ro.shape[0], ro.device)
    got = check_k6_hit(arrays, label, ro, rd, kw)
    st = compare_hits(label, got, traverse_scene_bvh(arrays, ro, rd, **kw), t0, kw.get("active"))
    assert st["hits"] > 0 and st["hit_sets_differ"] == 0, (label, st)
    assert st["rel_max"] < 2e-3 and st["rel_below_1e-5"] >= 0.99, (label, st)
    assert st["agree"] >= 0.9999, (label, st)
    if "only_instance" in kw:
        assert bool((got.instance[got.dist < t0] == kw["only_instance"]).all()), label
    return st["max_abs_err"]


def check_clustered_kernel(arrays, rays, rng) -> dict:
    """K6 against traverse_scene_bvh on the stress terrain. Bars
    (tests/test_clustered.py:92-96): hit/miss sets equal; relative dist
    error below 2e-3 everywhere and below 1e-5 on >= 99% of hits; and, as
    for K5, the winning triangle agrees on >= 99.99% of the lanes (both
    walks compute t bit for bit alike; their orders differ, so only an
    exact tie may pick another winner). The kernel's Hit equals, on every
    lane and bit for bit, the torch recompute of its winner; without grad
    a call is one device kernel. Node visits of both walks: the skip-link
    walk's (the plain walk's counts) and the kernel's child-pair records.
    The bound is K6's own (its records and tests); the same formula on
    the skip-link walk's counts, the yardstick the earlier design was
    bound by, is kept beside it to read both designs against the same work."""
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.ops.intersect import _walk_scene_bvh, start_dist, traverse_scene_bvh

    ro_p, rd_p = rays["primary"]
    ro_s, rd_s = rays["scrambled"]
    n, lanes = ro_s.shape[0], ro_p.shape[0]
    active = cuda(rng.uniform(size=n) < 0.7, torch.bool)
    tmax = cuda(rng.uniform(0.5, 3.0, n))
    ro_up = cuda(np.stack([rng.uniform(-1.2, 1.2, n), np.full(n, 0.5), rng.uniform(-1.2, 1.2, n)], 1))
    rd_up = cuda(np.tile([[0.0, 1.0, 0.0]], (n, 1)))   # axis-aligned: 0 * inf in the slab test
    _, bvh = KI.packed_scene(arrays)
    log(f"K6 intersect_clustered vs plain walk, {lanes} primary rays, {n} scrambled; the scene BVH "
        f"repacked into {bvh.nodes.shape[0]} child-pair records, depth {bvh.depth} (scratch "
        f"entries a ray past the stack: {KI.spill_entries(bvh.depth)}):")
    cases = (
        ("primary (1080p, 64x64 blocks)", ro_p, rd_p, {}),
        ("scrambled", ro_s, rd_s, {}),
        ("scrambled, active + tmax", ro_s, rd_s, {"active": active, "tmax": tmax}),
        ("straight up, only_instance=1", ro_up, rd_up, {"only_instance": 1}),
    )
    errs = [check_k6_case(arrays, label, ro, rd, kw) for label, ro, rd, kw in cases]

    names, launched = device_kernels(lambda: KI.intersect_clustered_kernel(arrays, ro_s, rd_s))
    log(f"  10 calls without grad: {launched} launches of K6; the profiler saw {len(names)} "
        f"device kernels: {sorted(set(names))}")
    assert launched == 10 and names and all("svgf::intersect_bvh" in x for x in names), names

    counts = {}
    for name, (ro, rd) in rays.items():
        t0 = start_dist(None, ro.shape[0], ro.device)
        _, _, sv, stt = _walk_scene_bvh(arrays, ro, rd, t0, None, None, counts=True)
        _, _, st = KI.bvh_hit(arrays, *KI._rays(ro, rd, None, None), stats=True)
        counts[name] = {"skip_link": visit_counts(f"{name}, skip-link walk (nodes)", sv, stt),
                        "child_pair": visit_counts(f"{name}, K6 (child-pair records)",
                                                   st[:, 0], st[:, 1])}

    calls = clustered_calls(arrays, rays)
    kernel = calls["primary"]
    plain = lambda: traverse_scene_bvh(arrays, ro_p, rd_p)
    t = time_pair("primary (wrapper: one launch writes the Hit)", kernel, plain, plain_iters=2,
                  plain_warmup=1)
    alone = kernel_alone_ms(kernel)
    scr = time_call(calls["scrambled"])
    scr_ms, scr_alone = scr["ms"], scr["alone_ms"]
    log(f"  primary: {lanes / (t['ms'] * 1e3):.1f} Mrays/s through the wrapper, the kernel alone "
        f"(profiler) {alone:.4f} ms ({lanes / (alone * 1e3):.1f} Mrays/s)")
    log(f"  scrambled: {scr_ms:.4f} ms, {n / (scr_ms * 1e3):.1f} Mrays/s through the wrapper, the "
        f"kernel alone (profiler) {scr_alone:.4f} ms ({n / (scr_alone * 1e3):.1f} Mrays/s)")
    out = kernel()
    ray_bytes = nbytes(ro_p, rd_p, *out)
    scene_bytes = nbytes(arrays.wbvh_bounds6, arrays.wbvh_skip, arrays.wbvh_leaf_tri,
                         arrays.world_tris9, arrays.world_tri_inst, arrays.world_tri_prim,
                         arrays.world_tri_mat)
    # K6's bound on its own work: its child-pair records (two box tests
    # each) and triangle tests, its records and soup read once
    cp = counts["primary"]["child_pair"]
    b = bound(ray_bytes + nbytes(bvh.nodes, KI.packed_scene(arrays)[0]),
              lanes * (cp["visits"] * 2 * OPS_SLAB + cp["tests"] * OPS_MT + OPS_RECOMPUTE))
    # the yardstick: the same formula on the skip-link walk's counts and
    # the scene-BVH arrays it reads (the skip-link design's own bound)
    sk = counts["primary"]["skip_link"]
    yard = bound(ray_bytes + scene_bytes,
                 lanes * (sk["visits"] * OPS_SLAB + sk["tests"] * OPS_MT + OPS_RECOMPUTE))
    log(f"  bound {b['bound_ms']:.4f} ms by {b['bound_by']} on K6's own counts (two boxes a "
        f"record; {b['bound_bytes']} B, {b['bound_ops']} ops); the yardstick on the skip-link "
        f"walk's counts {yard['bound_ms']:.4f} ms by {yard['bound_by']} ({yard['bound_bytes']} B, "
        f"{yard['bound_ops']} ops)")
    # no single PyTorch call computes a nearest ray-triangle hit
    return {"max_abs_err": max(errs), **t, **b, "library_ms": None, "alone_ms": alone,
            "yardstick_bound_ms": yard["bound_ms"], "yardstick_bound_by": yard["bound_by"],
            "scrambled_ms": scr_ms, "scrambled_alone_ms": scr_alone, "counts": counts}


# ---------------------------------------------------------------------------
# the main path and the stress path
# ---------------------------------------------------------------------------


def profile_step(label, renderer, frame_ms: float) -> tuple[float, int]:
    """One more frame under torch.profiler (after the one that profile_calls
    makes first): the device's busy time, against the profiled wall time
    (the profiler slows the host) and against the unprofiled frame's
    `frame_ms`, and the device kernels with the most time. Returns (device
    busy ms, device kernels)."""
    from svgf_tpu_torch.scripts.timing import profile_calls

    p = profile_calls(renderer.step, 1, cpu=True)
    busy = sum(e.time_range.elapsed_us() for e in p.events) / 1e3
    log(f"{label} profiled frame: device busy {busy:.3f} ms in {len(p.events)} device kernels; "
        f"profiled wall {p.wall_ms:.3f} ms ({100 * busy / p.wall_ms:.1f}% busy), unprofiled "
        f"frame {frame_ms:.3f} ms ({100 * busy / frame_ms:.1f}% busy)")
    by_name: dict = {}
    for e in p.events:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"  {us / 1e3:9.3f} ms  {n:6d}x  {name[:90]}")
    return busy, len(p.events)


def render_config(h, w, use_pallas: str, chunks: int, state_dtype: str = "float16",
                  bounces: int = 3):
    """The frames' RenderConfig: 5 a-trous steps, no debug taps kept."""
    from svgf_tpu_torch.config import RenderConfig, SVGFConfig, TracingConfig

    return RenderConfig(
        width=w, height=h, svgf=SVGFConfig(spatial_filter_steps=5), state_dtype=state_dtype,
        keep_taps=False, use_pallas=use_pallas, trace_chunks=chunks,
        tracing=TracingConfig(bounces=bounces),
    )


def run_frames(scene, orbit, h, w, use_pallas: str, chunks: int, frames: int = FRAMES,
               state_dtype: str = "float16", bounces: int = 3):
    """`frames` frames through Renderer.step, the camera set by orbit(f)
    (None keeps it) before frame f. Returns (last FrameOutputs, per-frame
    stage milliseconds, the Renderer)."""
    from svgf_tpu_torch.render.pipeline import Renderer

    cam0 = scene.cameras[0]
    r = Renderer(scene, render_config(h, w, use_pallas, chunks, state_dtype, bounces),
                 device=DEVICE)
    out, stages = step_frames(r, orbit, frames)
    scene.cameras[0] = cam0   # the next run starts from the same camera
    return out, stages, r


def step_frames(r, orbit, frames: int = FRAMES):
    """`frames` frames of r.step(), the camera set by orbit(f) (None keeps
    it) before frame f. Returns (the last FrameOutputs, per-frame stage
    milliseconds)."""
    from svgf_tpu_torch.render import spans

    stages = []
    out = None
    for f in range(frames):
        if orbit(f) is not None:
            r.update_camera(orbit(f))
        events = {}
        torch.cuda.synchronize()
        out = r.step(events)
        torch.cuda.synchronize()
        names = [n for n in spans.STAGES if n in events]   # the parts' marks left out
        ms = {b: events[a].elapsed_time(events[b]) for a, b in zip(names, names[1:])}
        ms["frame"] = events[names[0]].elapsed_time(events[names[-1]])
        stages.append(ms)
    return out, stages


def expected_launches(intersector: str, chunks: int, meta, frames: int = FRAMES,
                      steps: int = 5) -> dict:
    """Kernel launches per `frames` frames, derived from render_frame and the
    scene's SceneMeta `meta`: one of each filter stage, one a-trous launch
    for each of the `steps`; the intersector once per G-buffer chunk and,
    per trace chunk and MIS bounce, once for the bounce's batched rays and,
    in a scene with media, once per area light for the scatter event's
    only_instance re-trace (the primary hit comes from the G-buffer)."""
    from svgf_tpu_torch.config import RenderConfig, SamplingMode
    from svgf_tpu_torch.kernels.launch import LAUNCHES
    from svgf_tpu_torch.render.pathtrace import n_area_lights

    cfg = RenderConfig()
    assert cfg.tracing.sampling_mode == SamplingMode.MIS
    per_bounce = 1 + (n_area_lights(meta) if meta.has_media else 0)
    per_frame = chunks * (1 + cfg.tracing.batch * (cfg.tracing.bounces * per_bounce
                                                   + (not cfg.hybrid_primary)))
    launches = dict.fromkeys(LAUNCHES, 0)
    launches.update(temporal=frames, moments=frames, atrous=steps * frames, taa=frames)
    launches[intersector] = frames * per_frame
    return launches


def check_image(out, h, w, label):
    final = out.final
    assert final.shape == (h, w, 3), final.shape
    assert bool(torch.isfinite(final).all()), f"{label}: non-finite final image"
    assert float(final.min()) >= 0.0 and float(final.max()) <= 1.0, f"{label}: final image outside [0, 1]"
    m = out.metrics
    log(f"{label} metrics (frame {FRAMES}): coverage {float(m.coverage_pct):.2f}% disoccluded "
        f"{float(m.disoccluded_pct):.2f}% mean history {float(m.mean_history):.3f} "
        f"rays_traced {int(m.rays_traced)}")
    assert float(m.coverage_pct) > 50.0, f"{label}: the camera does not see the scene"
    assert float(final.mean()) > 0.05, f"{label}: the final image is black"


def compare_frames(label, got, want, frame: int = FRAMES):
    """Frame `frame` through the kernels against the plain versions: mean
    < 1e-3 and at most 0.01% of pixels above 5e-2. A primary ray through
    an edge shared by two triangles may pick the other one (the kernel and
    the plain sweep round alike but need not agree on such ties), and the
    variance-guided filters spread such a flip over a few neighbours."""
    d = (got.final - want.final).abs()
    over = int((d.amax(-1) > 5e-2).sum())
    n = d.shape[0] * d.shape[1]
    log(f"{label} frame {frame} final, kernels vs plain on the card: max {float(d.max()):.3e} "
        f"mean {float(d.mean()):.3e}, {over} of {n} pixels above 5e-2")
    assert float(d.mean()) < 1e-3 and over <= 1e-4 * n, (label, float(d.mean()), over)


def log_stages(label, stages):
    med = {k: statistics.median(s[k] for s in stages[1:]) for k in stages[0]}
    log(f"{label} frame ms (median of frames 2-{FRAMES}): {med['frame']:.3f}; per stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items() if k != "frame"))
    log(f"{label} frame ms, every frame: {[round(s['frame'], 3) for s in stages]}")


def cornell_orbit(f: int):
    """The Cornell camera before frame f: 0.01 rad a frame round the box (None keeps frame 0's)."""
    from svgf_tpu_torch.core.camera import orbit_frame

    return orbit_frame([0.0, 0.0, 0.0], 3.4, theta=0.01 * f, phi=0.0) if f else None


def stress_orbit(f: int):
    """The stress camera's azimuth, 3.0 from the centre at 0.6 rad
    elevation (62% of the view is terrain), moving 0.01 rad a frame like
    the main path."""
    from svgf_tpu_torch.core.camera import orbit_frame

    return orbit_frame([0.0, 0.0, 0.0], 3.0, theta=math.pi / 4 + 0.01 * f, phi=0.6)


def timed_frames(label, scene, orbit) -> tuple:
    """FRAMES 1080p frames of the kernels route, the launch counts set to 0
    just before them and read just after, then one more frame under the
    profiler. Returns (the last FrameOutputs, per-frame stage ms, the
    launches, {frame_ms, moments_ms: medians of frames 2-FRAMES;
    device_ms, device_kernels: the profiled frame}, the Renderer)."""
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches

    reset_launches()
    out, stages, r = run_frames(scene, orbit, H, W, "on", TRACE_CHUNKS)
    launches = dict(LAUNCHES)
    med = {k: statistics.median(st[k] for st in stages[1:]) for k in stages[0]}
    busy, kernels = profile_step(f"{label} 1080p kernels", r, med["frame"])
    return out, stages, launches, {"frame_ms": med["frame"], "moments_ms": med["moments"],
                                   "device_ms": busy, "device_kernels": kernels}, r


def check_main_path() -> tuple[dict, dict]:
    """Returns (the launches, timed_frames' summary of the profiled frame)."""
    from svgf_tpu_torch.scenes.cornell import cornell_box

    scene = cornell_box(aspect=W / H)
    out, stages, launches, summary, r = timed_frames("Cornell", scene, cornell_orbit)
    busy, n_kernels = summary["device_ms"], summary["device_kernels"]
    before_ms, before_n = CORNELL_FRAME_BEFORE
    log(f"Cornell 1080p profiled frame against the frame before K5 wrote its Hit (PERF.md "
        f"section 5: {before_ms} ms in {before_n} device kernels): {busy - before_ms:+.3f} ms, "
        f"{n_kernels - before_n:+d} device kernels")
    log(f"main path (Cornell 1080p) launches over {FRAMES} frames: {launches}")
    expect = expected_launches("intersect_dense", TRACE_CHUNKS, r.arrays.meta)
    assert launches == expect, (launches, expect)
    check_image(out, H, W, "Cornell")

    plain_out, plain_stages, _ = run_frames(scene, cornell_orbit, H, W, "off", TRACE_CHUNKS)
    compare_frames("Cornell 1080p", out, plain_out)
    log_stages("Cornell kernels", stages)
    log_stages("Cornell plain", plain_stages)
    return launches, summary


def check_bf16_path() -> None:
    """The main path with bfloat16 state: FRAMES Cornell 1080p frames
    through the kernels, K1 and K4 reading the bf16 state, with the fp16
    frames' launch counts; frame FRAMES against the plain route's."""
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches
    from svgf_tpu_torch.scenes.cornell import cornell_box

    scene = cornell_box(aspect=W / H)
    reset_launches()
    out, stages, r = run_frames(scene, cornell_orbit, H, W, "on", TRACE_CHUNKS,
                                state_dtype="bfloat16")
    launches = dict(LAUNCHES)
    log(f"Cornell 1080p, bf16 state, launches over {FRAMES} frames: {launches}")
    assert launches == expected_launches("intersect_dense", TRACE_CHUNKS, r.arrays.meta), \
        launches
    assert r.state.color.dtype == torch.bfloat16 and r.state.taa_history.dtype == torch.bfloat16
    check_image(out, H, W, "Cornell bf16")
    plain_out, _, _ = run_frames(scene, cornell_orbit, H, W, "off", TRACE_CHUNKS,
                                 state_dtype="bfloat16")
    compare_frames("Cornell 1080p bf16", out, plain_out)
    log_stages("Cornell bf16 kernels", stages)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_frames(mesh, device, state_dtype: str):
    """FRAMES Cornell 1080p frames through make_sharded_step, the launch
    counts set to 0 just before them and read just after, and the same
    frames through the unsharded Renderer. Returns (the last sharded
    FrameOutputs and state, per-frame stage ms, the launches, the
    unsharded Renderer after its last frame and that frame)."""
    from svgf_tpu_torch.config import RenderConfig, SVGFConfig
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches
    from svgf_tpu_torch.parallel import make_sharded_step
    from svgf_tpu_torch.render.pipeline import STATE_DTYPES, Renderer
    from svgf_tpu_torch.render.types import TemporalState
    from svgf_tpu_torch.scenes.cornell import cornell_box

    cfg = RenderConfig(width=W, height=H, svgf=SVGFConfig(spatial_filter_steps=5),
                       state_dtype=state_dtype, keep_taps=True, use_pallas="on",
                       trace_chunks=TRACE_CHUNKS)
    orbit = cornell_orbit
    step = make_sharded_step(cfg, mesh)
    holder = Renderer(cornell_box(aspect=W / H), cfg, device=device)   # scene and camera
    state = TemporalState.initial(H // mesh.size, W, STATE_DTYPES[state_dtype], device)
    stages = []
    reset_launches()
    for f in range(FRAMES):
        if orbit(f) is not None:
            holder.update_camera(orbit(f))
        events = {}
        torch.cuda.synchronize()
        out, state = step(holder.arrays, state, events)
        torch.cuda.synchronize()
        names = list(events)
        ms = {b: events[a].elapsed_time(events[b]) for a, b in zip(names, names[1:])}
        ms["frame"] = events[names[0]].elapsed_time(events[names[-1]])
        stages.append(ms)
    launches = dict(LAUNCHES)
    log(f"sharded route (Cornell 1080p, 1 rank, {state_dtype} state) launches over {FRAMES} "
        f"frames: {launches}")
    per_frame = TRACE_CHUNKS * cfg.tracing.batch * (cfg.tracing.bounces + (not cfg.hybrid_primary))
    expect = dict.fromkeys(LAUNCHES, 0)
    expect.update(temporal_band=FRAMES, moments_band=FRAMES, atrous_iteration=5 * FRAMES,
                  taa_band=FRAMES, intersect_dense=FRAMES * (1 + per_frame))
    assert launches == expect, (launches, expect)
    assert state.color.dtype == STATE_DTYPES[state_dtype], state.color.dtype
    final = out.final
    assert final.shape == (H, W, 3) and bool(torch.isfinite(final).all()), "sharded final"
    assert float(final.min()) >= 0.0 and float(final.max()) <= 1.0, "sharded final outside [0, 1]"

    # the same frames through the unsharded Renderer
    ref = Renderer(cornell_box(aspect=W / H), cfg, device=device)
    for f in range(FRAMES):
        if orbit(f) is not None:
            ref.update_camera(orbit(f))
        want = ref.step()
    return out, state, stages, launches, ref, want


def check_sharded_route() -> dict:
    """Phase 9: make_sharded_step on one NCCL rank, FRAMES Cornell 1080p
    frames, against the unsharded Renderer's frames; then the same with
    bf16 state (K7 and K10 reading it)."""
    import torch.distributed as dist

    from svgf_tpu_torch.parallel import init_distributed, make_row_mesh
    from svgf_tpu_torch.render.svgf import BOUND_X, BOUND_Y

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(free_port()))
    device = init_distributed()
    mesh = make_row_mesh()
    log(f"sharded route: {mesh.size} rank, backend {dist.get_backend()} on {device}; with one "
        "rank no collective is issued (halo.py's n == 1 branch: the halos are the image's zero "
        "or edge rows)")
    try:
        out, state, stages, launches, ref, want = sharded_frames(mesh, device, "float16")
        log_stages("sharded route", stages)
        m = out.gbuffer.motion.to(torch.int32)
        beyond = int(((m[..., 1].abs() > BOUND_Y) | (m[..., 0].abs() > BOUND_X)).sum())
        log(f"sharded vs unsharded, frame {FRAMES} ({beyond} pixels move beyond K7's bound):")
        assert_stage("radiance", out.radiance, want.radiance, 1e-6)
        for tap in ("temporal", "moments_filtered", "atrous"):
            assert_stage(tap, getattr(out, tap), getattr(want, tap), 3e-5)
        d = (out.final - want.final).abs()
        log(f"  final: max_abs_err {float(d.max()):.3e} mean_abs_err {float(d.mean()):.3e}")
        assert float(d.mean()) < 1e-4 and not bool((d > 5e-3).any()), "sharded final"
        for field in ("color", "moments"):
            assert_stage(f"state {field}", getattr(state, field), getattr(ref.state, field), 3e-5)
        assert torch.equal(state.history_len, ref.state.history_len), "state history"

        out_bf, _, _, _, _, want_bf = sharded_frames(mesh, device, "bfloat16")
        d = (out_bf.final - want_bf.final).abs()
        log(f"sharded vs unsharded, bf16 state, frame {FRAMES} final: max_abs_err "
            f"{float(d.max()):.3e} mean_abs_err {float(d.mean()):.3e}")
        assert_stage("bf16 radiance", out_bf.radiance, want_bf.radiance, 1e-6)
        assert float(d.mean()) < 1e-4 and not bool((d > 5e-3).any()), "sharded bf16 final"
        return launches
    finally:
        dist.destroy_process_group()


def check_stress_path(scene) -> dict:
    torch.cuda.reset_peak_memory_stats()
    out, stages, launches, _, r = timed_frames("stress", scene, stress_orbit)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"stress path (terrain 1080p, trace_chunks={TRACE_CHUNKS}) launches over {FRAMES} frames: "
        f"{launches}; peak memory {peak:.1f} MiB")
    expect = expected_launches("intersect_clustered", TRACE_CHUNKS, r.arrays.meta)
    assert launches == expect, (launches, expect)
    check_image(out, H, W, "stress")
    log_stages("stress kernels", stages)

    # kernels against plain at 480x270: the plain walk is a host loop
    small, _, _ = run_frames(scene, stress_orbit, SMALL_H, SMALL_W, "on", 1)
    small_plain, small_plain_stages, _ = run_frames(scene, stress_orbit, SMALL_H, SMALL_W, "off", 1)
    check_image(small, SMALL_H, SMALL_W, "stress 480x270")
    compare_frames("stress 480x270", small, small_plain)
    log_stages("stress 480x270 plain", small_plain_stages)
    return launches


# ---------------------------------------------------------------------------
# a deep scene BVH: K6's stack and its scratch
# ---------------------------------------------------------------------------

NESTED_N = 100   # nested_scene(n=100): 20,002 world triangles, scene BVH depth 79
NESTED_PLAIN_BOUNCES = 1   # the frame held to the plain route (its walk is a host loop)


def nested_arrays(n: int):
    """nested_scene(n) flattened on the card, with its host seconds."""
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.scenes.nested import nested_scene

    scene = nested_scene(n=n, aspect=W / H)
    t_host = time.perf_counter()
    with bvh_builder("numpy"):   # its depth of 79 is the NumPy tree's
        arrays = scene.flatten(device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_host
    depth = KI.packed_scene(arrays)[1].depth
    log(f"nested_scene(n={n}): flatten (NumPy BVH build) {seconds:.3f} s host; "
        f"{arrays.meta.n_world_tris} world triangles, scene BVH depth {depth}, K6's scratch "
        f"entries a ray past its {KI.BVH_STACK}-entry stack: {KI.spill_entries(depth)}")
    assert arrays.meta.soup_leaf_order and arrays.meta.has_scene_bvh
    return scene, arrays, depth, seconds


def nested_rays(arrays, h: int, w: int) -> dict:
    """The scene camera's h x w primary rays in 64x64 blocks (the G-buffer's
    lane order on a large scene) and SCRAMBLED seeded rays from below the
    nest, up into it: {name: (ro, rd)}."""
    from svgf_tpu_torch.ops.geometry import normalize
    from svgf_tpu_torch.render.gbuffer import camera_rays
    from svgf_tpu_torch.render.pathtrace import make_block_order

    fwd, _, _ = make_block_order(h, w)
    ro_p, rd_p = camera_rays(arrays.cam_frame[0], arrays.cam_proj[0], h, w)
    rng = np.random.default_rng(4)
    ro_s = cuda(rng.uniform((-1.0, -0.6, -1.0), (1.0, -0.2, 1.0), (SCRAMBLED, 3)))
    d = rng.standard_normal((SCRAMBLED, 3))
    d[:, 1] = np.abs(d[:, 1]) + 0.2
    return {"primary": (fwd(ro_p), fwd(rd_p)), "scrambled": (ro_s, normalize(cuda(d)))}


def nested_orbit(f: int):
    """The nested scene's camera before frame f: its eye turned 0.01 rad a
    frame about the vertical axis (None keeps frame 0's)."""
    from svgf_tpu_torch.core.camera import look_at_frame
    from svgf_tpu_torch.scenes.nested import EYE, TARGET

    if not f:
        return None
    a = 0.01 * f
    x, y, z = EYE
    return look_at_frame(eye=[x * math.cos(a) + z * math.sin(a), y, z * math.cos(a) - x * math.sin(a)],
                         target=list(TARGET))


def check_nested_scene() -> dict:
    """K6 on a scene BVH deeper than its 64-entry stack: the nested scene
    (depth 79), whose walks keep the entries past the stack in K6's global
    scratch (in the CPU model of the walk 82% of the camera's rays hold
    more than 64 entries at once). Its SMALL_H x SMALL_W primary rays and
    SCRAMBLED rays from below against the plain walk, a host loop of
    thousands of steps here; on its 1080p primary rays the Hit against the
    recompute of its winner; visits a ray, K6 through its wrapper and
    alone on the 1080p and the scrambled rays; FRAMES 1080p frames through
    the kernels with the launch counts, and one frame of the kernels
    against plain at SMALL_H x SMALL_W with NESTED_PLAIN_BOUNCES bounces."""
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches

    scene, arrays, depth, seconds = nested_arrays(NESTED_N)
    assert KI.spill_entries(depth) > 0, depth
    log(f"K6 on the nested scene (depth {depth}) vs plain walk:")
    for name, (ro, rd) in nested_rays(arrays, SMALL_H, SMALL_W).items():
        check_k6_case(arrays, f"{name} ({ro.shape[0]} rays)", ro, rd, {})
    rays = nested_rays(arrays, H, W)
    check_k6_hit(arrays, f"primary ({H * W} rays)", *rays["primary"], {})
    res = {"depth": depth, "flatten_s": seconds, "triangles": arrays.meta.n_world_tris}
    for name, (ro, rd) in rays.items():
        _, _, st = KI.bvh_hit(arrays, *KI._rays(ro, rd, None, None), stats=True)
        counts = visit_counts(f"{name}, K6 (child-pair records)", st[:, 0], st[:, 1])
        t = time_call(lambda: KI.intersect_clustered_kernel(arrays, ro, rd))
        n = ro.shape[0]
        log(f"  {name}: {n} rays, {t['ms']:.4f} ms through the wrapper ({n / (t['ms'] * 1e3):.1f} "
            f"Mrays/s), {t['alone_ms']:.4f} ms alone ({n / (t['alone_ms'] * 1e3):.1f} Mrays/s)")
        res[name] = {**t, **counts}
    # K6's bound on the 1080p primary rays, as check_clustered_kernel's on
    # the terrain: its records (two box tests each) and triangle tests, the
    # rays, records and soup read once; the scratch past the stack is the
    # design's traffic, not the work's, and is not counted
    ro, rd = rays["primary"]
    soup, bvh = KI.packed_scene(arrays)
    cp = res["primary"]
    b = bound(nbytes(ro, rd, *KI.intersect_clustered_kernel(arrays, ro, rd), bvh.nodes, soup),
              ro.shape[0] * (cp["visits"] * 2 * OPS_SLAB + cp["tests"] * OPS_MT + OPS_RECOMPUTE))
    log(f"  primary: bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bound_bytes']} B, "
        f"{b['bound_ops']} ops); K6 alone at {100 * b['bound_ms'] / cp['alone_ms']:.1f}% of it")
    res["bound"] = b

    reset_launches()
    out, stages, r = run_frames(scene, nested_orbit, H, W, "on", TRACE_CHUNKS)
    launches = dict(LAUNCHES)
    log(f"nested scene 1080p launches over {FRAMES} frames: {launches}")
    assert launches == expected_launches("intersect_clustered", TRACE_CHUNKS, r.arrays.meta), \
        launches
    check_image(out, H, W, "nested")
    inst = r.state.gbuffer.instance
    sheets = int(torch.unique(inst[(inst >= 0) & (inst < NESTED_N)]).numel())
    log(f"nested scene: the camera sees {sheets} of its {NESTED_N} sheets")
    assert sheets > NESTED_N // 2, sheets
    log_stages("nested kernels", stages)
    small, _, _ = run_frames(scene, nested_orbit, SMALL_H, SMALL_W, "on", 1, 1,
                             bounces=NESTED_PLAIN_BOUNCES)
    small_plain, small_plain_stages, _ = run_frames(scene, nested_orbit, SMALL_H, SMALL_W, "off", 1,
                                                    1, bounces=NESTED_PLAIN_BOUNCES)
    compare_frames(f"nested {SMALL_W}x{SMALL_H}, {NESTED_PLAIN_BOUNCES} bounce", small, small_plain,
                   1)
    log(f"nested {SMALL_W}x{SMALL_H} plain frame ms: "
        f"{[round(st['frame'], 3) for st in small_plain_stages]}")
    res["frame_ms"] = statistics.median(st["frame"] for st in stages[1:])
    return res


# ---------------------------------------------------------------------------
# the materials path: every lobe, media, opacity, textures, an environment
# ---------------------------------------------------------------------------


class Flattened:
    """A host scene whose flatten returns arrays already on the card: a
    Renderer built on it renders those arrays without flattening again."""

    def __init__(self, scene, arrays):
        self.cameras = scene.cameras
        self.arrays = arrays

    def flatten(self, device=None):
        return self.arrays


@contextlib.contextmanager
def recording_intersect(calls: dict):
    """While the block runs, each call of an intersector kernel wrapper is
    counted under (wrapper, lanes, only_instance), and the first call of
    each kind keeps its arguments: calls[key] = [count, (scene, ro, rd), kw]."""
    from svgf_tpu_torch.kernels import intersect as KI

    wrappers = {name: getattr(KI, name)
                for name in ("intersect_dense_kernel", "intersect_clustered_kernel")}

    def recorder(name, fn):
        def record(scene, ro, rd, **kw):
            entry = calls.setdefault((name, ro.shape[0], kw.get("only_instance")),
                                     [0, (scene, ro, rd), kw])
            entry[0] += 1
            return fn(scene, ro, rd, **kw)
        return record

    for name, fn in wrappers.items():
        setattr(KI, name, recorder(name, fn))
    try:
        yield
    finally:
        for name, fn in wrappers.items():
            setattr(KI, name, fn)


def recorded_calls(label, r) -> dict:
    """One more frame of Renderer r with its intersector calls recorded:
    prints the lanes a call and the calls a frame of each kind."""
    calls = {}
    with recording_intersect(calls):
        r.step()
    torch.cuda.synchronize()
    for (name, lanes, only), (count, _, kw) in sorted(calls.items(), key=str):
        log(f"  {label}: {name} on {lanes} lanes (only_instance={only}, active mask "
            f"{'yes' if kw.get('active') is not None else 'no'}): {count} calls a frame")
    return calls


def time_recorded(label, fn, b) -> dict:
    t = time_call(fn)
    log(f"  {label}: {t['ms']:.4f} ms through the wrapper, {t['alone_ms']:.4f} ms alone; bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({100 * b['bound_ms'] / t['alone_ms']:.1f}% "
        "of it alone)")
    return {**t, **b}


def check_materials_frame(matte: dict) -> dict:
    """The materials scene at 1080p through K1-K5 (phase 12, first half).
    `matte`: the MATTE Cornell frame's timed_frames summary."""
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.scenes.materials import cornell_materials

    scene = cornell_materials(aspect=W / H)
    torch.cuda.reset_peak_memory_stats()
    out, stages, launches, summary, r = timed_frames("materials", scene, cornell_orbit)
    peak = torch.cuda.max_memory_allocated() / 2**20
    meta = r.arrays.meta
    log(f"materials scene: types {meta.mat_types_used}, media {meta.has_media}, opacity "
        f"{meta.has_opacity}, textures {meta.textures_enabled}, normal maps "
        f"{meta.has_normal_maps}, {meta.n_lights} lights ({meta.n_envs} environment)")
    log(f"materials (1080p) launches over {FRAMES} frames: {launches}; peak memory {peak:.1f} MiB")
    expect = expected_launches("intersect_dense", TRACE_CHUNKS, meta)
    assert launches == expect, (launches, expect)
    check_image(out, H, W, "materials")
    log(f"materials profiled frame: device {summary['device_ms']:.3f} ms in "
        f"{summary['device_kernels']} device kernels; the MATTE Cornell frame's "
        f"{matte['device_ms']:.3f} ms in {matte['device_kernels']}")
    log_stages("materials kernels", stages)

    calls = recorded_calls("materials", r)
    res = {"frame_ms": summary["frame_ms"], "device_ms": summary["device_ms"],
           "device_kernels": summary["device_kernels"], "peak_mib": peak,
           "rays_traced": int(out.metrics.rays_traced)}
    n_tris = meta.n_world_tris
    widest = max(lanes for _, lanes, _ in calls)   # a bounce's batched [shadow | bsdf | seg 3]
    for (name, lanes, only), (count, (arrays, ro, rd), kw) in calls.items():
        if lanes != widest and only is None:
            continue
        label = f"K5 on {lanes} lanes" + (f", only_instance={only}" if only is not None else "")
        swept = n_tris if only is None else meta.inst_world_range[only][1]
        fn = lambda: KI.intersect_dense_kernel(arrays, ro, rd, **kw)
        b = dense_call_bound(ro, rd, kw.get("active"), fn(), swept)
        res[label] = {"calls_a_frame": count, **time_recorded(label, fn, b)}

    plain_out, plain_stages, _ = run_frames(scene, cornell_orbit, H, W, "off", TRACE_CHUNKS)
    compare_frames("materials 1080p", out, plain_out)
    log_stages("materials plain", plain_stages)
    return res


def pbr_terrain(arrays):
    """The flattened terrain with material 0 made PBR (roughness 0.8,
    metallic 0), its fields replaced as svgf_tpu/core/edits.py
    update_material replaces them, and mat_types_used with them."""
    from svgf_tpu_torch.core.scene import MaterialType

    mat_type, rough, metal = (x.clone() for x in (arrays.mat_type, arrays.mat_roughness,
                                                  arrays.mat_metallic))
    mat_type[0], rough[0], metal[0] = int(MaterialType.PBR), 0.8, 0.0
    types = tuple(sorted(set(arrays.meta.mat_types_used) | {int(MaterialType.PBR)}))
    return dataclasses.replace(arrays, mat_type=mat_type, mat_roughness=rough,
                               mat_metallic=metal,
                               meta=dataclasses.replace(arrays.meta, mat_types_used=types))


def check_pbr_terrain(stress, arrays) -> dict:
    """The PBR terrain (phase 12, second half): FRAMES 1080p frames through
    K1-K4 and K6 with the launch counts, K6 alone on the frame's 3R-lane
    call with its bound on its own counts, and one frame of kernels
    against plain at SMALL_H x SMALL_W."""
    from svgf_tpu_torch.kernels import intersect as KI

    scene = Flattened(stress, pbr_terrain(arrays))
    torch.cuda.reset_peak_memory_stats()
    out, stages, launches, summary, r = timed_frames("PBR terrain", scene, stress_orbit)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"PBR terrain (1080p) launches over {FRAMES} frames: {launches}; peak memory {peak:.1f} MiB")
    expect = expected_launches("intersect_clustered", TRACE_CHUNKS, r.arrays.meta)
    assert launches == expect, (launches, expect)
    check_image(out, H, W, "PBR terrain")
    log_stages("PBR terrain kernels", stages)

    res = {"frame_ms": summary["frame_ms"], "device_ms": summary["device_ms"],
           "device_kernels": summary["device_kernels"], "peak_mib": peak}
    _, bvh = KI.packed_scene(r.arrays)
    calls = recorded_calls("PBR terrain", r)
    widest = max(lanes for _, lanes, _ in calls)   # a bounce's batched [shadow | bsdf | seg 3]
    for (name, lanes, only), (count, (a, ro, rd), kw) in calls.items():
        if lanes != widest:
            continue
        active = kw.get("active")
        _, _, st = KI.bvh_hit(a, *KI._rays(ro, rd, active, None), stats=True)
        st = st.double().sum(0)
        b = bound(nbytes(ro, rd, *(() if active is None else (active,)))
                  + nbytes(*KI.intersect_clustered_kernel(a, ro, rd, **kw), bvh.nodes,
                           KI.packed_scene(a)[0]),
                  float(st[0]) * 2 * OPS_SLAB + float(st[1]) * OPS_MT + lanes * OPS_RECOMPUTE)
        n_act = lanes if active is None else int(active.sum())
        log(f"  K6 on {lanes} lanes: {n_act} active, {float(st[0]) / n_act:.2f} records and "
            f"{float(st[1]) / n_act:.2f} triangle tests an active ray")
        label = f"K6 on {lanes} lanes"
        res[label] = {"calls_a_frame": count,
                      **time_recorded(label, lambda: KI.intersect_clustered_kernel(a, ro, rd, **kw),
                                      b)}

    small, _, _ = run_frames(scene, stress_orbit, SMALL_H, SMALL_W, "on", 1, 1)
    small_plain, small_plain_stages, _ = run_frames(scene, stress_orbit, SMALL_H, SMALL_W, "off",
                                                    1, 1)
    check_image(small, SMALL_H, SMALL_W, "PBR terrain 480x270")
    compare_frames("PBR terrain 480x270", small, small_plain, 1)
    log(f"PBR terrain 480x270 plain frame ms: {round(small_plain_stages[0]['frame'], 3)}")
    return res


def check_materials_path(stress, arrays, matte: dict) -> dict:
    """Phase 12: the materials frame, then the PBR terrain."""
    return {"materials": check_materials_frame(matte),
            "PBR terrain": check_pbr_terrain(stress, arrays)}


# ---------------------------------------------------------------------------
# scene I/O and edits: material and transform edits, resume, asset import
# ---------------------------------------------------------------------------

EDIT_WALL = 1    # the Cornell box's left wall material, recoloured before frame 3
EDIT_BLOCK = 4   # the tall block instance, moved before frame 4


def cornell_edit(r, f: int):
    """Apply the edit of phase 13's Cornell sequence that comes before frame
    index f (a wall's colour before index 2, the tall block moved before
    index 3) to Renderer r; returns its host ms, or None without an edit."""
    if f not in (2, 3):
        return None
    t0 = time.perf_counter()
    if f == 2:
        r.update_material(EDIT_WALL, dataclasses.replace(r.scene.materials[EDIT_WALL],
                                                         colour=(0.15, 0.35, 0.75)))
    else:
        t = np.asarray(r.scene.instances[EDIT_BLOCK].transform, np.float32).copy()
        t[:3, 3] += (0.15, 0.0, 0.1)
        r.update_instance_transform(EDIT_BLOCK, t)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def edit_frames(r, frames, ckpt: str | None = None) -> dict:
    """Frames `frames` (indices) of the edited Cornell sequence on Renderer
    r: before frame f its edit (cornell_edit), then the camera to
    cornell_orbit(f). Returns {f: {out, ms (host, synchronized), edit_ms,
    repacks (packed scenes made in the frame), launches (of the frame)}}.
    With `ckpt`, r.state is saved there after index 1 (frame 2), and the
    save's seconds and the file's MiB are under "save" in the result."""
    from svgf_tpu_torch.io import save_checkpoint
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.kernels.launch import LAUNCHES

    res = {}
    for f in frames:
        edit_ms = cornell_edit(r, f)
        if cornell_orbit(f) is not None:
            r.update_camera(cornell_orbit(f))
        keys, before = set(KI._PACKED), dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = r.step()
        torch.cuda.synchronize()
        res[f] = {"out": out, "ms": (time.perf_counter() - t0) * 1e3, "edit_ms": edit_ms,
                  "repacks": len(set(KI._PACKED) - keys),
                  "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES}}
        if f == 1 and ckpt is not None:
            t0 = time.perf_counter()
            save_checkpoint(ckpt, r.state)
            res["save"] = {"s": time.perf_counter() - t0, "mib": os.path.getsize(ckpt) / 2**20}
    return res


def check_edits_and_resume(tmp: str, state_dtype: str) -> dict:
    """Phase 13 (a) and (b) with one state type: the Cornell box at 1080p
    through K1-K5 for 4 frames with a wall recoloured before frame 3 and
    the tall block moved before frame 4, checkpointed after frame 2; a new
    Renderer resumes from the checkpoint and renders frames 3-4 with the
    same poses and edits, which must equal the uninterrupted frames with
    max error 0. With fp16 state (a): the material edit makes no packed
    scene and leaves K5's launches a frame as they were, the transform
    edit makes one, and frame 4 matches the plain route's."""
    from svgf_tpu_torch.io import load_checkpoint
    from svgf_tpu_torch.render.pipeline import Renderer
    from svgf_tpu_torch.scenes.cornell import cornell_box

    cfg = render_config(H, W, "on", TRACE_CHUNKS, state_dtype)
    path = os.path.join(tmp, f"state_{state_dtype}.npz")
    whole = edit_frames(Renderer(cornell_box(aspect=W / H), cfg, device=DEVICE), range(4), path)
    r = Renderer(cornell_box(aspect=W / H), cfg, device=DEVICE)
    r.update_camera(cornell_orbit(1))
    t0 = time.perf_counter()
    r.state = load_checkpoint(path, device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    resumed = edit_frames(r, (2, 3))
    save = whole["save"]
    log(f"Cornell 1080p {state_dtype}: checkpoint after frame 2 {save['mib']:.3f} MiB, saved in "
        f"{save['s']:.3f} s, loaded in {load_s:.3f} s; frame ms "
        f"{[round(whole[f]['ms'], 3) for f in range(4)]}")
    for f in (2, 3):
        d = float((whole[f]["out"].final - resumed[f]["out"].final).abs().max())
        log(f"  frame {f + 1} resumed vs uninterrupted: max error {d}")
        assert torch.equal(whole[f]["out"].final, resumed[f]["out"].final), (state_dtype, f, d)
    res = {"save_s": save["s"], "load_s": load_s, "mib": save["mib"]}
    if state_dtype != "float16":
        return res

    k5 = [whole[f]["launches"]["intersect_dense"] for f in range(4)]
    for f, name in ((2, "material"), (3, "transform")):
        log(f"  {name} edit before frame {f + 1}: {whole[f]['edit_ms']:.3f} ms host; frame "
            f"{f + 1} {whole[f]['ms']:.3f} ms against frame 2's {whole[1]['ms']:.3f}; packed "
            f"scenes made in the frame {whole[f]['repacks']}; K5 launches {k5[f]}")
        res[f"{name}_edit_ms"], res[f"{name}_frame_ms"] = whole[f]["edit_ms"], whole[f]["ms"]
    res["frame2_ms"] = whole[1]["ms"]
    assert whole[2]["repacks"] == 0 and whole[3]["repacks"] == 1, whole
    per_frame = expected_launches("intersect_dense", TRACE_CHUNKS, r.arrays.meta)
    assert all(n == per_frame["intersect_dense"] // FRAMES for n in k5), k5
    plain = edit_frames(Renderer(cornell_box(aspect=W / H),
                                 render_config(H, W, "off", TRACE_CHUNKS), device=DEVICE), range(4))
    compare_frames("Cornell 1080p after both edits", whole[3]["out"], plain[3]["out"], 4)
    return res


def write_ply(path: str, positions, indices) -> None:
    """A binary little-endian PLY of one triangle mesh."""
    faces = np.zeros(len(indices), dtype=[("n", "u1"), ("v", "<i4", (3,))])
    faces["n"], faces["v"] = 3, indices
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(positions)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(indices)}\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode() + np.asarray(positions, "<f4").tobytes() + faces.tobytes())


def write_obj(path: str, positions, indices) -> None:
    with open(path, "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in positions)
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in indices)


PLY_N = 100   # heightfield_shape(n=100): 19,602 triangles


def check_asset_import(tmp: str, builder: str = "numpy") -> dict:
    """Phase 13 (c), and 15 (c) with the native builder: Renderer.add_asset
    on the 1080p Cornell box, its BVHs built by `builder` (bvh_builder). A
    small OBJ (a tetrahedron) keeps the soup under DENSE_MAX_TRIS and the
    frame on K5; then a binary PLY of heightfield_shape(n=PLY_N) scaled
    into the box takes it past the limit, to the large-scene layout and
    K6: FRAMES frames through K1-K4 and K6 with the launches
    expected_launches derives from the new SceneMeta, and one 480x270
    frame of kernels against plain."""
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches
    from svgf_tpu_torch.ops.intersect import DENSE_MAX_TRIS
    from svgf_tpu_torch.render.pipeline import Renderer
    from svgf_tpu_torch.scenes.cornell import cornell_box
    from svgf_tpu_torch.scenes.stress import heightfield_shape

    hf = heightfield_shape(PLY_N)
    pos = np.asarray(hf.positions, np.float32) * np.float32([0.45, 0.4, 0.45]) + \
        np.float32([0.0, -0.75, 0.0])
    ply, obj = os.path.join(tmp, "heightfield.ply"), os.path.join(tmp, "tetra.obj")
    write_ply(ply, pos, hf.indices)
    write_obj(obj, [(0.3, -0.2, 0.3), (0.6, -0.2, 0.3), (0.45, -0.2, 0.6), (0.45, 0.1, 0.4)],
              [(0, 2, 1), (0, 1, 3), (1, 2, 3), (2, 0, 3)])

    with bvh_builder(builder):
        r = Renderer(cornell_box(aspect=W / H), render_config(H, W, "on", TRACE_CHUNKS),
                     device=DEVICE)
    r.step()
    res = {}
    for name, path, large in (("OBJ", obj, False), ("PLY", ply, True)):
        t0 = time.perf_counter()
        with bvh_builder(builder):
            r.add_asset(path)
        torch.cuda.synchronize()
        res[f"{name}_add_s"] = time.perf_counter() - t0
        meta = r.arrays.meta
        log(f"add_asset({name}, {builder} builder): {res[f'{name}_add_s']:.3f} s host; "
            f"{meta.n_world_tris} world "
            f"triangles, large-scene layout {meta.soup_leaf_order}, scene BVH {meta.has_scene_bvh}")
        assert meta.soup_leaf_order == meta.has_scene_bvh == large
        assert (meta.n_world_tris > DENSE_MAX_TRIS) == large
        if not large:
            reset_launches()
            r.step()
            torch.cuda.synchronize()
            expect = expected_launches("intersect_dense", TRACE_CHUNKS, meta)
            assert dict(LAUNCHES) == {k: n // FRAMES for k, n in expect.items()}, LAUNCHES
    reset_launches()
    ms = []
    for f in range(FRAMES):
        r.update_camera(cornell_orbit(f + 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = r.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(LAUNCHES)
    log(f"Cornell + heightfield ({builder} builder, 1080p) launches over {FRAMES} frames: "
        f"{launches}; frame ms "
        f"{[round(m, 3) for m in ms]} (the first takes the K6 repack)")
    assert launches == expected_launches("intersect_clustered", TRACE_CHUNKS, r.arrays.meta), \
        launches
    check_image(out, H, W, f"Cornell + heightfield ({builder})")
    res["switch_frame_ms"], res["frame_ms"] = ms[0], statistics.median(ms[1:])
    scene = Flattened(r.scene, r.arrays)
    small, _, _ = run_frames(scene, cornell_orbit, SMALL_H, SMALL_W, "on", 1, 1)
    small_plain, _, _ = run_frames(scene, cornell_orbit, SMALL_H, SMALL_W, "off", 1, 1)
    compare_frames(f"Cornell + heightfield ({builder}) 480x270", small, small_plain, 1)
    return res


def check_terrain_edit(stress, arrays) -> dict:
    """Phase 13 (d): the terrain's emissive light moved and scaled by
    update_instance_transform on phase 5's flattened arrays (the stitched
    scene BVH, the cluster bounds over its soup block and the light CDF
    rebuilt); K6 on the 1080p primary rays against the plain walk, and its
    Hit against the recompute of its winner. Moves `stress`'s light."""
    from svgf_tpu_torch.core.edits import update_instance_transform
    from svgf_tpu_torch.kernels import intersect as KI

    light = next(i for i, inst in enumerate(stress.instances) if inst.name == "light")
    depth_before = KI.child_pair_bvh(arrays).depth
    t = np.asarray(stress.instances[light].transform, np.float32).copy()
    t[:3, :3] *= 1.2
    t[:3, 3] += (0.4, -0.3, 0.2)
    t0 = time.perf_counter()
    edited = update_instance_transform(stress, arrays, light, t)
    torch.cuda.synchronize()
    edit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, bvh = KI.packed_scene(edited)
    torch.cuda.synchronize()
    repack_ms = (time.perf_counter() - t0) * 1e3
    log(f"terrain light moved: edit {edit_s:.3f} s host, repack {repack_ms:.3f} ms, scene BVH "
        f"depth {depth_before} -> {bvh.depth} (spill entries {KI.spill_entries(bvh.depth)})")
    assert not torch.equal(edited.light_area, arrays.light_area)
    assert not torch.equal(edited.wbvh_bounds6, arrays.wbvh_bounds6)
    ro, rd = stress_rays(edited)[0]["primary"]
    err = check_k6_case(edited, "K6, terrain after the edit, primary rays", ro, rd, {})
    return {"edit_s": edit_s, "repack_ms": repack_ms, "depth": bvh.depth, "max_abs_err": err}


def check_scene_npz(tmp: str) -> dict:
    """Phase 13 (e): the materials scene through save_scene_npz and
    load_scene_npz: its frame 1 at 1080p through K1-K5 equals the
    original's bit for bit."""
    from svgf_tpu_torch.io import load_scene_npz, save_scene_npz
    from svgf_tpu_torch.scenes.materials import cornell_materials

    scene = cornell_materials(aspect=W / H)
    path = os.path.join(tmp, "materials.npz")
    t0 = time.perf_counter()
    save_scene_npz(path, scene)
    back = load_scene_npz(path)
    io_s = time.perf_counter() - t0
    want, _, _ = run_frames(scene, cornell_orbit, H, W, "on", TRACE_CHUNKS, 1)
    got, _, _ = run_frames(back, cornell_orbit, H, W, "on", TRACE_CHUNKS, 1)
    d = float((want.final - got.final).abs().max())
    log(f"materials scene through npz ({os.path.getsize(path) / 2**20:.3f} MiB, save + load "
        f"{io_s:.3f} s): frame 1 max error {d}")
    assert torch.equal(want.final, got.final), d
    return {"io_s": io_s}


def check_scene_io_and_edits(stress, arrays) -> dict:
    """Phase 13: (a, b) edits and resume with fp16 and bf16 state, (c) the
    asset import across the dense limit, (d) the terrain edit, (e) the
    scene npz round trip; files in a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        res = {dt: check_edits_and_resume(tmp, dt) for dt in ("float16", "bfloat16")}
        res["import"] = check_asset_import(tmp)
        res["terrain"] = check_terrain_edit(stress, arrays)
        res["npz"] = check_scene_npz(tmp)
    log("phase 13: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# 14. gradients and the train steps
# ---------------------------------------------------------------------------

GRAD_PARAMS = ("mat_colour", "mat_emission", "cam_frame")
WHITE, RED, LIGHT = 0, 1, 3       # the Cornell box's material ids


def grad_config(h, w, intersect: str = "on", bounces: int = 3, steps: int = 5):
    """A differentiable frame's RenderConfig: the plain filters (the filter
    kernels refuse autograd), the intersector's kernels or plain versions,
    fp32 state, TRACE_CHUNKS lane chunks, TAA on."""
    from svgf_tpu_torch.config import RenderConfig, SVGFConfig, TracingConfig

    return RenderConfig(width=w, height=h, state_dtype="float32", keep_taps=False,
                        use_pallas="off", use_pallas_intersect=intersect,
                        trace_chunks=TRACE_CHUNKS, svgf=SVGFConfig(spatial_filter_steps=steps),
                        tracing=TracingConfig(bounces=bounces))


def with_camera(arrays, frame):
    """The arrays with camera 0 at `frame`, standing still (cam_prev_frame
    the same)."""
    f = torch.as_tensor(np.asarray(frame), dtype=torch.float32, device=arrays.cam_frame.device)
    cam, prev = arrays.cam_frame.clone(), arrays.cam_prev_frame.clone()
    cam[0], prev[0] = f, f
    return dataclasses.replace(arrays, cam_frame=cam, cam_prev_frame=prev)


def seeded_target(h, w, part=None):
    """The seeded target image (the whole frame's, or rows/columns `part`)."""
    t = torch.as_tensor(np.random.default_rng(14).uniform(0, 1, (h, w, 3)),
                        dtype=torch.float32, device=DEVICE)
    return t if part is None else t[part].contiguous()


def warm_state(arrays, config):
    """The fp32 state after one frame from the initial state (no graph): a
    step from it runs the temporal path."""
    from svgf_tpu_torch.render.pipeline import render_frame
    from svgf_tpu_torch.render.types import TemporalState

    with torch.no_grad():
        _, state = render_frame(arrays, TemporalState.initial(
            config.height, config.width, torch.float32, DEVICE), config)
    return state


def train_step(arrays, state, config, params: dict, target, checkpoint: bool = False):
    """The unsharded train step: render_frame with `params` in the arrays,
    the loss mean((final - target)**2), its gradients. Returns (loss,
    grads, the next state, {forward_ms, backward_ms, step_ms} by CUDA
    events)."""
    from svgf_tpu_torch.render.pipeline import render_frame

    names = list(params)
    leaves = [params[k].detach().clone().requires_grad_(True) for k in names]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    with torch.enable_grad():
        out, new_state = render_frame(dataclasses.replace(arrays, **dict(zip(names, leaves))),
                                      state, config, checkpoint=checkpoint)
        loss = ((out.final - target) ** 2).mean()
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
    ev[2].record()
    torch.cuda.synchronize()
    ms = {"forward_ms": ev[0].elapsed_time(ev[1]), "backward_ms": ev[1].elapsed_time(ev[2]),
          "step_ms": ev[0].elapsed_time(ev[2])}
    return loss.detach(), dict(zip(names, grads)), new_state, ms


def peak_step(label, *args, **kw):
    """train_step with the peak memory it allocated (MiB) and its times logged."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, grads, state, ms = train_step(*args, **kw)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"{label}: loss {float(loss):.6e}; forward {ms['forward_ms']:.3f} ms, backward "
        f"{ms['backward_ms']:.3f} ms (x{ms['backward_ms'] / ms['forward_ms']:.2f}), step "
        f"{ms['step_ms']:.3f} ms; peak memory {peak:.1f} MiB")
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), f"{label}: non-finite gradient of {name}"
    assert bool(torch.isfinite(loss)), f"{label}: non-finite loss"
    return loss, grads, state, {**ms, "peak_mib": peak}


def step_device_kernels(label, arrays, state, config, params, target) -> dict:
    """The device kernels of one train step's forward and of its backward
    (torch.profiler, one session each): counts, device ms and the top
    operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from svgf_tpu_torch.render.pipeline import render_frame

    names = list(params)
    leaves = [params[k].detach().clone().requires_grad_(True) for k in names]
    res = {}
    with torch.enable_grad():
        with profile(activities=[ProfilerActivity.CUDA]) as pf:
            out, _ = render_frame(dataclasses.replace(arrays, **dict(zip(names, leaves))),
                                  state, config)
            loss = ((out.final - target) ** 2).mean()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as pb:
            torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
    for part, prof in (("forward", pf), ("backward", pb)):
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
        res[part] = {"device_kernels": len(events), "device_ms": busy}
        log(f"{label} {part}: {len(events)} device kernels, {busy:.3f} ms of device time; top:")
        top = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)[:6]
        for e in top:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    return res


def max_grad_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def check_cornell_train_step() -> dict:
    """(a) The Cornell train step at 1920x1080: K5 picks the winners and
    torch recomputes t/u/v; launches, finite and useful gradients, two
    identical steps, the peak memory with and without checkpointing, the
    device kernels of the forward and the backward, and the same step
    through the plain intersector on the card (checkpointed: its dense
    sweep keeps (lanes x triangles) temporaries) under the parity policy."""
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches
    from svgf_tpu_torch.parallel.checks import assert_sharded_parity
    from svgf_tpu_torch.scenes.cornell import cornell_box

    cfg = grad_config(H, W)
    arrays = with_camera(cornell_box(aspect=W / H).flatten(device=DEVICE), cornell_orbit(1))
    params = {k: getattr(arrays, k) for k in GRAD_PARAMS}
    state, target = warm_state(arrays, cfg), seeded_target(H, W)

    reset_launches()
    loss, grads, new_state, ms = peak_step("(a) Cornell 1080p train step, K5", arrays, state, cfg,
                                           params, target)
    launches = dict(LAUNCHES)
    expect = dict.fromkeys(LAUNCHES, 0)
    expect["intersect_dense"] = TRACE_CHUNKS * (1 + cfg.tracing.bounces)
    log(f"(a) launches in the train step: {launches}")
    assert launches == expect, (launches, expect)
    seen = [int(m) for m in new_state.gbuffer.material.unique() if int(m) >= 0]
    dark = [m for m in seen if float(arrays.mat_emission[m].max()) == 0.0]
    zero = [m for m in dark if float(grads["mat_colour"][m].abs().max()) == 0.0]
    log(f"(a) materials the camera sees {seen}; colour gradient's largest entry each: "
        f"{[float(grads['mat_colour'][m].abs().max()) for m in seen]}")
    assert dark and not zero, f"materials seen without a colour gradient: {zero}"

    loss2, grads2, _, ms2 = peak_step("(a) the same step again", arrays, state, cfg, params, target)
    log(f"(a) two identical steps: loss difference {float((loss - loss2).abs()):.3e}, largest "
        f"gradient difference {max_grad_diff(grads, grads2):.3e} (the gathers' backward adds "
        "in an order the card picks)")
    lc, gc, _, msc = peak_step("(a) checkpointed step", arrays, state, cfg, params, target,
                               checkpoint=True)
    assert_sharded_parity("checkpointed step against the step", lc, gc, loss, grads)
    kernels = step_device_kernels("(a) Cornell 1080p train step", arrays, state, cfg, params,
                                  target)
    plain_cfg = grad_config(H, W, intersect="off")
    lp, gp, _, msp = peak_step("(a) the step through the plain intersector, checkpointed",
                               arrays, state, plain_cfg, params, target, checkpoint=True)
    assert_sharded_parity("K5 step against the plain intersector's", loss, grads, lp, gp)
    log(f"(a) K5 step against the plain intersector's: loss {float(loss):.6e} / "
        f"{float(lp):.6e}, largest gradient difference {max_grad_diff(grads, gp):.3e}")
    return {"arrays": arrays, "state": state, "target": target, "loss": loss, "grads": grads,
            "launches": launches["intersect_dense"],
            "summary": {"step": ms, "again": ms2, "checkpointed": msc, "plain": msp,
                        "kernels": kernels, "repeat_max_grad_diff": max_grad_diff(grads, grads2)}}


def fd_check(label, loss, x, idx, eps: float, analytic: float, bar: float, floor: float):
    """Central difference of loss(x) at x[idx] against `analytic`."""
    with torch.no_grad():
        xp, xm = x.clone(), x.clone()
        xp[idx] += eps
        xm[idx] -= eps
        fd = (float(loss(xp)) - float(loss(xm))) / (2 * eps)
    rel = abs(fd - analytic) / max(abs(fd), abs(analytic), floor)
    log(f"(b) {label}: finite difference {fd:.6e}, autograd {analytic:.6e}, relative {rel:.4f} "
        f"(bar {bar})")
    assert rel < bar, (label, fd, analytic)
    return rel


# the camera FD's view: 0.2 rad round the box and 0.05 up, where the x
# translation's derivative is no near-cancellation of the box's mirror halves
FD_POSE_ANGLES = (0.2, 0.05)


def frame_final(arrays, config, cam_frame):
    from svgf_tpu_torch.render.pipeline import render_frame
    from svgf_tpu_torch.render.types import TemporalState

    out, _ = render_frame(dataclasses.replace(arrays, cam_frame=cam_frame),
                          TemporalState.initial(config.height, config.width, torch.float32,
                                                DEVICE), config)
    return out.final


def camera_fd(label, arrays, config, comp: int, held: bool) -> float:
    """tests/test_camera_grad.py's check of one camera translation: the
    central difference (step 1e-3) of the masked loss mean(mask * final**2)
    against autograd. At 480x270 and 1 spp a 1e-3 move also flips some
    shadow and bounce rays past an occluder's edge (a jump the pathwise
    gradient leaves out, as it leaves out the silhouettes the interior
    mask drops): with `held`, the mask also drops each pixel whose two
    one-sided differences disagree (a jump on one side) and the check
    holds the result to the bar 0.15; without, it only logs the interior
    mask's numbers."""
    from svgf_tpu_torch.scripts.grad_fd_explore import interior_mask

    h, w, eps = config.height, config.width, 1e-3
    interior = interior_mask(arrays, h, w, "on")
    with torch.no_grad():
        shifted = []
        for sign in (1.0, -1.0):
            cf = arrays.cam_frame.clone()
            cf[0, comp, 3] += sign * eps
            shifted.append(frame_final(arrays, config, cf))
        f0 = frame_final(arrays, config, arrays.cam_frame)
    up, down = shifted[0] - f0, f0 - shifted[1]
    jump = ((up - down).abs() > 0.5 * (up.abs() + down.abs()) + 1e-6).any(-1, keepdim=True)
    mask = interior * (~jump).float() if held else interior
    loss = lambda f: float((mask * f ** 2).sum() / mask.sum())
    fd = (loss(shifted[0]) - loss(shifted[1])) / (2 * eps)
    cf = arrays.cam_frame.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((mask * frame_final(arrays, config, cf) ** 2).sum() / mask.sum(),
                               [cf])
    analytic = float(g[0, comp, 3])
    rel = abs(fd - analytic) / max(abs(fd), abs(analytic), 1e-6)
    log(f"(b) camera {'xyz'[comp]} translation, {label}: {int(mask.sum())} pixels "
        f"({int((interior * jump).sum())} interior pixels jump), finite difference {fd:.6e}, autograd {analytic:.6e}, "
        f"relative {rel:.4f}" + (" (bar 0.15)" if held else " (not held: interior mask only)"))
    if held:
        assert rel < 0.15, (label, comp, fd, analytic)
    return rel


def orbit_poses(n: int):
    """tests/test_orbit_grad.py's poses: 0.03 rad a frame round the box."""
    from svgf_tpu_torch.core.camera import look_at_frame

    return [np.asarray(look_at_frame(eye=[3.4 * np.sin(0.03 * k), 0.0, 3.4 * np.cos(0.03 * k)],
                                     target=[0, 0, 0]), np.float32) for k in range(n)]


def check_fd_and_orbit() -> dict:
    """(b) Finite differences on the card at 480x270 (tests/test_camera_grad
    and test_orbit_grad's configurations, steps and bars) and (c) the
    4-frame orbit that differentiates through the carried state."""
    from svgf_tpu_torch.core.camera import orbit_frame
    from svgf_tpu_torch.render.pipeline import render_frame
    from svgf_tpu_torch.render.types import TemporalState
    from svgf_tpu_torch.scenes.cornell import cornell_box

    h, w = SMALL_H, SMALL_W
    arrays = cornell_box(aspect=w / h).flatten(device=DEVICE)
    theta, phi = FD_POSE_ANGLES
    side = orbit_frame([0.0, 0.0, 0.0], 3.4, theta=theta, phi=phi)
    res = {}
    # the camera: one frame, x and z translation, the masked loss
    cfg1 = grad_config(h, w, bounces=1, steps=1)
    for label, pose, held in (("the tests' pose", None, False), ("a side view", side, True)):
        a = arrays if pose is None else with_camera(arrays, pose)
        for comp in (0, 2):
            rel = camera_fd(label, a, cfg1, comp, held)
            if held:
                res[f"camera_{'xyz'[comp]}"] = rel

    # (c) the orbit: 4 frames, 2 bounces, the state carried
    cfg2 = grad_config(h, w, bounces=2, steps=1)
    poses = [torch.as_tensor(p, device=DEVICE) for p in orbit_poses(FRAMES)]

    def orbit_loss(mat_colour, mat_emission, cam_delta):
        state = TemporalState.initial(h, w, torch.float32, DEVICE)
        shift = torch.cat([torch.cat([torch.zeros(3, 3, device=DEVICE), cam_delta[:, None]], 1),
                           torch.zeros(1, 4, device=DEVICE)])
        out = None
        for k in range(FRAMES):
            sc = dataclasses.replace(arrays, mat_colour=mat_colour, mat_emission=mat_emission,
                                     cam_frame=(poses[k] + shift)[None],
                                     cam_prev_frame=(poses[max(k - 1, 0)] + shift)[None])
            out, state = render_frame(sc, state, cfg2)
        return (out.final ** 2).mean()

    leaves = [arrays.mat_colour.clone().requires_grad_(True),
              arrays.mat_emission.clone().requires_grad_(True),
              torch.zeros(3, device=DEVICE, requires_grad=True)]
    t0 = time.perf_counter()
    g_col, g_emi, g_cam = torch.autograd.grad(orbit_loss(*leaves), leaves)
    torch.cuda.synchronize()
    log(f"(c) orbit, {FRAMES} frames at {w}x{h} through the carried state: "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms; largest gradient of mat_colour "
        f"{float(g_col.abs().max()):.4e}, mat_emission {float(g_emi.abs().max()):.4e}, "
        f"camera {g_cam.tolist()}")
    for name, gg in (("mat_colour", g_col), ("mat_emission", g_emi), ("camera", g_cam)):
        assert bool(torch.isfinite(gg).all()), f"(c) non-finite {name} gradient"
        assert float(gg.abs().max()) > 0, f"(c) {name} gradient identically zero"
    assert bool((g_col.abs().amax(1)[:3] > 0).all()), "(c) a wall without colour gradient"
    zero3 = torch.zeros(3, device=DEVICE)
    res["mat_colour"] = fd_check(
        "white wall's red albedo", lambda x: orbit_loss(x, arrays.mat_emission, zero3),
        arrays.mat_colour, (WHITE, 0), 1e-3, float(g_col[WHITE, 0]), 0.08, 1e-7)
    res["mat_emission"] = fd_check(
        "light's red emission", lambda x: orbit_loss(arrays.mat_colour, x, zero3),
        arrays.mat_emission, (LIGHT, 0), 1e-2, float(g_emi[LIGHT, 0]), 0.08, 1e-7)
    return res


def check_terrain_train_step(arrays) -> dict:
    """(d) The terrain's train step: K6 picks the winners at 1920x1080
    ({mat_colour, cam_frame}), and at 480x270 the same step against the
    plain scene-BVH walk under the parity policy."""
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches
    from svgf_tpu_torch.parallel.checks import assert_sharded_parity

    arrays = with_camera(arrays, stress_orbit(1))
    names = ("mat_colour", "cam_frame")
    params = {k: getattr(arrays, k) for k in names}
    cfg = grad_config(H, W)
    state = warm_state(arrays, cfg)
    reset_launches()
    peak_step("(d) terrain 1080p train step, K6", arrays, state, cfg, params, seeded_target(H, W))
    launches = dict(LAUNCHES)
    expect = dict.fromkeys(LAUNCHES, 0)
    expect["intersect_clustered"] = TRACE_CHUNKS * (1 + cfg.tracing.bounces)
    log(f"(d) launches in the train step: {launches}")
    assert launches == expect, (launches, expect)
    _, _, _, ms = peak_step("(d) the same step again", arrays, state, cfg, params,
                            seeded_target(H, W))
    small = {}
    for intersect in ("on", "off"):
        c = grad_config(SMALL_H, SMALL_W, intersect=intersect)
        small[intersect] = train_step(arrays, warm_state(arrays, c), c, params,
                                      seeded_target(SMALL_H, SMALL_W))
    (lk, gk, _, _), (lp, gp, _, _) = small["on"], small["off"]
    assert_sharded_parity("terrain 480x270, K6 against the plain walk", lk, gk, lp, gp)
    log(f"(d) 480x270, K6 against the plain walk: loss {float(lk):.6e} / {float(lp):.6e}, "
        f"largest gradient difference {max_grad_diff(gk, gp):.3e}")
    return {"launches": launches["intersect_clustered"], "step": ms}


def check_mesh_train_steps(cornell: dict) -> dict:
    """(e) make_train_step on one NCCL rank and (f) make_tiled_step and
    make_tiled_train_step on a 1 x 1 tile mesh of it, at 1920x1080: the
    train steps against (a) under the parity policy, FRAMES tiled frames
    against the unsharded frames with the same filters and K5."""
    import torch.distributed as dist

    from svgf_tpu_torch.parallel import (
        init_distributed, make_row_mesh, make_tile_mesh, make_tiled_step,
        make_tiled_train_step, make_train_step,
    )
    from svgf_tpu_torch.parallel.checks import assert_sharded_parity
    from svgf_tpu_torch.render.pipeline import Renderer, render_frame
    from svgf_tpu_torch.render.types import TemporalState
    from svgf_tpu_torch.scenes.cornell import cornell_box

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(free_port()))
    device = init_distributed()
    cfg = grad_config(H, W)
    arrays, state, target = cornell["arrays"], cornell["state"], cornell["target"]
    params = {k: getattr(arrays, k) for k in GRAD_PARAMS}
    res = {}
    try:
        log(f"(e, f) one rank, backend {dist.get_backend()} on {device}")
        for label, mesh, make in (("(e) row mesh", make_row_mesh(), make_train_step),
                                  ("(f) 1 x 1 tile mesh", make_tile_mesh(1, 1),
                                   make_tiled_train_step)):
            step = make(cfg, mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, grads, _ = step(params, arrays, state, target)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2**20
            assert_sharded_parity(label, loss, grads, cornell["loss"], cornell["grads"])
            log(f"{label} train step: {ms:.1f} ms, peak {peak:.1f} MiB, loss {float(loss):.6e}, "
                f"largest gradient difference from (a) {max_grad_diff(grads, cornell['grads']):.3e}")
            res[label] = {"ms": ms, "peak_mib": peak}

        # (f) the tiled frames against the unsharded route with the same filters and K5
        frames_cfg = dataclasses.replace(cfg, state_dtype="float16")
        tiled = make_tiled_step(frames_cfg, make_tile_mesh(1, 1))
        holder = Renderer(cornell_box(aspect=W / H), frames_cfg, device=DEVICE)   # the camera
        st_t = TemporalState.initial(H, W, torch.float16, DEVICE)
        st_u = TemporalState.initial(H, W, torch.float16, DEVICE)
        worst = 0.0
        with torch.no_grad():
            for f in range(FRAMES):
                if cornell_orbit(f) is not None:
                    holder.update_camera(cornell_orbit(f))
                out_t, st_t = tiled(holder.arrays, st_t)
                out_u, st_u = render_frame(holder.arrays, st_u, frames_cfg)
                worst = max(worst, float((out_t.final - out_u.final).abs().max()))
        log(f"(f) {FRAMES} tiled frames (1 x 1, plain filters, K5) against the unsharded "
            f"route's: max abs error {worst:.3e} (bar 2e-5)")
        assert worst <= 2e-5, worst
        res["tiled_frames_max_err"] = worst
        return res
    finally:
        dist.destroy_process_group()


def check_filter_kernels_refuse_grad() -> str:
    """(g) Fault 9: a frame on the kernel route (use_pallas="on") with
    mat_colour requiring grad raises KernelAutogradError at the first
    filter stage, never a result without its gradient."""
    from svgf_tpu_torch.kernels.filter import KernelAutogradError, refuse_autograd
    from svgf_tpu_torch.render.pipeline import render_frame
    from svgf_tpu_torch.render.types import TemporalState
    from svgf_tpu_torch.scenes.cornell import cornell_box

    cfg = dataclasses.replace(grad_config(SMALL_H, SMALL_W), use_pallas="on")
    arrays = cornell_box(aspect=W / H).flatten(device=DEVICE)
    colour = arrays.mat_colour.clone().requires_grad_(True)
    probe = torch.zeros(1, requires_grad=True)
    try:
        refuse_autograd("temporal_filter", probe)
    except KernelAutogradError as e:
        want = str(e)
    try:
        with torch.enable_grad():
            render_frame(dataclasses.replace(arrays, mat_colour=colour),
                         TemporalState.initial(SMALL_H, SMALL_W, torch.float32, DEVICE), cfg)
    except KernelAutogradError as e:
        assert str(e) == want, (str(e), want)
        log(f"(g) the kernel route refused autograd: {e}")
        return str(e)
    raise AssertionError("(g) the kernel route returned a frame from inputs that require grad")


def check_gradients(arrays) -> dict:
    """Phase 14: gradients and the train steps (a)-(g)."""
    cornell = check_cornell_train_step()
    res = {"cornell": cornell["summary"], "fd": check_fd_and_orbit(),
           "terrain": check_terrain_train_step(arrays),
           "mesh": check_mesh_train_steps(cornell), "refusal": check_filter_kernels_refuse_grad()}
    log("phase 14: " + json.dumps(res))
    return {"intersect_dense": cornell["launches"],
            "intersect_clustered": res["terrain"]["launches"]}


# ---------------------------------------------------------------------------
# 15. the native builder, the per-shape walk and the orbit renderer
# ---------------------------------------------------------------------------

ORBIT_FRAMES = 6      # render_orbit's 1080p run and its 640x360 run before the resume
ORBIT_RESUMED = 3     # the frames of the --resume run
BRUTE_RAYS = 4096     # rays of the brute force against K6


def build_host_library() -> float:
    """Phase 15 (a): compile csrc_host/bvh_builder.cpp with g++
    (accel/native.py) and load it; returns the build's seconds."""
    from svgf_tpu_torch.accel import native

    found = native.library_path().exists()
    t0 = time.perf_counter()
    path = native.build()
    native.library()
    seconds = time.perf_counter() - t0
    log(f"host library {path.name}: {'found' if found else 'built'} in {seconds:.3f} s "
        f"(g++ {' '.join(native.CXX_FLAGS)})")
    return seconds


def skip_link_depth(skip, internal) -> int:
    """Internal nodes on the longest root-to-leaf path of a DFS
    skip-linked tree: the most internal nodes whose [i, skip[i]) subtree
    ranges hold one node."""
    skip, i = np.asarray(skip), np.flatnonzero(np.asarray(internal))
    d = np.zeros(len(skip) + 1, np.int64)
    np.add.at(d, i, 1)
    np.add.at(d, skip[i], -1)
    return int(np.cumsum(d)[:-1].max())


def k6_on_tree(label, arrays) -> dict:
    """K6 alone and through its wrapper on a terrain's 1080p primary rays,
    the child-pair records and triangle tests a ray, and its bound on them
    (phase 5's formula)."""
    from svgf_tpu_torch.kernels import intersect as KI

    ro, rd = stress_rays(arrays)[0]["primary"]
    _, _, st = KI.bvh_hit(arrays, *KI._rays(ro, rd, None, None), stats=True)
    c = visit_counts(f"{label}, K6 (child-pair records)", st[:, 0], st[:, 1])
    fn = lambda: KI.intersect_clustered_kernel(arrays, ro, rd)
    t = time_call(fn)
    tris, bvh = KI.packed_scene(arrays)
    b = bound(nbytes(ro, rd, *fn()) + nbytes(bvh.nodes, tris),
              ro.shape[0] * (c["visits"] * 2 * OPS_SLAB + c["tests"] * OPS_MT + OPS_RECOMPUTE))
    log(f"  {label}: K6 {t['ms']:.4f} ms through the wrapper, {t['alone_ms']:.4f} ms alone; bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']}")
    return {**t, **c, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}


def check_native_terrain(stress, numpy_arrays, numpy_flatten_s: float) -> tuple:
    """Phase 15 (b): the terrain flattened with the native builder against
    phase 5's NumPy flatten; K6 against the plain walk of the native tree;
    K6 on both trees; FRAMES 1080p frames through K1-K4 and K6 against the
    plain route. Returns (the results, the native arrays)."""
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches
    from svgf_tpu_torch.scenes.stress import stress_scene

    scene = stress_scene(n=STRESS_N, aspect=W / H)
    t0 = time.perf_counter()
    with bvh_builder("native"):
        arrays = scene.flatten(device=DEVICE)
    torch.cuda.synchronize()
    native_s = time.perf_counter() - t0
    res = {"flatten_s": {"numpy": numpy_flatten_s, "native": native_s}, "trees": {}}
    for name, sc, a in (("numpy", stress, numpy_arrays), ("native", scene, arrays)):
        blas = sc.shapes[0].blas
        res["trees"][name] = {
            "terrain_blas_nodes": blas.n_nodes,
            "terrain_blas_depth": skip_link_depth(blas.skip, blas.tri_count == 0),
            "scene_bvh_nodes": int(a.wbvh_skip.shape[0]),
            "scene_bvh_depth": KI.packed_scene(a)[1].depth,
        }
    log(f"terrain flatten: native builder {native_s:.3f} s host, NumPy builder (phase 5) "
        f"{numpy_flatten_s:.3f} s; trees {res['trees']}")
    assert not torch.equal(arrays.world_tri_prim, numpy_arrays.world_tri_prim)
    assert KI.spill_entries(res["trees"]["native"]["scene_bvh_depth"]) == 0

    rays, _ = stress_rays(arrays)
    log("K6 on the native terrain tree vs its plain walk:")
    res["max_abs_err"] = max(check_k6_case(arrays, f"{name} ({ro.shape[0]} rays)", ro, rd, {})
                             for name, (ro, rd) in rays.items())
    res["k6"] = {name: k6_on_tree(f"{name} tree, primary", a)
                 for name, a in (("numpy", numpy_arrays), ("native", arrays))}

    flat = Flattened(scene, arrays)
    reset_launches()
    out, stages, r = run_frames(flat, stress_orbit, H, W, "on", TRACE_CHUNKS)
    launches = dict(LAUNCHES)
    log(f"terrain (native tree) 1080p launches over {FRAMES} frames: {launches}")
    assert launches == expected_launches("intersect_clustered", TRACE_CHUNKS, r.arrays.meta), \
        launches
    check_image(out, H, W, "terrain (native tree)")
    log_stages("terrain (native tree) kernels", stages)
    t0 = time.perf_counter()
    plain_out, plain_stages, _ = run_frames(flat, stress_orbit, H, W, "off", TRACE_CHUNKS)
    res["plain_frames_s"] = time.perf_counter() - t0
    compare_frames("terrain (native tree) 1080p", out, plain_out)
    log_stages("terrain (native tree) plain", plain_stages)
    res["frame_ms"] = statistics.median(st["frame"] for st in stages[1:])
    return res, arrays


def check_only_instance(arrays) -> dict:
    """Phase 15 (d) on the native terrain: K6 with only_instance (0, the
    terrain, on the 1080p primary rays; 1, the light, on rays straight up)
    against the plain route's walk of that instance's BLAS in object space
    (intersect_instances -> traverse_shape), by the K6 bars: hit sets
    equal, the winner on >= 99.99% of lanes, relative dist < 2e-3; the
    Hit K6 writes bit for bit its winner's recompute. Then
    intersect_brute_force on BRUTE_RAYS rays (half primary, half
    scrambled) against K6: the hit sets equal, dist to rtol 1e-4."""
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.ops.intersect import intersect_brute_force, intersect_instances, start_dist

    rays, rng = stress_rays(arrays)
    ro_p, rd_p = rays["primary"]
    n = SCRAMBLED
    ro_up = cuda(np.stack([rng.uniform(-1.2, 1.2, n), np.full(n, 0.5), rng.uniform(-1.2, 1.2, n)], 1))
    rd_up = cuda(np.tile([[0.0, 1.0, 0.0]], (n, 1)))
    log("K6 with only_instance vs the per-instance BLAS walk (traverse_shape), native terrain:")
    res = {}
    for label, ro, rd, inst in (("primary, only_instance=0", ro_p, rd_p, 0),
                                ("straight up, only_instance=1", ro_up, rd_up, 1)):
        got = check_k6_hit(arrays, label, ro, rd, {"only_instance": inst})
        t0 = time.perf_counter()
        want = intersect_instances(arrays, ro, rd, only_instance=inst)
        torch.cuda.synchronize()
        walk_s = time.perf_counter() - t0
        st = compare_hits(f"{label}, K6 vs traverse_shape ({walk_s:.3f} s)", got, want,
                          start_dist(None, ro.shape[0], ro.device))
        assert st["hits"] > 0 and st["hit_sets_differ"] == 0, (label, st)
        assert st["rel_max"] < 2e-3 and st["agree"] >= 0.9999, (label, st)
        assert bool((got.instance[got.dist < 1e29] == inst).all()), label
        res[label] = {**st, "walk_s": walk_s}

    pick = torch.from_numpy(rng.choice(ro_p.shape[0], BRUTE_RAYS // 2, replace=False)).to(DEVICE)
    ro = torch.cat([ro_p[pick], rays["scrambled"][0][: BRUTE_RAYS // 2]])
    rd = torch.cat([rd_p[pick], rays["scrambled"][1][: BRUTE_RAYS // 2]])
    t0 = time.perf_counter()
    brute = intersect_brute_force(arrays, ro, rd)
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t0
    got = KI.intersect_clustered_kernel(arrays, ro, rd)
    hit = brute.dist < 1e29
    rel = ((got.dist - brute.dist).abs() / brute.dist)[hit]
    agree = float(((got.prim == brute.prim) | ~hit).float().mean())
    log(f"  intersect_brute_force on {BRUTE_RAYS} rays ({brute_s:.3f} s) vs K6: hits "
        f"{int(hit.sum())}, hit sets differ {int((hit != (got.dist < 1e29)).sum())}, relative "
        f"dist max {float(rel.max()):.3e}, winners agree {agree:.6f}")
    assert hit.any() and torch.equal(hit, got.dist < 1e29)
    assert float(rel.max()) < 1e-4
    res["brute_force"] = {"s": brute_s, "rel_max": float(rel.max()), "agree": agree}
    return res


def check_render_orbit(tmp: str) -> dict:
    """Phase 15 (e): render_orbit's main on the Cornell box through K1-K5:
    at 1920x1080 for ORBIT_FRAMES frames (its 48 trace chunks), with the
    launches of each frame checked, frame ms and the PNGs; then at its
    640x360 default for ORBIT_FRAMES frames and --resume for ORBIT_RESUMED
    more, whose last frame equals, with max error 0, the same frames
    rendered by a new Renderer from the first run's state in memory."""
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches
    from svgf_tpu_torch.render.pipeline import Renderer
    from svgf_tpu_torch.scripts import render_orbit
    from svgf_tpu_torch.utils.image import read_png

    out = os.path.join(tmp, "orbit_1080p")
    reset_launches()
    t0 = time.perf_counter()
    run = render_orbit.main(["--width", str(W), "--height", str(H), "--frames", str(ORBIT_FRAMES),
                             "--out", out])
    total_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    cfg, meta = run.renderer.config, run.renderer.arrays.meta
    expect = expected_launches("intersect_dense", cfg.trace_chunks, meta, ORBIT_FRAMES)
    per_frame = {k: v / ORBIT_FRAMES for k, v in launches.items() if v}
    log(f"render_orbit 1080p: {ORBIT_FRAMES} frames in {total_s:.3f} s, frame ms "
        f"{[round(m, 3) for m in run.frame_ms]}; trace_chunks {cfg.trace_chunks}; launches a "
        f"frame {per_frame}")
    assert launches == expect, (launches, expect)
    assert [os.path.basename(p) for p in run.pngs] == \
        [f"frame_{f:04d}.png" for f in range(ORBIT_FRAMES)]
    assert read_png(run.pngs[-1]).shape == (H, W, 3)
    img = run.last_image
    assert img.shape == (H, W, 3) and np.isfinite(img).all() and 0.0 <= img.min() <= img.max() <= 1.0
    assert img.mean() > 0.05, "the orbit's last frame is black"
    res = {"frame_ms": run.frame_ms, "median_ms": statistics.median(run.frame_ms[1:]),
           "launches_a_frame": per_frame, "total_s": total_s}

    out = os.path.join(tmp, "orbit_default")
    first = render_orbit.main(["--frames", str(ORBIT_FRAMES), "--out", out])
    t0 = time.perf_counter()
    resumed = render_orbit.main(["--frames", str(ORBIT_RESUMED), "--out", out,
                                 "--resume", os.path.join(out, "ckpt.npz")])
    res["resume_s"] = time.perf_counter() - t0
    args = render_orbit.parse_args(["--frames", str(ORBIT_RESUMED)])
    cfg = render_orbit.render_config(args)
    scene, target, distance = render_orbit.orbit_scene(args.scene, cfg.width / cfg.height)
    r = Renderer(scene, cfg, device=DEVICE)
    r.state = first.renderer.state
    for f in range(ORBIT_FRAMES, ORBIT_FRAMES + ORBIT_RESUMED):
        r.update_camera(render_orbit.orbit_pose(f, args, target, distance))
        want = r.step().image.cpu().numpy()
    d = float(np.abs(resumed.last_image - want).max())
    log(f"render_orbit {cfg.width}x{cfg.height}: frame ms {[round(m, 3) for m in first.frame_ms]}; "
        f"resumed at frame {ORBIT_FRAMES} for {ORBIT_RESUMED} frames "
        f"({[os.path.basename(p) for p in resumed.pngs]}), last frame against the same frames "
        f"from the state in memory: max error {d}")
    assert resumed.renderer.state.frame_idx == ORBIT_FRAMES + ORBIT_RESUMED
    assert d == 0.0, d
    res["default_frame_ms"] = first.frame_ms
    return res


def check_native_and_orbit(stress, numpy_arrays, numpy_flatten_s: float,
                           host_build_s: float) -> dict:
    """Phase 15: (a) the host library's build seconds, (b) the native
    terrain, (c) the native asset import, (d) only_instance and the brute
    force, (e) render_orbit."""
    res = {"host_build_s": host_build_s}
    res["terrain"], arrays = check_native_terrain(stress, numpy_arrays, numpy_flatten_s)
    with tempfile.TemporaryDirectory() as tmp:
        res["import"] = check_asset_import(tmp, "native")
        res["only_instance"] = check_only_instance(arrays)
        res["orbit"] = check_render_orbit(tmp)
    log("phase 15: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# svgf_tpu's quick start with only the package name changed
# ---------------------------------------------------------------------------


def quick_start_frames(label, scene, config, smi: str) -> dict:
    """FRAMES frames of Renderer(scene, config).step() on the Renderer's
    default device, the camera kept, the launch counts set to 0 just before
    them and read just after and held to expected_launches; the image; frame
    FRAMES against the same frames on the plain route (phase 6's bars).
    Returns the frame ms of both routes, medians of frames 2-FRAMES."""
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches
    from svgf_tpu_torch.render.pipeline import Renderer

    keep = lambda f: None
    reset_launches()
    r = Renderer(scene, config)
    out, stages = step_frames(r, keep, FRAMES)
    launches = dict(LAUNCHES)
    assert r.device.type == "cuda", r.device
    log(f"{label} launches over {FRAMES} frames: {launches}")
    expect = expected_launches("intersect_dense", config.trace_chunks, r.arrays.meta, FRAMES,
                               config.svgf.spatial_filter_steps)
    assert launches == expect, (label, launches, expect)
    check_image(out, config.height, config.width, label)
    plain_out, plain_stages = step_frames(
        Renderer(scene, dataclasses.replace(config, use_pallas="off")), keep, FRAMES)
    compare_frames(label, out, plain_out)
    ms = {"frame_ms": statistics.median(st["frame"] for st in stages[1:]),
          "plain_frame_ms": statistics.median(st["frame"] for st in plain_stages[1:])}
    log(f"{label} frame ms (median of frames 2-{FRAMES}) on {smi}: kernels {ms['frame_ms']:.3f}, "
        f"plain {ms['plain_frame_ms']:.3f}; every frame {[round(st['frame'], 3) for st in stages]}")
    return ms


def check_quick_start(smi: str) -> dict:
    """svgf_tpu's quick start (its README) with only the package name
    changed: Renderer(cornell_box(aspect=16/9), RenderConfig(width=640,
    height=360)) on its default device, the configuration's defaults (3
    a-trous steps, 1 trace chunk, fp16 state); then __graft_entry__.entry()'s
    frame: 512x288, 3 bounces, batch 1, 5 a-trous steps, fp16 state. Each
    through quick_start_frames. Also Hit.none on the card by default, and
    the SceneArrays counts of the card's arrays against the host scene's."""
    from svgf_tpu_torch import RenderConfig, SVGFConfig, TracingConfig
    from svgf_tpu_torch.ops.intersect import Hit
    from svgf_tpu_torch.scenes import cornell_box

    res = {"quick start 640x360": quick_start_frames(
        "quick start 640x360", cornell_box(aspect=16/9), RenderConfig(width=640, height=360), smi)}
    w, h = 512, 288
    scene = cornell_box(aspect=w / h)
    for cam in scene.cameras:
        cam.aspect = w / h
    cfg = RenderConfig(width=w, height=h, tracing=TracingConfig(bounces=3, batch=1),
                       svgf=SVGFConfig(spatial_filter_steps=5))
    assert cfg.state_dtype == "float16"
    res["entry 512x288"] = quick_start_frames("entry 512x288", scene, cfg, smi)

    none = Hit.none((H * W,))
    assert all(x.device.type == "cuda" for x in none) and not bool(none.valid.any())
    card, host = scene.flatten(), scene.flatten(device="cpu")
    counts = {c: (getattr(card, c), getattr(host, c))
              for c in ("n_triangles", "n_instances", "n_lights", "n_environments")}
    log(f"Hit.none on {none.dist.device}; SceneArrays counts (card, host): {counts}")
    assert card.device.type == "cuda" and all(a == b for a, b in counts.values()), counts
    assert counts["n_triangles"][0] == sum(s.n_triangles for s in scene.shapes)
    assert counts["n_instances"][0] == len(scene.instances)
    return res


# ---------------------------------------------------------------------------
# the measuring tools (svgf_tpu_torch/scripts/) on the card
# ---------------------------------------------------------------------------

TOOL_CHUNKS = (48, 32, 8, 4, 2, 1)   # profile_trace's sweep, render_orbit's 48 included
BALANCE_TOL = 1e-3                   # kernel against plain route, a band's live fraction


def check_tool_rows(tool: str, rows: list, expect: dict) -> None:
    """Each row's launches in one rep equal `expect[label]` (the wrappers'
    counts), the profiler recorded every hand kernel launched in its
    session, and its figures are finite and > 0: device and host ms, the
    device kernels and their time; the hand kernels' time > 0 exactly
    where the row launched one."""
    assert [r["label"] for r in rows] == list(expect), (tool, [r["label"] for r in rows])
    for r in rows:
        assert r["launches"] == expect[r["label"]], (tool, r["label"], r["launches"],
                                                     expect[r["label"]])
        assert r["seen"] == r["launched"], (tool, r["label"], r["seen"], r["launched"])
        for k in ("device_ms", "host_ms", "kernels", "kernel_ms"):
            assert math.isfinite(r[k]) and r[k] > 0, (tool, r["label"], k, r[k])
        assert math.isfinite(r["svgf_ms"]) and (r["svgf_ms"] > 0) == bool(r["launches"]), (
            tool, r["label"], r["svgf_ms"], r["launches"])


def check_balance() -> dict:
    """measure_balance at its defaults on the kernel route (K5, one launch
    for the primary rays and one a bounce) against the plain route on the
    card: every band's live fraction within BALANCE_TOL, bounce by bounce."""
    from svgf_tpu_torch.kernels.launch import LAUNCHES
    from svgf_tpu_torch.scripts import measure_balance

    def launched(before):
        return {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]}

    before = dict(LAUNCHES)
    kern = measure_balance.main([], device=DEVICE)
    assert launched(before) == {"intersect_dense": 1 + measure_balance.BOUNCES}, launched(before)
    before = dict(LAUNCHES)
    h, w, bands = kern["h"], kern["w"], kern["bands"]
    arrays = measure_balance.scene_arrays(h, w, DEVICE)
    plain = measure_balance.balance(
        measure_balance.active_masks(arrays, h, w, measure_balance.BOUNCES, "off"), bands)
    assert launched(before) == {}, launched(before)
    err = max(abs(a - b) for pk, pp in zip(kern["per_bounce"], plain)
              for a, b in zip(pk["live_frac_per_band"] + [pk["live_frac_mean"]],
                              pp["live_frac_per_band"] + [pp["live_frac_mean"]]))
    log(f"measure_balance ({kern['scene']}, {kern['bands']} bands, {kern['h']}x{kern['w']}): "
        f"kernel route against plain, the largest difference of a band's live fraction {err}; "
        f"worst imbalance {kern['worst_imbalance']} (interleaved "
        f"{kern['worst_imbalance_interleaved']})")
    assert err <= BALANCE_TOL, err
    return {"max_frac_diff": err, "worst_imbalance": kern["worst_imbalance"],
            "worst_imbalance_interleaved": kern["worst_imbalance_interleaved"]}


def check_trace_sweep() -> dict:
    """profile_trace over TOOL_CHUNKS at 1080p: each count's launches a
    frame (K1, K2 and K5 once a G-buffer chunk and a bounce of a chunk), and
    the first frame's radiance equal at every count (max error 0: lanes
    keep their global ids); prints the lanes that differ, if any."""
    from svgf_tpu_torch.scripts import profile_trace

    sweep = profile_trace.main([str(c) for c in TOOL_CHUNKS], device=DEVICE)
    expect = {f"trace_chunks={c}": {"temporal": 1, "moments": 1, "intersect_dense": 4 * c}
              for c in TOOL_CHUNKS}
    expect[f"gbuffer alone (chunks={TOOL_CHUNKS[-1]})"] = {"intersect_dense": TOOL_CHUNKS[-1]}
    check_tool_rows("profile_trace", sweep.rows, expect)
    ref = sweep.radiance[TOOL_CHUNKS[-1]]
    errs = {}
    for c, rad in sweep.radiance.items():
        d = (rad - ref).abs().amax(-1).reshape(-1)
        errs[c] = float(d.max())
        if errs[c] != 0:
            lanes = torch.nonzero(d).reshape(-1)
            log(f"trace_chunks={c}: radiance max error {errs[c]} against {TOOL_CHUNKS[-1]} "
                f"chunk(s) on {lanes.numel()} lanes, the first {lanes[:20].tolist()}")
    log(f"profile_trace radiance against {TOOL_CHUNKS[-1]} chunk(s), max error: {errs}")
    assert all(e == 0 for e in errs.values()), errs
    return {r["label"]: {k: r[k] for k in ("device_ms", "host_ms", "kernels")}
            for r in sweep.rows}


def check_measuring_tools(smi: str) -> dict:
    """Phase 17: each measuring tool's main on the card at its defaults,
    the launch counts set to 0 just before the phase and read just after:
    measure_balance against the plain route (check_balance), profile_trace
    (check_trace_sweep), profile_trace_parts, profile_stages,
    profile_filter and profile_moments, each row's launches and figures
    held by check_tool_rows."""
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches
    from svgf_tpu_torch.scripts import (
        profile_filter, profile_moments, profile_stages, profile_trace_parts,
    )

    log(f"phase 17 on {smi}")
    reset_launches()
    res = {"balance": check_balance(), "trace": check_trace_sweep()}

    parts = profile_trace_parts.main([], device=DEVICE)
    K = 24
    k5 = {"intersect_dense": K}
    check_tool_rows("profile_trace_parts", parts, {
        "intersect_scene (pallas)": k5, "intersect_scene (xla dense)": {},
        "intersect_scene (all-inactive)": k5, "_shading_point": {}, "sample_lights": {},
        "sample_lights_pdf_from_hit": {}, "bsdf sample+eval+pdf": {},
        "12x rng uniform draws": {}, "one full MIS bounce": k5})
    res["parts"] = {r["label"]: {k: r[k] for k in ("device_ms", "host_ms", "kernels")}
                    for r in parts}

    n = profile_stages.K
    stages = profile_stages.main([], device=DEVICE)
    check_tool_rows("profile_stages", stages, {
        "temporal (XLA, packed gather)": {}, "gather alone (12ch f32)": {},
        "moments 7x7 (XLA)": {}, "atrous step=1 (XLA)": {}, "taa (XLA)": {},
        "temporal (Pallas)": {"temporal": n}, "taa (Pallas)": {"taa": n},
        "moments 7x7 (Pallas)": {"moments": n},
        "atrous step=1 (Pallas)": {"atrous_iteration": n},
        "atrous step=16 (Pallas)": {"atrous_iteration": n},
        "atrous chain x5 (Pallas)": {"atrous": 5 * n}})

    n = profile_filter.K
    filt = profile_filter.main([], device=DEVICE)
    check_tool_rows("profile_filter", filt, {
        "temporal kernel (pre-packed)": {"temporal": n}, "moments kernel": {"moments": n},
        **{f"atrous chain steps={s}": {"atrous": s * n} for s in (1, 2, 5)},
        "taa kernel": {"taa": n},
        "filter_chain": {"temporal": n, "moments": n, "atrous": 5 * n, "taa": n}})
    res["filter"] = {r["label"]: {k: r[k] for k in ("device_ms", "host_ms", "svgf_ms")}
                     for r in filt}

    n = profile_moments.K
    mom = profile_moments.main([], device=DEVICE)
    check_tool_rows("profile_moments", mom,
                    {label: {"moments": n} for label in profile_moments.history_cases(8, 128)})
    res["moments"] = {r["label"]: {k: r[k] for k in ("device_ms", "svgf_ms")} for r in mom}

    launches = {k: v for k, v in LAUNCHES.items() if v}
    log(f"phase 17 launches: {launches}")
    assert all(launches.get(k) for k in ("temporal", "moments", "atrous", "taa",
                                         "intersect_dense", "atrous_iteration")), launches
    log("phase 17: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# the gradient-debugging tools (svgf_tpu_torch/scripts/grad_*) on the card
# ---------------------------------------------------------------------------

# a row that a tie explains: tests/test_torch_grad_tools.py's hit_uv bar
GRAD_TIE_RTOL = 2e-2
# the rows that its tests show a rounding decides at the tools' own sizes:
# hit_uv (four primary rays on a shared edge, test_hit_uv_tie_lanes) and the
# frame rows (a 1-ulp camera move changes their gradients by ~6e-4 of the
# largest on the CPU alone, test_frame_rows_follow_a_rounding)
GRAD_TIE_ROWS = ("hit_uv", "full frame 1", "full frame 2 (temporal)")
FD_AN_RTOL = 2e-3
FD_REL_BAR = 0.05
SHOWN_LANES = 20


def hold_grad_rows(label, got: list, want: list, k5_calls: dict, loose=()) -> dict:
    """The card's gradient rows (got) against `want`: names and finite
    flags equal; each cam_frame gradient within bar x (the largest finite
    |g| of want) + GRAD_ATOL, the bar GRAD_RTOL, or GRAD_TIE_RTOL for the
    rows in `loose`; each row's K5 launches k5_calls[name]. Logs each
    row's forward + backward ms and peak memory."""
    from svgf_tpu_torch.parallel.checks import GRAD_ATOL, GRAD_RTOL

    assert [r.name for r in got] == [r.name for r in want], (label, [r.name for r in got])
    out = {}
    for g, w in zip(got, want):
        ok = np.isfinite(w.grad)
        assert g.finite == w.finite and np.array_equal(np.isfinite(g.grad), ok), (label, g.name)
        scale = float(np.abs(w.grad[ok]).max()) if ok.any() else 0.0
        err = float(np.abs(g.grad - w.grad)[ok].max()) if ok.any() else 0.0
        bar = GRAD_TIE_RTOL if g.name in loose else GRAD_RTOL
        k5 = g.launches.get("intersect_dense", 0)
        log(f"  {label}, {g.name}: finite {g.finite}, |g|max {g.gmax:.6g} against {w.gmax:.6g}, "
            f"largest difference {err:.3e} ({err / max(scale, 1e-30):.2e} of the largest, bar "
            f"{bar}), {g.ms:.3f} ms forward + backward, peak {g.peak_mib:.1f} MiB, K5 {k5}")
        assert err <= bar * scale + GRAD_ATOL, (label, g.name, err, scale, bar)
        assert g.launches == ({"intersect_dense": k5_calls[g.name]} if k5_calls[g.name] else {}), (
            label, g.name, g.launches)
        out[g.name] = {"ms": g.ms, "peak_mib": g.peak_mib, "k5": k5, "gmax": g.gmax,
                       "rel_err": err / max(scale, 1e-30)}
    return out


def winner_lanes(label, got, want, t0, active=None) -> int:
    """compare_hits of two Hits on the same rays, and the lanes whose winner
    differs printed (the first SHOWN_LANES: index, both triangles and both
    t). Returns how many differ."""
    compare_hits(label, got, want, t0, active)
    sel = torch.ones_like(t0, dtype=torch.bool) if active is None else active
    hit, hit_got = want.dist < t0, got.dist < t0
    differ = sel & ((hit != hit_got) | (hit & (got.prim != want.prim)))
    lanes = torch.nonzero(differ).reshape(-1)
    for i in lanes[:SHOWN_LANES].tolist():
        log(f"    lane {i}: triangle {int(got.prim[i])} at t {float(got.dist[i]):.9g} against "
            f"{int(want.prim[i])} at t {float(want.dist[i]):.9g}")
    return lanes.numel()


@contextlib.contextmanager
def recording_k5(calls: list):
    """While the block runs, each call of K5's wrapper appends its rays and
    keywords to `calls`."""
    from svgf_tpu_torch.kernels import intersect as KI

    fn = KI.intersect_dense_kernel

    def record(scene, ro, rd, **kw):
        calls.append((ro.detach(), rd.detach(), kw))
        return fn(scene, ro, rd, **kw)

    KI.intersect_dense_kernel = record
    try:
        yield
    finally:
        KI.intersect_dense_kernel = fn


def grad_tools_own_sizes() -> dict:
    """(a) Each tool's main on the card at its own size against the same
    main on the CPU in this process. The primary winners of the card's K5
    and of the CPU's plain sweep are compared on each side's own rays (the
    lanes that differ printed); GRAD_TIE_ROWS take GRAD_TIE_RTOL."""
    from svgf_tpu_torch.kernels.launch import LAUNCHES
    from svgf_tpu_torch.ops.intersect import intersect_scene, start_dist
    from svgf_tpu_torch.render.gbuffer import camera_rays
    from svgf_tpu_torch.scripts import grad_bisect, grad_bisect2, grad_fd_explore

    res = {}
    for mod in (grad_bisect, grad_bisect2):
        name = mod.__name__.rsplit(".", 1)[-1]
        card, cpu = mod.main([], device=DEVICE), mod.main([], device="cpu")
        hits = []
        for dev, mode in ((DEVICE, "on"), ("cpu", "off")):
            a = grad_bisect.cornell_arrays(mod.H, mod.W, dev)
            with torch.no_grad():
                ro, rd = camera_rays(a.cam_frame[0], a.cam_proj[0], mod.H, mod.W)
                hits.append(intersect_scene(a, ro, rd, mode))
        cpu_hit = type(hits[1])(*(x.to(DEVICE) for x in hits[1]))
        ties = winner_lanes(f"{name} {mod.W}x{mod.H} primary rays, K5 on the card against the "
                            "CPU's plain sweep", hits[0], cpu_hit,
                            start_dist(None, mod.H * mod.W, DEVICE))
        res[name] = {"primary_lanes_differ": ties, "rows": hold_grad_rows(
            f"{name} {mod.W}x{mod.H}, card against CPU", card, cpu, mod.K5_CALLS,
            GRAD_TIE_ROWS)}

    before = LAUNCHES["intersect_dense"]
    card = grad_fd_explore.main([], device=DEVICE)
    k5 = LAUNCHES["intersect_dense"] - before
    cpu = grad_fd_explore.main([], device="cpu")
    h, w = grad_fd_explore.H, grad_fd_explore.W
    masks = [grad_fd_explore.interior_mask(grad_bisect.cornell_arrays(h, w, dev), h, w, mode).cpu()
             for dev, mode in ((DEVICE, "on"), ("cpu", "off"))]
    log(f"  grad_fd_explore {w}x{h}: interior pixels {int(masks[0].sum())} on the card, "
        f"{int(masks[1].sum())} on the CPU; K5 {k5}")
    assert torch.equal(masks[0], masks[1])
    assert k5 == 1 + grad_fd_explore.EVALUATIONS * sum(grad_fd_explore.K5_CALLS.values()), k5
    for g, c in zip(card, cpu):
        assert (g.name, g.comp, g.eps) == (c.name, c.comp, c.eps), (g, c)
        log(f"  grad_fd_explore {g.name} comp={g.comp} eps={g.eps:g}: fd {g.fd:+.6g} / "
            f"{c.fd:+.6g}, an {g.an:+.6g} / {c.an:+.6g}, rel {g.rel:.4f} / {c.rel:.4f} (card / CPU)")
        assert abs(g.an - c.an) <= FD_AN_RTOL * abs(c.an), (g, c)
        assert g.rel < FD_REL_BAR and c.rel < FD_REL_BAR, (g, c)
    res["grad_fd_explore"] = {"interior": int(masks[0].sum()), "k5": k5,
                              "rows": [g._asdict() for g in card]}
    return res


def grad_tools_1080p() -> dict:
    """(b) grad_bisect's K5 rows and grad_bisect2's 19 stages at 1920x1080
    through K5 against the same losses on the plain dense sweep on the
    card. The winners of the three intersects of the last stage (primary,
    shadow, BSDF sample) are compared on K5's rays (the lanes that differ
    printed). Rows before the first shadow intersect are held at
    GRAD_RTOL; a later row (and the trace rows, whose bounce makes the same
    shadow and BSDF-sample intersect) takes GRAD_TIE_RTOL only where those
    winners differ."""
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.ops.intersect import intersect_dense, start_dist
    from svgf_tpu_torch.scripts import grad_bisect, grad_bisect2

    arrays = grad_bisect.cornell_arrays(H, W, DEVICE)
    config = grad_bisect.grad_config(H, W)
    k5_rows = [n for n, c in grad_bisect.K5_CALLS.items() if c]

    def named(mode):
        losses = grad_bisect.losses(arrays, config, H, W, mode)
        out = {n: losses[n] for n in k5_rows}
        out.update({s: (lambda cf, s=s: grad_bisect2.stage(arrays, cf, s, H, W, mode))
                    for s in grad_bisect2.STAGES})
        return out

    calls = []
    with torch.no_grad(), recording_k5(calls):
        grad_bisect2.stage(arrays, arrays.cam_frame, grad_bisect2.STAGES[-1], H, W, "on")
    assert len(calls) == 3, len(calls)
    differ = {}
    for label, (ro, rd, kw) in zip(("primary", "shadow", "BSDF sample"), calls):
        active = kw.get("active")
        differ[label] = winner_lanes(
            f"grad_bisect2 {W}x{H} {label} rays, K5 against the plain sweep",
            KI.intersect_dense_kernel(arrays, ro, rd, active=active),
            intersect_dense(arrays, ro, rd, active=active), start_dist(None, ro.shape[0], DEVICE),
            active)
    later = grad_bisect2.STAGES[grad_bisect2.STAGES.index("lpdf_l"):]
    loose = (*later, "trace (no hybrid)", "trace (hybrid primary)") if (
        differ["shadow"] or differ["BSDF sample"]) else ()
    log(f"  {W}x{H}: winners that differ {differ}; rows held at {GRAD_TIE_RTOL}: {list(loose)}")
    on = grad_bisect.bisect(named("on"), arrays.cam_frame)
    off = grad_bisect.bisect(named("off"), arrays.cam_frame)
    plain = {}
    for r in off:
        log(f"  {W}x{H} plain sweep, {r.name}: {r.ms:.3f} ms forward + backward, peak "
            f"{r.peak_mib:.1f} MiB")
        assert r.launches == {}, (r.name, r.launches)
        plain[r.name] = {"ms": r.ms, "peak_mib": r.peak_mib}
    k5_calls = {**grad_bisect.K5_CALLS, **grad_bisect2.K5_CALLS}
    return {"winners_differ": differ, "plain": plain,
            "K5": hold_grad_rows(f"{W}x{H}, K5 against the plain sweep", on, off, k5_calls, loose)}


def check_gradient_tools(smi: str) -> dict:
    """Phase 18: the gradient-debugging tools, (a) at their own sizes
    against their CPU runs and (b) at 1080p through K5 against the plain
    sweep, the launch counts set to 0 just before and read just after."""
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches

    log(f"phase 18 on {smi}")
    reset_launches()
    res = {"own sizes": grad_tools_own_sizes(), "1080p": grad_tools_1080p()}
    launches = {k: v for k, v in LAUNCHES.items() if v}
    log(f"phase 18 launches: {launches}")
    assert set(launches) == {"intersect_dense"}, launches
    log("phase 18: " + json.dumps(res))
    return res


def compare_times() -> dict:
    """The times the redesigns of K2/K8, K6 and K4/K10 should move, measured
    on the tree of the port that is imported, with only the wrappers'
    public calls, so that the same function times an earlier tree too (run
    it from each checkout in turn, in one chip call): K2 on frame_inputs'
    scattered and banded fallback pixels, K8 on the 1080-row and the
    [0, 270) band, K4 at 1080p with fp16 and fp32 history, K10 on the
    four 270-row bands and the 1080-row band, K6 on the primary and the
    scrambled rays (wrapper by events, kernel alone by the profiler), the
    profiled terrain, Cornell and materials frames' device time and
    kernels (on a tree that has the materials scene), and the Cornell
    frame's moments stage. Prints them as one JSON line "compare: {...}"."""
    import svgf_tpu_torch
    from svgf_tpu_torch.config import SVGFConfig
    from svgf_tpu_torch.kernels import filter as K
    from svgf_tpu_torch.scenes.cornell import cornell_box
    from svgf_tpu_torch.scenes.stress import stress_scene

    smi = check_card()
    build_kernels()
    log(f"compare_times on {svgf_tpu_torch.__file__}")
    sv = SVGFConfig(spatial_filter_steps=5)
    res = {}

    radiance, gbuf, state = frame_inputs()
    tp = K.temporal_filter(radiance, state.color, gbuf, state.gbuffer, state.moments,
                           state.history_len, sv.depth_threshold, sv.normal_threshold,
                           sv.history_length)
    for name, m_args in moments_cases(tp, gbuf).items():
        res[f"K2 {name}"] = time_call(lambda: K.filter_moments(*m_args))
    m_full = K.filter_moments(*moments_cases(tp, gbuf)["scattered"])
    a_full = K.wavelet_filter(m_full, gbuf, 5, sv.phi_colour, sv.phi_normal)[0]
    for r0, r1 in ((0, H), (0, H // NBANDS)):
        calls = band_calls(radiance, gbuf, state, tp, m_full, a_full, r0, r1)
        res[f"K8 [{r0}, {r1})"] = time_call(calls["moments_band"][0])
    for label in ("fp16", "fp32"):
        hist = state.taa_history.to(STATE_TYPES[label])
        res[f"K4 {label}"] = time_call(lambda: K.taa(a_full, hist))
    for r0, r1 in [(b * H // NBANDS, (b + 1) * H // NBANDS) for b in range(NBANDS)] + [(0, H)]:
        res[f"K10 [{r0}, {r1})"] = time_call(taa_band_call(a_full, state.taa_history, r0, r1)[0])

    stress = stress_scene(n=STRESS_N, aspect=W / H)
    arrays = stress_arrays(stress)
    for name, fn in clustered_calls(arrays, stress_rays(arrays)[0]).items():
        res[f"K6 {name}"] = time_call(fn)
    frames = [("terrain", stress, stress_orbit),
              ("Cornell", cornell_box(aspect=W / H), cornell_orbit)]
    try:
        from svgf_tpu_torch.scenes.materials import cornell_materials
    except ModuleNotFoundError:
        log("compare_times: this tree of the port has no materials scene")
    else:
        frames.append(("materials", cornell_materials(aspect=W / H), cornell_orbit))
    for name, scene, orbit in frames:
        res[f"{name} frame"] = timed_frames(name, scene, orbit)[3]
    log(smi)
    log("compare: " + json.dumps(res))
    return res


def moments_design_cases(stress) -> dict:
    """K2's inputs for check_moments_designs: the test frame's scattered
    and banded cases, Cornell frames 2, 3, 4 (the main path's timed
    frames) and LATER_FRAME, and terrain frames 4 and LATER_FRAME."""
    from svgf_tpu_torch.config import SVGFConfig
    from svgf_tpu_torch.kernels import filter as K
    from svgf_tpu_torch.scenes.cornell import cornell_box

    sv = SVGFConfig(spatial_filter_steps=5)
    radiance, gbuf, state = frame_inputs()
    tp = K.temporal_filter(radiance, state.color, gbuf, state.gbuffer, state.moments,
                           state.history_len, sv.depth_threshold, sv.normal_threshold,
                           sv.history_length)
    cases = {f"test frame, {name}": (args, {}) for name, args in moments_cases(tp, gbuf).items()}
    cases.update(frame_moments_inputs("Cornell", cornell_box(aspect=W / H), cornell_orbit,
                                      (2, 3, 4, LATER_FRAME)))
    cases.update(frame_moments_inputs("terrain", stress, stress_orbit, (4, LATER_FRAME)))
    return cases


def phase(name: str, fn, *args):
    """fn(*args), with its seconds of command time logged."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    t_start = time.perf_counter()
    smi = check_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("build", build_kernels)
    host_build_s = phase("host library build", build_host_library)
    timed = phase("filter kernels", check_filter_kernels)
    timed.update(phase("band kernels", check_band_kernels))
    timed["intersect_dense"] = phase("K5", check_dense_kernel)

    from svgf_tpu_torch.scenes.stress import stress_scene

    stress = stress_scene(n=STRESS_N, aspect=W / H)
    t0 = time.perf_counter()
    arrays = phase("terrain flatten", stress_arrays, stress)
    numpy_flatten_s = time.perf_counter() - t0
    timed["intersect_clustered"] = phase("K6", check_clustered_kernel, arrays, *stress_rays(arrays))
    launches, matte = phase("main path", check_main_path)
    phase("main path, bf16 state", check_bf16_path)
    phase("quick start", check_quick_start, smi)
    # K9a is K3's chain (one function in the port's one layout): its row is K3's call
    timed["atrous_chain"], launches["atrous_chain"] = timed["atrous"], launches["atrous"]
    sharded_launches = phase("sharded route", check_sharded_route)
    for name in ("temporal_band", "moments_band", "atrous_iteration", "taa_band"):
        launches[name] = sharded_launches[name]
    stress_launches = phase("stress path", check_stress_path, stress)
    launches["intersect_clustered"] = stress_launches["intersect_clustered"]
    nested = phase("nested scene", check_nested_scene)
    timed["intersect_clustered"].update(nested_bound_ms=nested["bound"]["bound_ms"],
                                        nested_bound_by=nested["bound"]["bound_by"],
                                        nested_alone_ms=nested["primary"]["alone_ms"])
    phase("materials", check_materials_path, stress, arrays, matte)
    phase("K2 designs", lambda: check_moments_designs(moments_design_cases(stress)))
    train_launches = phase("gradients and train steps", check_gradients, arrays)
    phase("native builder, per-shape walk and orbit", check_native_and_orbit, stress, arrays,
          numpy_flatten_s, host_build_s)
    phase("measuring tools", check_measuring_tools, smi)
    phase("gradient tools", check_gradient_tools, smi)
    # last: it moves the terrain's light
    phase("scene I/O and edits", check_scene_io_and_edits, stress, arrays)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K6 also carries the yardstick bound that its earlier design was read
    # against, and its bound and time alone on the nested scene's primary rays
    extra = ("yardstick_bound_ms", "yardstick_bound_by", "nested_bound_ms", "nested_bound_by",
             "nested_alone_ms")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **{k: timed[name][k] for k in keys},
         **{k: timed[name][k] for k in extra if k in timed[name]},
         **({"train_step_launches": train_launches[name]} if name in train_launches else {})}
        for name, src, rep in KERNELS
    ]
    assert all(k["launches"] > 0 for k in kernels), kernels
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
