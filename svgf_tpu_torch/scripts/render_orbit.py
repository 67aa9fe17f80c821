"""Offline orbit renderer, the port's copy of svgf_tpu's scripts/render_orbit.py
(the replacement for the reference's interactive loop, App.cu:692-734, and
its orbit camera, CameraController.cpp).

Renders N frames orbiting the scene, writes a PNG of the selected debug tap
for each (frame_NNNN.png, numbered from the state's frame index), then the
temporal state as ckpt.npz, from which --resume continues the sequence.
The flags and defaults are svgf_tpu's, with --device added: the card
unless it says cpu.

Usage:
  python -m svgf_tpu_torch.scripts.render_orbit --scene cornell --frames 24 --out out/orbit
  python -m svgf_tpu_torch.scripts.render_orbit --device cpu --width 64 --height 36 \\
      --frames 3 --out out/orbit_cpu
  python -m svgf_tpu_torch.scripts.render_orbit --frames 8 --out out/orbit --resume out/orbit/ckpt.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np


@dataclasses.dataclass
class OrbitRun:
    """What main() rendered: the Renderer (its state after the last frame),
    the last frame's tap as an (H, W, 3) array (None without frames), each
    frame's host milliseconds (step and the copy of its image) and the
    PNGs written."""

    renderer: object
    last_image: np.ndarray | None
    frame_ms: list
    pngs: list


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--orbit-degrees", type=float, default=45.0)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "orbit"))
    ap.add_argument("--tap", default="FINAL")
    ap.add_argument("--resume", default=None, help="checkpoint to resume from")
    ap.add_argument("--config", default=None, help="RenderConfig JSON file")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return ap.parse_args(argv)


def render_config(args):
    from svgf_tpu_torch.config import DebugOutput, RenderConfig, SVGFConfig, TracingConfig

    if args.config:
        with open(args.config) as f:
            return RenderConfig.from_json(f.read())
    return RenderConfig(
        width=args.width, height=args.height,
        tracing=TracingConfig(bounces=args.bounces),
        svgf=SVGFConfig(spatial_filter_steps=args.steps),
        debug_output=DebugOutput[args.tap],
        # production-loop settings: chunked wavefront, and no per-stage
        # taps kept unless a tap was asked for
        trace_chunks=48 if args.width * args.height >= 512 * 512 else 4,
        keep_taps=DebugOutput[args.tap] != DebugOutput.FINAL,
    )


def orbit_scene(name: str, aspect: float):
    """(scene, orbit target, orbit distance) of a --scene value."""
    if name == "cornell":
        from svgf_tpu_torch.scenes.cornell import cornell_box

        return cornell_box(aspect=aspect), np.array([0.0, 0.0, 0.0]), 3.4
    if name == "default":
        from svgf_tpu_torch.scenes.default_scene import default_scene

        return default_scene(aspect=aspect), np.array([0.0, 0.0, 0.0]), 4.0
    from svgf_tpu_torch.io import load_reference_scene

    scene = load_reference_scene(name)
    # orbit around the origin at the scene camera's distance
    eye = scene.cameras[0].frame[:3, 3]
    return scene, np.zeros(3), float(np.linalg.norm(eye))


def orbit_pose(f: int, args, target, distance) -> np.ndarray:
    """The camera frame of frame f: --orbit-degrees spread over --frames
    frames, at 0.15 rad elevation (svgf_tpu's orbit, also on a resume)."""
    from svgf_tpu_torch.core.camera import orbit_frame

    theta = np.radians(args.orbit_degrees) * f / max(args.frames, 1)
    return orbit_frame(target, distance, theta=theta, phi=0.15)


def main(argv=None) -> OrbitRun:
    args = parse_args(argv)

    from svgf_tpu_torch.io import load_checkpoint, save_checkpoint
    from svgf_tpu_torch.render.pipeline import STATE_DTYPES, Renderer
    from svgf_tpu_torch.utils.image import write_png

    cfg = render_config(args)
    scene, target, distance = orbit_scene(args.scene, cfg.width / cfg.height)
    os.makedirs(args.out, exist_ok=True)
    r = Renderer(scene, cfg, device=args.device)
    if args.resume and os.path.exists(args.resume):
        r.state = load_checkpoint(args.resume, dtype=STATE_DTYPES[cfg.state_dtype],
                                  device=r.device)
        print(f"resumed from {args.resume} at frame {r.state.frame_idx}", flush=True)

    start = int(r.state.frame_idx)
    img, frame_ms, pngs = None, [], []
    for k in range(args.frames):
        f = start + k
        r.update_camera(orbit_pose(f, args, target, distance))
        t0 = time.perf_counter()
        out = r.step()
        img = out.image.cpu().numpy()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        pngs.append(os.path.join(args.out, f"frame_{f:04d}.png"))
        write_png(pngs[-1], img)
        print(f"frame {f}: {frame_ms[-1]:.1f} ms  mean={img.mean():.4f}", flush=True)

    ckpt = os.path.join(args.out, "ckpt.npz")
    save_checkpoint(ckpt, r.state)
    print(f"checkpoint saved; resume with --resume {ckpt}")
    return OrbitRun(renderer=r, last_image=img, frame_ms=frame_ms, pngs=pngs)


if __name__ == "__main__":
    main()
