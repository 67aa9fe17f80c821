"""Live-lane imbalance across row-shard bands, bounce by bounce: the port's
copy of svgf_tpu's scripts/measure_balance.py, the evidence for whether the
row-sharded trace needs an all-to-all reshard of its lanes.

Traces the Cornell box once at 1 spp and 5 bounces, recording each
bounce's active mask after Russian roulette through pathtrace's probe
(`set_active_probe`). The mask is cut into the row bands an N-way row
mesh would own, and into the round-robin row interleave of the balanced
sharded trace; each bounce reports the live fraction of each band and the
imbalance (max - mean) / mean of both cuts. A reshard pays one
wavefront-state exchange a bounce, so it is worth it only where the
imbalance passes ~15% while many lanes are still live. (svgf_tpu's script
tries the reference project's BaseScene first; that scene is not in the
repository, so the port traces the box it falls back to.)

Runs on the card through K5 (the kernel policy "on"); main(device="cpu")
traces with the plain intersector.

Usage: python -m svgf_tpu_torch.scripts.measure_balance [bands] [h] [w]
Prints one JSON line (the progress goes to stderr); main also returns it
as a dict.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

BOUNCES = 5
SCENE = "cornell"


def scene_arrays(h: int, w: int, device):
    """The Cornell box's arrays on `device`, its camera at the aspect w / h."""
    from svgf_tpu_torch.scenes import cornell_box

    scene = cornell_box()
    scene.cameras[0].aspect = w / h
    return scene.flatten(device=device)


def active_masks(arrays, h: int, w: int, bounces: int, intersect_mode: str):
    """Each bounce's active mask, a (bounces, h, w) bool array, of one
    pathtrace of the camera's rays under key 0."""
    from svgf_tpu_torch.ops.keys import key
    from svgf_tpu_torch.render import pathtrace as pt
    from svgf_tpu_torch.render.gbuffer import camera_rays

    ro, rd = camera_rays(arrays.cam_frame[0], arrays.cam_proj[0], h, w)
    lane_ids = torch.arange(h * w, dtype=torch.int64, device=ro.device)
    acc: list = []
    pt.set_active_probe(acc)
    try:
        pt.pathtrace(arrays, ro, rd, key(0), lane_ids, bounces=bounces,
                     intersect_mode=intersect_mode)
    finally:
        pt.set_active_probe(None)
    return torch.stack(acc).cpu().numpy().reshape(bounces, h, w)


def balance(masks, bands: int) -> list:
    """svgf_tpu's per-bounce records of the (bounces, h, w) masks."""
    h = masks.shape[1]
    rows_per = h // bands
    per_bounce = []
    for b in range(masks.shape[0]):
        frac = [float(masks[b, k * rows_per:(k + 1) * rows_per].mean()) for k in range(bands)]
        # the same lanes under the round-robin row interleave of the balanced
        # sharded trace: band k holds the rows congruent to k (mod bands)
        frac_i = [float(masks[b, k::bands].mean()) for k in range(bands)]
        mean = float(np.mean(frac))
        imb = 0.0 if mean == 0 else (max(frac) - mean) / mean
        imb_i = 0.0 if mean == 0 else (max(frac_i) - mean) / mean
        per_bounce.append({"bounce": b, "live_frac_mean": round(mean, 4),
                           "live_frac_per_band": [round(f, 4) for f in frac],
                           "imbalance": round(imb, 4),
                           "imbalance_interleaved": round(imb_i, 4)})
        print(f"bounce {b}: live {mean * 100:5.1f}% imbalance banded {imb * 100:5.1f}% -> "
              f"interleaved {imb_i * 100:5.1f}%", file=sys.stderr)
    return per_bounce


def main(argv=None, device="cuda") -> dict:
    from svgf_tpu_torch.scripts.timing import kernel_mode

    argv = sys.argv[1:] if argv is None else argv
    bands = int(argv[0]) if len(argv) > 0 else 8
    h = int(argv[1]) if len(argv) > 1 else 360
    w = int(argv[2]) if len(argv) > 2 else 640
    masks = active_masks(scene_arrays(h, w, device), h, w, BOUNCES, kernel_mode(device))
    per_bounce = balance(masks, bands)
    out = {"metric": "row_shard_live_lane_imbalance", "scene": SCENE, "bands": bands,
           "h": h, "w": w, "per_bounce": per_bounce,
           "worst_imbalance": round(max(p["imbalance"] for p in per_bounce), 4),
           "worst_imbalance_interleaved": round(max(p["imbalance_interleaved"]
                                                    for p in per_bounce), 4)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
