"""One frame of the reference renderer and its carried state.

A state is a dict of color, moments, history_len, taa_history, gbuffer (a
trace.GBuffer) and frame_idx, its floating fields stored at the state type
the caller names (the configuration's, or a lower one for the control)."""

from __future__ import annotations

import torch

from portbench.reference import rng as R
from portbench.reference import svgf
from portbench.reference.trace import GBuffer, camera_rays, first_hit, gbuffer, pathtrace


def initial_state(h: int, w: int, dtype, device) -> dict:
    f = lambda *c: torch.zeros((h, w) + c, dtype=dtype, device=device)
    i = lambda: torch.full((h, w), -1, dtype=torch.int32, device=device)
    return dict(color=f(4), moments=f(2), history_len=torch.zeros((h, w), dtype=torch.int32, device=device),
                taa_history=f(4), frame_idx=0,
                gbuffer=GBuffer(position=f(3), normal=f(3), motion=f(2), depth=f(), depth_deriv=f(),
                                uv=f(2), instance=i(), prim=i(), material=i()))


def _store(x, dtype):
    return x.to(dtype) if x.is_floating_point() else x


@torch.no_grad()
def render(rs, state: dict, frame, prev_frame, cfg: dict, dtype) -> tuple:
    """(final image (H, W, 3), the new state, rays handed to the
    intersector). `frame`, `prev_frame`: the camera's 4x4 frames now and one
    step ago; `cfg` the configuration's render settings; `dtype` the
    state's storage type."""
    h, w = cfg["height"], cfg["width"]
    dev = rs.tri_pos.device
    frame = torch.as_tensor(frame, dtype=torch.float32, device=dev)
    prev_frame = torch.as_tensor(prev_frame, dtype=torch.float32, device=dev)
    g = gbuffer(rs, frame, prev_frame, h, w)
    skey = R.fold_in(R.fold_in(R.key(cfg["seed"]), state["frame_idx"]), 0)
    pixels = torch.arange(h * w, dtype=torch.int64, device=dev)
    jitter = R.Stream(R.fold_in(skey, 987), pixels).uniform2().reshape(h, w, 2) * 2.0 - 1.0
    ro, rd = camera_rays(frame, rs.proj, h, w, jitter=jitter)
    sample, nrays = pathtrace(rs, ro, rd, skey, pixels, first_hit(g), cfg["bounces"], cfg["clamp"])
    radiance = (torch.zeros((h * w, 3), device=dev) + sample / 1).reshape(h, w, 3)
    t, _, _, final, feedback = svgf.chain(radiance, g, state, cfg["svgf"])
    new = dict(color=_store(feedback, dtype), moments=_store(t.moments, dtype),
               history_len=t.history_len, taa_history=_store(final, dtype),
               gbuffer=GBuffer(*(_store(x, dtype) for x in g)), frame_idx=state["frame_idx"] + 1)
    return final[..., :3], new, int(nrays) + h * w
