"""The "denoise" kind: SVGF behind an engine's own raster and trace. Each
step runs the four SVGF stages through filter_chain on one steady-state
frame made from the seed (the traffic's `frame`: its motion, history band
and history cap), from the same prior state.

The check runs the plain chain on the frame, made again from the seed with
the prior state at the configuration's type, and compares every output of
filter_chain:
  mean_abs_err  the worst over the float outputs of the mean |diff|
  bad_px        share of pixels where a float output is off by > 1e-3
  int_diff_px   share of pixels where history or the reprojection differs
(no widest gap: at the frame's near-zero variances the a-trous luminance
weight turns one-ulp differences of a step into up to 1e-2 after five)."""

from __future__ import annotations

import math

import torch

from portbench import drive, port
from portbench.reference import svgf as RSV
from portbench.reference.trace import GBuffer

BAD = 1e-3


class Session:
    STAGE_SPANS = {"filter_ms": ("start", "taa")}

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, overrides=None,
                 state_dtype=None):
        self.traffic, self.seed, self.device = traffic, seed, device
        self.render = drive.settings(cfg, seed, overrides)
        program = {**self.render, **({"state_dtype": state_dtype} if state_dtype else {})}
        self.config = port.render_config(program, device)
        f = frame(traffic["frame"], program, seed, device)
        self.inputs = (f["radiance"], port.gbuffer(f["gbuffer"]),
                       port.temporal_state({**f["prev"], "gbuffer": port.gbuffer(f["prev"]["gbuffer"])}))
        self.k = 0
        self.out = None

    def step(self, events=None, spans=None):
        with torch.profiler.record_function("portbench.filter_chain"):
            if events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events["start"] = ev
            self.out = port.filter_chain(*self.inputs, self.config, events)
        self.k += 1
        return self.out

    def warm_up(self):
        for _ in range(self.traffic["warmup_steps"]):
            self.step()
        drive.sync(self.device)

    def counters(self) -> dict:
        return {}

    def shapes(self) -> dict:
        tres = self.out[0]
        valid = self.inputs[1].depth != 0
        return {"height": self.render["height"], "width": self.render["width"],
                "state_bytes": self.inputs[2].color.element_size(),
                "atrous_steps": self.render["svgf"]["spatial_filter_steps"],
                "valid_px": int(valid.sum()),
                "fallback_px": int(((tres.history_len < 4) & valid).sum())}

    def end_of_window(self) -> dict:
        tres, moments_out, atrous_out, final, feedback = self.out
        last = {"color": tres.color, "moments": tres.moments, "history_len": tres.history_len,
                "reprojected": tres.reprojected, "moments_out": moments_out,
                "atrous_out": atrous_out, "final": final, "feedback": feedback}
        self.out = self.inputs = None
        return {"k": self.k - 1, "outputs": drive.to_host(last)}

    def check(self, last: dict, device) -> dict:
        return compare(last["outputs"], reference(self.traffic["frame"], self.render, self.seed, device))


def frame(spec: dict, render: dict, seed: int, device) -> dict:
    """The steady-state frame of an orbit, made on `device` from the seed:
    smooth depth in horizontal instance bands with depth steps, smooth
    normals, a pan's motion (horizontal within +-`motion_x` px with parallax,
    vertical within +-`motion_y`), the previous G-buffer equal to the
    current one, history at `history_cap` except a disoccluded band of
    columns at 1-3, and uniform radiance and prior colour, moments and TAA
    history. Returns plain tensors: radiance, gbuffer, prev (the prior
    state at `render`'s state type)."""
    h, w = render["height"], render["width"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(torch.arange(h, **f32), torch.arange(w, **f32), indexing="ij")
    u, v = xx / w, yy / h
    inst = torch.floor(6 * v).remainder(4).to(torch.int32)
    depth = 2.0 + 1.5 * torch.sin(3 * u * math.pi) * torch.cos(2 * v * math.pi) + v + 0.7 * inst
    deriv = torch.abs(torch.gradient(depth, dim=1)[0]) + 1e-4
    theta = 0.7 * u + 0.2 * v
    nrm = torch.stack([torch.sin(theta), torch.cos(theta), 0.5 + 0.3 * torch.sin(5 * v)], -1)
    nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
    mx = torch.trunc(spec["motion_x"] / depth * (0.8 + 0.4 * u))
    my = torch.trunc(spec["motion_y"] * (v - 0.5))
    zeros = lambda *c: torch.zeros((h, w) + c, **f32)
    m1 = torch.full((h, w), -1, dtype=torch.int32, device=device)
    gbuf = dict(position=zeros(3), normal=nrm, motion=torch.stack([mx, my], -1), depth=depth,
                depth_deriv=deriv, uv=zeros(2), instance=inst, prim=m1, material=m1)
    hist = torch.full((h, w), spec["history_cap"], dtype=torch.int32, device=device)
    c0, c1 = int(spec["band"][0] * w), int(spec["band"][1] * w)
    hist[:, c0:c1] = torch.randint(1, 4, (h, c1 - c0), generator=g, dtype=torch.int32, device=device)
    uni = lambda hi, *c: torch.rand((h, w) + c, generator=g, **f32) * hi
    radiance = uni(1.0, 3)
    sd = port.STATE_DTYPES[render["state_dtype"]]
    prev = dict(color=uni(1.0, 4).to(sd), moments=uni(0.5, 2).to(sd), history_len=hist,
                taa_history=uni(1.0, 4).to(sd), frame_idx=0,
                gbuffer={k: (x.to(sd) if x.is_floating_point() else x) for k, x in gbuf.items()})
    return {"radiance": radiance, "gbuffer": gbuf, "prev": prev}


def reference(spec, render, seed, device) -> dict:
    """The plain chain on the session's frame, made again from the seed."""
    f = frame(spec, render, seed, device)
    prev = {**f["prev"], "gbuffer": GBuffer(**f["prev"]["gbuffer"])}
    t, m, a, final, feedback = RSV.chain(f["radiance"], GBuffer(**f["gbuffer"]), prev, render["svgf"])
    return {"color": t.color, "moments": t.moments, "history_len": t.history_len,
            "reprojected": t.reprojected, "moments_out": m, "atrous_out": a, "final": final,
            "feedback": feedback}


def compare(outputs: dict, ref: dict) -> dict:
    err, off, bad = 0.0, None, None
    for k, x in outputs.items():
        y = ref[k]
        x = x.to(y.device)
        if x.is_floating_point():
            d = (x.float() - y.float()).abs()
            err = max(err, float(d.mean()))
            d = d.amax(-1) > BAD if d.dim() == 3 else d > BAD
            off = d if off is None else off | d
        else:
            d = x != y
            bad = d if bad is None else bad | d
    return {"mean_abs_err": err, "bad_px": float(off.float().mean()),
            "int_diff_px": float(bad.float().mean())}
