"""The "render" kind: one viewer in a closed loop over the configuration's
scene. Each step moves the camera along the traffic's `camera` (a "sweep"
of `step_rad` a step over +-`arc_rad` around the scene's own camera, or
"still"), applies the gizmo edit of `edit` if any (an instance moved along
an axis by amplitude * sin(2 pi k / period)), then renders one frame
through Renderer.step. The seed picks where in its cycle the camera or the
edit starts, so every seed sees the same set of views in another order.

The check compares three frames with the plain reference: frames 0 and 1,
which the reference renders from its own initial state (nothing of the
program's), so that frame 1's image rests on the state that frame 0
stored, and the window's last step, which it renders from the program's
state before that step (it cannot follow hundreds of steps in the time of
a run). Numbers, each the worst of the three frames:
  final_mean_err  mean |image - reference| over pixels and channels
  final_bad_px    share of pixels whose worst channel is off by > 0.05
  state_mean_err  the worst of the carried state's float fields' mean |diff|
  state_int_px    share of pixels where an integer field of the state
                  (history, instance, triangle, material) differs
  frame_idx_err   |frame index - reference's|"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import drive, port, scenes
from portbench.reference import frame as RF
from portbench.reference import scene as RS
from portbench.reference.scene import look_at
from portbench.reference.trace import GBuffer

BAD = 0.05
START_FRAMES = 2   # frames the reference follows from its own initial state


class CameraPath:
    def __init__(self, spec: dict, cam: dict, seed: int):
        self.still = spec["path"] == "still"
        eye, target = np.asarray(cam["eye"], np.float64), np.asarray(cam["target"], np.float64)
        d = eye - target
        self.target, self.dist = target, float(np.linalg.norm(d))
        self.el = math.asin(d[1] / self.dist)
        self.az = math.atan2(d[0], d[2])
        self.eye = eye
        if not self.still:
            self.step, self.arc = spec["step_rad"], spec["arc_rad"]
            self.leg = int(round(2 * self.arc / self.step))
            self.phase = seed % (2 * self.leg)

    def frame(self, k: int) -> np.ndarray:
        """The camera's frame at step k (k = -1: before the first step)."""
        if self.still:
            return look_at(self.eye, self.target)
        s = (self.phase + k) % (2 * self.leg)
        off = -self.arc + self.step * s if s < self.leg else self.arc - self.step * (s - self.leg)
        th, ph = self.az + off, self.el
        eye = self.target + self.dist * np.array(
            [math.cos(ph) * math.sin(th), math.sin(ph), math.cos(ph) * math.cos(th)])
        return look_at(eye, self.target)


class EditPath:
    def __init__(self, spec: dict | None, desc: dict, seed: int):
        self.spec = spec
        if spec is not None:
            names = [i["name"] for i in desc["instances"]]
            self.index = names.index(spec["instance"])
            self.base = np.asarray(desc["instances"][self.index]["transform"], np.float32)
            self.phase = seed % spec["period_steps"]

    def transform(self, k: int):
        """(instance index, its 4x4 transform at step k) or None."""
        if self.spec is None:
            return None
        t = self.base.copy()
        t[self.spec["axis"], 3] += np.float32(
            self.spec["amplitude"] * math.sin(2 * math.pi * (k + self.phase) / self.spec["period_steps"]))
        return self.index, t


class Session:
    """The viewer: a Renderer over the configuration's scene, driven step
    by step. It keeps what the check needs: the program's first frames from
    its initial state (on the host), and the state before the newest step."""

    # the program's stage spans: name -> (event at its start, event at its end)
    STAGE_SPANS = {"gbuffer_ms": ("start", "gbuffer"), "trace_ms": ("gbuffer", "trace"),
                   "filter_ms": ("trace", "taa")}

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, overrides=None,
                 state_dtype=None):
        self.traffic, self.device = traffic, device
        self.render = drive.settings(cfg, seed, overrides)
        self.desc = scenes.make(cfg["scene"])
        self.camera = CameraPath(traffic["camera"], self.desc["camera"], seed)
        self.edit = EditPath(traffic.get("edit"), self.desc, seed)
        program = {**self.render, **({"state_dtype": state_dtype} if state_dtype else {})}
        self.r = port.renderer(port.scene(self.desc, self.camera.frame(-1)),
                               port.render_config(program, device), device)
        self.k = 0
        self.start = []          # frames 0 and 1: (final, state) on the host
        self.prev_state = None   # the state before the newest step
        self.out = None          # the newest step's outputs

    def step(self, events=None, spans=None):
        """Step k: move the camera, apply the edit, render. `spans`, when
        given, receives the edit's host milliseconds (ending in a sync)."""
        k = self.k
        if not self.camera.still:
            self.r.update_camera(self.camera.frame(k))
        edit = self.edit.transform(k)
        if edit is not None:
            with torch.profiler.record_function("portbench.edit"):
                t0 = time.perf_counter()
                self.r.update_instance_transform(*edit)
                if spans is not None:
                    drive.sync(self.device)
                    spans.setdefault("edit_ms", []).append((time.perf_counter() - t0) * 1e3)
        self.prev_state = self.r.state
        with torch.profiler.record_function("portbench.step"):
            self.out = self.r.step(events=events)
        self.k += 1
        return self.out

    def warm_up(self):
        """The traffic's warm-up steps; keeps frames 0 and 1 for the check."""
        for _ in range(self.traffic["warmup_steps"]):
            out = self.step()
            drive.sync(self.device)
            if self.k <= START_FRAMES:
                self.start.append((out.final.cpu(), drive.to_host(port.as_fields(self.r.state))))

    def counters(self) -> dict:
        return {"rays_traced": int(self.out.metrics.rays_traced)}

    def shapes(self) -> dict:
        st = self.r.state
        valid = st.gbuffer.depth != 0
        return {"height": self.render["height"], "width": self.render["width"],
                "state_bytes": st.color.element_size(),
                "atrous_steps": self.render["svgf"]["spatial_filter_steps"],
                "valid_px": int(valid.sum()),
                "fallback_px": int(((st.history_len < 4) & valid).sum()),
                "bounces": self.render["bounces"],
                "n_tris": int(self.r.arrays.meta.n_world_tris)}

    def end_of_window(self) -> dict:
        last = dict(k=self.k - 1, final=self.out.final.cpu(),
                    prev=drive.to_host(port.as_fields(self.prev_state)),
                    state=drive.to_host(port.as_fields(self.r.state)))
        self.r = self.out = self.prev_state = None
        return last

    def cameras(self, k: int):
        return self.camera.frame(k), self.camera.frame(k - 1)

    def transforms(self, k: int) -> dict:
        e = self.edit.transform(k)
        return {} if e is None else {e[0]: e[1]}

    def check(self, last: dict, device) -> dict:
        """Frames 0 and 1 from the reference's own start, and the window's
        last step from the program's state before it."""
        refs = render_frames(self, [(k, None) for k in range(len(self.start))], device)
        rows = [compare_frame(*got, rf, rst) for got, (_, rf, rst) in zip(self.start, refs)]
        (_, rf, rst), = render_frames(self, [(last["k"], ref_state(last["prev"], device))], device)
        rows.append(compare_frame(last["final"], last["state"], rf, rst))
        return {k: max(r[k] for r in rows) for k in rows[0]}


def ref_state(fields: dict, device) -> dict:
    """A program state's plain fields (port.as_fields) as a reference state."""
    dev = lambda x: x.to(device)
    return dict(color=dev(fields["color"]), moments=dev(fields["moments"]),
                history_len=dev(fields["history_len"]), taa_history=dev(fields["taa_history"]),
                gbuffer=GBuffer(**{k: dev(v) for k, v in fields["gbuffer"].items()}),
                frame_idx=fields["frame_idx"])


def _flat(state: dict) -> dict:
    out = {k: state[k] for k in ("color", "moments", "history_len", "taa_history")}
    g = state["gbuffer"]
    out.update({f"gbuffer.{k}": v for k, v in (g._asdict() if hasattr(g, "_asdict") else g).items()})
    return out


def compare_frame(final, state: dict, ref_final, ref_st: dict) -> dict:
    """The numbers of one frame (program against reference)."""
    dev = ref_final.device
    diff = (final.to(dev).float() - ref_final.float()).abs()
    a, b = _flat(state), _flat(ref_st)
    means, int_bad = [], None
    for k, x in a.items():
        x, y = x.to(dev), b[k].to(dev)
        if x.is_floating_point():
            means.append(float((x.float() - y.float()).abs().mean()))
        else:
            d = x != y
            int_bad = d if int_bad is None else int_bad | d
    return {"final_mean_err": float(diff.mean()),
            "final_bad_px": float((diff.amax(-1) > BAD).float().mean()),
            "state_mean_err": max(means),
            "state_int_px": float(int_bad.float().mean()),
            "frame_idx_err": float(abs(state["frame_idx"] - ref_st["frame_idx"]))}


def render_frames(sess, frames, device) -> list:
    """The reference's frames of a render session at the configuration's
    state type: `frames` lists (k, state or None), None for the reference's
    own state chain from frame 0. Returns [(k, final, state)] in order."""
    cfg = sess.render
    dtype = getattr(torch, cfg["state_dtype"])
    out, own = [], RF.initial_state(cfg["height"], cfg["width"], dtype, device)
    scene_of = {}
    for k, given in frames:
        tf = sess.transforms(k)
        key = tuple(sorted((i, t.tobytes()) for i, t in tf.items()))
        if key not in scene_of:
            scene_of.clear()
            scene_of[key] = RS.build(sess.desc, cfg["width"], cfg["height"], device, tf)
        cur, prev = sess.cameras(k)
        st = own if given is None else given
        final, new, _ = RF.render(scene_of[key], st, cur, prev, cfg, dtype)
        if given is None:
            own = new
        out.append((k, final, new))
    return out
