"""Frame pipeline (svgf_tpu/render/pipeline.py; reference application::Render,
App.cu:539-690).

`render_frame(scene, state, config) -> (FrameOutputs, TemporalState)` runs
the six reference stages

    Rasterize -> Trace -> TemporalFilter -> FilterMoments -> WaveletFilter -> TAA

with the reference's data flow, including the iteration-0 wavelet feedback
into the next frame's temporal history (Filter.cuh:619-622). The four
filter stages run either the CUDA kernels (kernels.filter) or their plain
torch versions (render.svgf), as `kernels.resolve_kernels` decides from
`config.use_pallas` and the tensors' device; the intersector runs its
kernels (kernels.intersect) or plain versions (ops.intersect) as
`config.use_pallas_intersect` (else `use_pallas`) decides. Scenes over
DENSE_MAX_TRIS triangles trace in 64x64 pixel blocks. `config.planar_chain`
has no meaning here and is ignored: the port has one state layout.
"""

from __future__ import annotations

import dataclasses

import torch

from svgf_tpu_torch.config import DebugOutput, RenderConfig
from svgf_tpu_torch.core import edits
from svgf_tpu_torch.core.scene import target_device
from svgf_tpu_torch.kernels import resolve_kernels
from svgf_tpu_torch.ops.geometry import clip, to_srgb
from svgf_tpu_torch.ops.keys import fold_in, key
from svgf_tpu_torch.ops.sampling import RngStream
from svgf_tpu_torch.render import spans, svgf
from svgf_tpu_torch.render.gbuffer import camera_rays, gbuffer_first_hit, raster_gbuffer
from svgf_tpu_torch.render.pathtrace import pathtrace_chunked
from svgf_tpu_torch.render.types import FrameMetrics, FrameOutputs, TemporalState

STATE_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _filter_stages(device, config: RenderConfig):
    """The module whose temporal_filter / filter_moments / wavelet_filter /
    taa run: the kernel wrappers or the plain versions."""
    if resolve_kernels(config.use_pallas, device):
        from svgf_tpu_torch.kernels import filter as kernels

        return kernels
    return svgf


def filter_chain(radiance, gbuf, state: TemporalState, config: RenderConfig,
                 events: dict | None = None, checkpoint: bool = False):
    """Stages 3-6 (TemporalFilter -> FilterMoments -> WaveletFilter -> TAA,
    App.cu:469-522) on one frame's radiance. Returns (temporal_result,
    moments_out, atrous_out, final, feedback), where `feedback` is next
    frame's temporal history (a-trous iteration 0, or the temporal output
    when there are no a-trous steps). `checkpoint` runs each plain a-trous
    step under torch.utils.checkpoint (render_frame's). `events`, when
    given, receives the marks filter.begin, temporal, moments, atrous and
    taa, and the call is a recorded frame (render.spans)."""
    with spans.frame(events, radiance.device):
        spans.mark(events, "filter.begin")
        F = _filter_stages(radiance.device, config)
        sv = config.svgf
        tres = F.temporal_filter(
            radiance, state.color, gbuf, state.gbuffer, state.moments, state.history_len,
            depth_threshold=sv.depth_threshold, normal_threshold=sv.normal_threshold,
            history_base_length=sv.history_length,
        )
        spans.mark(events, "temporal")
        moments_out = F.filter_moments(
            tres.color, tres.moments, gbuf, tres.history_len,
            phi_colour=sv.phi_colour, phi_normal=sv.phi_normal,
        )
        spans.mark(events, "moments")
        if checkpoint and F is svgf:
            atrous_out = feedback = moments_out
            for i in range(sv.spatial_filter_steps):
                atrous_out = torch.utils.checkpoint.checkpoint(
                    svgf.atrous_iteration, atrous_out, gbuf, 1 << i, sv.phi_colour, sv.phi_normal,
                    use_reentrant=False)
                if i == 0:
                    feedback = atrous_out
        else:
            atrous_out, feedback, _ = F.wavelet_filter(
                moments_out, gbuf, steps=sv.spatial_filter_steps,
                phi_colour=sv.phi_colour, phi_normal=sv.phi_normal,
            )
        if sv.spatial_filter_steps == 0:
            feedback = tres.color  # RenderBuffer keeps the temporal output
        spans.mark(events, "atrous")
        if sv.enable_taa:
            final = F.taa(atrous_out, state.taa_history)
        else:
            rgb = clip(atrous_out[..., :3], 0.0, 1.0)
            final = torch.cat([to_srgb(rgb), torch.ones_like(rgb[..., :1])], dim=-1)
        spans.mark(events, "taa")
        return tres, moments_out, atrous_out, final, feedback


def render_frame(scene, state: TemporalState, config: RenderConfig,
                 events: dict | None = None, checkpoint: bool = False):
    """One frame. `events`, when given, receives a CUDA event recorded at
    the end of each stage (gbuffer, trace, temporal, moments, atrous, taa,
    state) and of each part inside them, and the frame is recorded with
    its host stamps and syncs (render.spans).

    The frame is differentiable on the plain filter route (use_pallas
    "off"; the filter kernels refuse autograd) with the intersector on
    either route: K5/K6 pick each winner and torch recomputes its t/u/v.
    The hit choice and the medium's sampled distance are constants, as in
    svgf_tpu. With `checkpoint`, autograd keeps each trace chunk's and each
    a-trous step's inputs and recomputes them in the backward pass
    (torch.utils.checkpoint): the same numbers, since every draw hashes
    global lane ids, for a fraction of the memory at 1080p."""
    with spans.frame(events, scene.device):
        h, w = config.height, config.width
        cam = config.tracing.current_camera
        sdtype = STATE_DTYPES[config.state_dtype]
        isect = config.use_pallas_intersect or config.use_pallas
        dev = scene.device
        spans.mark(events, "start")

        # large scenes trace in 64x64 pixel blocks (render.pathtrace.make_block_order)
        blocked = scene.meta.soup_leaf_order

        # ---- 1. Rasterize (primary visibility) ----
        gbuf = raster_gbuffer(scene, cam, h, w, num_chunks=config.trace_chunks, mode=isect,
                              block=blocked, events=events)
        spans.mark(events, "gbuffer")

        # ---- 2. Trace (batch x 1spp path tracing) ----
        frame_key = fold_in(key(config.seed), state.frame_idx)
        radiance = torch.zeros((h * w, 3), device=dev)
        rays_traced = torch.tensor(h * w, dtype=torch.int64, device=dev)  # the G-buffer pass
        pixels = torch.arange(h * w, dtype=torch.int64, device=dev)
        for s in range(config.tracing.batch):
            skey = fold_in(frame_key, s)
            jstream = RngStream(fold_in(skey, 987), pixels)
            jitter = (jstream.uniform2().reshape(h, w, 2)) * 2.0 - 1.0
            ro, rd = camera_rays(scene.cam_frame[cam], scene.cam_proj[cam], h, w, jitter=jitter)
            first_hit = gbuffer_first_hit(gbuf) if config.hybrid_primary else None
            spans.mark(events, "trace.setup")
            sample, nr = pathtrace_chunked(
                scene, ro, rd, skey,
                bounces=config.tracing.bounces, clamp=config.tracing.clamp,
                mode=config.tracing.sampling_mode, first_hit=first_hit,
                num_chunks=config.trace_chunks, intersect_mode=isect,
                block_hw=(h, w) if blocked else None, checkpoint=checkpoint, events=events,
            )
            radiance = radiance + sample / config.tracing.batch
            rays_traced = rays_traced + nr
        radiance = radiance.reshape(h, w, 3)
        spans.mark(events, "trace")

        # ---- 3-6. Filter chain ----
        tres, moments_out, atrous_out, final, feedback = filter_chain(
            radiance, gbuf, state, config, events, checkpoint
        )
        new_state = TemporalState(
            color=feedback.to(sdtype),
            moments=tres.moments.to(sdtype),
            history_len=tres.history_len,
            taa_history=final.to(sdtype),
            gbuffer=gbuf.to_dtype(sdtype),
            frame_idx=state.frame_idx + 1,
        )
        taps = config.keep_taps or config.debug_output != DebugOutput.FINAL
        metrics = FrameMetrics(
            disoccluded_pct=100.0 * (1.0 - tres.reprojected.float().mean()),
            mean_history=tres.history_len.float().mean(),
            mean_variance=tres.color[..., 3].mean(),
            coverage_pct=100.0 * (gbuf.instance >= 0).float().mean(),
            rays_traced=rays_traced,
        )
        outputs = FrameOutputs(
            image=_select_tap(config.debug_output, radiance, tres, moments_out,
                              atrous_out, final, gbuf),
            radiance=radiance if taps else None,
            temporal=tres.color if taps else None,
            moments_filtered=moments_out if taps else None,
            atrous=atrous_out if taps else None,
            final=final[..., :3],
            gbuffer=gbuf if taps else None,
            metrics=metrics,
        )
        spans.mark(events, "state")
        return outputs, new_state


def _select_tap(tap: DebugOutput, radiance, tres, moments_out, atrous_out, final, gbuf):
    """Debug render-graph taps (reference SVGFDebugOutputEnum, App.h:92-105)."""
    if tap == DebugOutput.FINAL:
        return final[..., :3]
    if tap == DebugOutput.RAW:
        return radiance
    if tap == DebugOutput.NORMAL:
        return gbuf.normal * 0.5 + 0.5
    if tap == DebugOutput.MOTION:
        m = gbuf.motion
        return torch.cat([torch.abs(m), torch.zeros_like(m[..., :1])], -1)
    if tap == DebugOutput.POSITION:
        return gbuf.position
    if tap == DebugOutput.BARYCENTRIC:
        u, v = gbuf.uv[..., 0], gbuf.uv[..., 1]
        return torch.stack([u, v, 1.0 - u - v], -1)
    if tap == DebugOutput.TEMPORAL:
        return tres.color[..., :3]
    if tap == DebugOutput.ATROUS:
        return atrous_out[..., :3]
    if tap == DebugOutput.MOMENTS:
        m = tres.moments
        return torch.cat([m, torch.zeros_like(m[..., :1])], -1)
    if tap == DebugOutput.VARIANCE:
        return tres.color[..., 3:4].expand(-1, -1, 3)
    if tap == DebugOutput.DEPTH:
        d = gbuf.depth / torch.clamp_min(gbuf.depth.max(), 1e-6)
        return d[..., None].expand(-1, -1, 3)
    raise ValueError(f"unknown tap {tap}")


class Renderer:
    """Owns the flattened scene and the cross-frame state on `device` (the
    card by default; device="cpu" runs on the CPU, and a missing card
    raises): `out = renderer.step()` per frame, camera moves through
    `update_camera(frame)` (PreviousFrame handling matches EndFrame,
    App.cu:372), scene edits through `update_material`,
    `update_instance_transform` and `add_asset`. `state` may be replaced
    between frames, e.g. by `io.load_checkpoint` to resume a sequence."""

    def __init__(self, scene, config: RenderConfig, device="cuda"):
        if config.mesh.tiles_y * config.mesh.tiles_x != 1:
            raise NotImplementedError(
                "Renderer runs on one device; on a mesh one process per GPU runs "
                "svgf_tpu_torch.parallel.make_step_from_config (make_sharded_step on rows, "
                "make_tiled_step on tiles)")
        self.scene = scene
        self.config = config
        self.device = target_device(device)
        for cam in scene.cameras:
            cam.aspect = config.width / config.height
        self.arrays = scene.flatten(device=self.device)
        self.state = TemporalState.initial(
            config.height, config.width, STATE_DTYPES[config.state_dtype], self.device
        )

    def update_camera(self, new_frame, index: int | None = None):
        idx = self.config.tracing.current_camera if index is None else index
        cam = self.scene.cameras[idx].advance(new_frame)
        self.scene.cameras[idx] = cam
        cam_frame = self.arrays.cam_frame.clone()
        cam_prev = self.arrays.cam_prev_frame.clone()
        cam_frame[idx] = torch.as_tensor(cam.frame, device=self.device)
        cam_prev[idx] = torch.as_tensor(cam.previous_frame, device=self.device)
        self.arrays = dataclasses.replace(self.arrays, cam_frame=cam_frame,
                                          cam_prev_frame=cam_prev)

    # ---- incremental scene edits (core.edits; reference BVH.cpp:491-583,
    # Scene.cpp:447-451, AssetLoader.cpp:11-55). The state stays: the
    # resolution does not change ----

    def update_material(self, index: int, material) -> None:
        self.arrays = edits.update_material(self.scene, self.arrays, index, material)

    def update_instance_transform(self, index: int, transform) -> None:
        self.arrays = edits.update_instance_transform(self.scene, self.arrays, index, transform)

    def add_asset(self, path: str) -> None:
        self.scene, self.arrays = edits.add_asset(self.scene, path, device=self.device)

    @torch.no_grad()
    def step(self, events: dict | None = None) -> FrameOutputs:
        out, self.state = render_frame(self.arrays, self.state, self.config, events)
        return out

    def render_sequence(self, camera_frames) -> list:
        """Offline driver loop: render one frame per camera pose."""
        outs = []
        for f in camera_frames:
            self.update_camera(f)
            outs.append(self.step())
        return outs
