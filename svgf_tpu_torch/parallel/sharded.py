"""Row-sharded frame (svgf_tpu/parallel/sharded.py) on torch.distributed,
one process per GPU.

The frame is cut into `mesh.size` row bands of Hs = H / size rows; rank i
holds rows [i*Hs, (i+1)*Hs) of every image and of the temporal state, and
a copy of the scene. Per frame each rank
  - rasterises and traces its own band, with the random draws keyed by
    GLOBAL pixel ids, so the band's radiance is the whole frame's; with
    `trace_balance` one all-to-all deals the rows round-robin over the
    ranks before the trace and one deals them back (_interleave_a2a);
  - reprojects against the previous state and runs the stencils on
    halo-extended bands (parallel.halo).

Two routes, as in svgf_tpu:
  * the kernel route (use_pallas "auto" or "on"): the previous state's
    BOUND_Y-row halo (_row_halo_planes) and K7 under its motion bound, then
    K8 on the 3-row zero-halo band, K9b once per a-trous step on the
    2*step zero-halo band and K10 on the 1-row edge-halo band
    (kernels.filter). On CPU tensors those wrappers run their plain
    versions, so "auto" on the CPU takes this route too: the tests hold
    it to svgf_tpu's kernel route;
  * the plain route (use_pallas "off"): the previous state all-gathered
    and reprojected without a bound, then the plain stencils on the same
    halos.
A stencil whose halo reaches past the neighbouring band (halo >= Hs)
gathers the whole image, computes it and keeps its band.

With one rank nothing is sent: the halos are the image's boundary.

Every collective carries gradients (parallel.collectives, parallel.halo),
so `make_train_step` differentiates the frame on the plain route, where
svgf_tpu's shard_map transposes its ppermute, all_gather and all_to_all.

    from svgf_tpu_torch.parallel import init_distributed, make_row_mesh, make_sharded_step
    device = init_distributed()                  # torchrun's variables
    mesh = make_row_mesh()
    step = make_sharded_step(config, mesh)
    state = TemporalState.initial(config.height // mesh.size, config.width, ..., device)
    out, state = step(scene.flatten(device=device), state)   # this rank's band
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from svgf_tpu_torch.config import RenderConfig
from svgf_tpu_torch.kernels import filter as K
from svgf_tpu_torch.kernels import resolve_kernels
from svgf_tpu_torch.ops.geometry import abs_, clip, to_srgb
from svgf_tpu_torch.ops.intersect import Hit
from svgf_tpu_torch.ops.keys import fold_in, key
from svgf_tpu_torch.ops.sampling import RngStream
from svgf_tpu_torch.parallel.collectives import all_to_all, gather_tiles
from svgf_tpu_torch.parallel.distributed import RowMesh, make_row_mesh
from svgf_tpu_torch.parallel.halo import crop_halo, with_row_halo, with_row_halos
from svgf_tpu_torch.render import spans, svgf
from svgf_tpu_torch.render.gbuffer import camera_rays, gbuffer_first_hit, raster_gbuffer
from svgf_tpu_torch.render.pathtrace import pathtrace_chunked
from svgf_tpu_torch.render.pipeline import STATE_DTYPES
from svgf_tpu_torch.render.svgf import BOUND_Y
from svgf_tpu_torch.render.types import FrameOutputs, GBuffer, TemporalState

__all__ = ["make_row_mesh", "make_sharded_step", "render_frame_sharded", "gather_rows",
           "make_train_step", "init_params"]


def gather_rows(x, mesh: RowMesh):
    """All-gather a row band (Hs, ...) into the full image (size*Hs, ...);
    the gradient of the image goes back to the band's rows."""
    return gather_tiles([x], mesh)[0]


def _fields_gbuf(**fields) -> GBuffer:
    """A GBuffer with the given fields; the others, which the stage at hand
    does not read, are empty."""
    ref = next(iter(fields.values()))
    empty = ref.new_empty((0,))
    return GBuffer(**{f: fields.get(f, empty) for f in GBuffer._fields})


def _kernel_route(config: RenderConfig, device) -> bool:
    """The kernel route unless use_pallas is "off". "auto" takes the
    wrappers on any device (they run their plain versions on CPU tensors);
    "on" needs CUDA tensors and "interpret" raises, as resolve_kernels
    says."""
    return config.use_pallas == "auto" or resolve_kernels(config.use_pallas, device)


def _stencil_band(fn, img, gbuf: GBuffer, halo: int, mesh: RowMesh, *extra):
    """fn(img, gbuf-like, ...) on the band extended by a `halo`-row zero
    halo of img, `extra` band tensors and the G-buffer's depth,
    depth_deriv and normal; or, when the halo reaches past the neighbour
    (halo >= Hs), on the gathered image, keeping this band."""
    hs = img.shape[0]
    bands = [img, *extra, gbuf.depth, gbuf.depth_deriv, gbuf.normal]
    if halo >= hs:
        full = [gather_rows(x, mesh) for x in bands]
        out = fn(full, _fields_gbuf(depth=full[-3], depth_deriv=full[-2], normal=full[-1]))
        return out[mesh.rank * hs:(mesh.rank + 1) * hs]
    ext = with_row_halos(bands, halo, mesh, "zero")
    out = fn(ext, _fields_gbuf(depth=ext[-3], depth_deriv=ext[-2], normal=ext[-1]))
    return crop_halo(out, halo)


def _moments_filter_band(color, moments, gbuf: GBuffer, history, config: RenderConfig,
                         mesh: RowMesh, kernels: bool):
    """The moments fallback (K8) on the band with a 3-row zero halo. The
    halo carries max(history, 1) (svgf_tpu/parallel/sharded.py:92); the
    gathered image of a tiny band carries the history as it is."""
    fm, sv = (K.filter_moments_band if kernels else svgf.filter_moments), config.svgf
    halo = 3
    hist = history if halo >= color.shape[0] else torch.clamp_min(history, 1)
    return _stencil_band(
        lambda x, g: fm(x[0], x[1], g, x[2], sv.phi_colour, sv.phi_normal),
        color, gbuf, halo, mesh, moments, hist)


def _atrous_band(img, gbuf: GBuffer, step: int, config: RenderConfig, mesh: RowMesh,
                 kernels: bool):
    """One a-trous step (K9b) on the band with a 2*step-row zero halo."""
    fa, sv = (K.atrous_iteration if kernels else svgf.atrous_iteration), config.svgf
    return _stencil_band(lambda x, g: fa(x[0], g, step, sv.phi_colour, sv.phi_normal),
                         img, gbuf, 2 * step, mesh)


def _taa_band(filtered, history, mesh: RowMesh, kernels: bool):
    """TAA + sRGB (K10) on the band with a 1-row edge halo."""
    ext_f, ext_h = with_row_halos([filtered, history], 1, mesh, "edge")
    out = (K.taa_band if kernels else svgf.taa)(ext_f, ext_h)
    return crop_halo(out, 1)


def _row_halo_planes(planes, halo: int, mesh: RowMesh):
    """The previous state's bands extended by `halo` rows from the
    neighbours, zero above the image's first row and below its last: the
    window K7 gathers from. All fields go in one batched exchange."""
    return with_row_halos(planes, halo, mesh, "zero")


def _interleave_a2a(mesh: RowMesh, hs: int, w: int):
    """Ray load balancing (svgf_tpu/parallel/sharded.py:150-176): one
    all-to-all deals the band's rows round-robin so every rank traces
    every n-th global row, a second deals the radiance back. The lane ids
    travel with the rays and key their random draws, so each pixel's
    result does not change. Returns (fwd, inv) over lists of (hs*w, ...)
    lane tensors."""
    n = mesh.size

    def fwd_leaf(x):
        ch = tuple(x.shape[1:])
        v = x.reshape((hs // n, n, w) + ch).transpose(0, 1).contiguous()
        return all_to_all(v).reshape((hs * w,) + ch)

    def inv_leaf(x):
        ch = tuple(x.shape[1:])
        v = all_to_all(x.reshape((n, hs // n, w) + ch).contiguous())
        return v.transpose(0, 1).reshape((hs * w,) + ch)

    return (lambda xs: [fwd_leaf(x) for x in xs], lambda xs: [inv_leaf(x) for x in xs])


def _frame_body(scene, state: TemporalState, config: RenderConfig, mesh: RowMesh,
                events: dict | None = None):
    """One frame on this rank's row band. Every image of `state` and of the
    result is (Hs, W, ...). `events`, when given, receives a CUDA event at
    the end of each stage, as render_frame's does."""
    n, idx = mesh.size, mesh.rank
    h_total, w = config.height, config.width
    hs = h_total // n
    row0 = idx * hs
    cam = config.tracing.current_camera
    sdtype = STATE_DTYPES[config.state_dtype]
    isect = config.use_pallas_intersect or config.use_pallas
    dev = scene.device
    kernels = _kernel_route(config, dev)
    if h_total % n:
        raise ValueError(f"height {h_total} is not a multiple of {n} ranks")
    if kernels and hs < BOUND_Y:
        raise ValueError(f"bands of {hs} rows: the kernel route needs at least {BOUND_Y}")
    if state.color.shape[:2] != (hs, w):
        raise ValueError(f"state band {tuple(state.color.shape[:2])}, expected {(hs, w)}")
    spans.mark(events, "start")

    gbuf = raster_gbuffer(scene, cam, hs, w, mode=isect, row0=row0, h_total=h_total)
    # the depth derivative at the band's last row needs the next band's
    # first row ("edge" at the image's bottom is the unsharded clamp)
    z = gbuf.depth
    ze = with_row_halo(z, 1, mesh, "edge")[1:]
    dzy = abs_(ze[1:] - ze[:-1])
    dzx = abs_(torch.diff(z, dim=1, append=z[:, -1:]))
    gbuf = gbuf._replace(depth_deriv=torch.where(z > 0.0, torch.maximum(dzx, dzy), 0.0))
    spans.mark(events, "gbuffer")

    # the random draws hash GLOBAL pixel ids: each band draws what the
    # whole frame draws for its pixels
    frame_key = fold_in(key(config.seed), state.frame_idx)
    lane_ids = row0 * w + torch.arange(hs * w, dtype=torch.int64, device=dev)
    balance = config.trace_balance and n > 1 and hs % n == 0
    a2a_fwd, a2a_inv = _interleave_a2a(mesh, hs, w) if balance else (None, None)
    radiance = torch.zeros((hs * w, 3), device=dev)
    for s in range(config.tracing.batch):
        skey = fold_in(frame_key, s)
        jstream = RngStream(fold_in(skey, 987), lane_ids)
        jitter = jstream.uniform2().reshape(hs, w, 2) * 2.0 - 1.0
        ro, rd = camera_rays(scene.cam_frame[cam], scene.cam_proj[cam], hs, w, jitter=jitter,
                             row0=row0, h_total=h_total)
        first_hit = gbuffer_first_hit(gbuf) if config.hybrid_primary else None
        ids = lane_ids
        if balance:
            ro, rd, ids = a2a_fwd([ro, rd, lane_ids])
            if first_hit is not None:
                first_hit = Hit(*a2a_fwd(list(first_hit)))
        sample, _ = pathtrace_chunked(
            scene, ro, rd, skey,
            bounces=config.tracing.bounces, clamp=config.tracing.clamp,
            mode=config.tracing.sampling_mode, first_hit=first_hit,
            num_chunks=config.trace_chunks, intersect_mode=isect, lane_ids=ids,
        )
        if balance:
            (sample,) = a2a_inv([sample])
        radiance = radiance + sample / config.tracing.batch
    radiance = radiance.reshape(hs, w, 3)
    spans.mark(events, "trace")

    sv = config.svgf
    thresholds = (sv.depth_threshold, sv.normal_threshold, sv.history_length)
    prev = state.gbuffer
    if kernels:
        # motion is bounded to BOUND_Y rows a frame, so a BOUND_Y-row halo
        # of the previous state is all K7 can reach
        color, moments, hist, depth, normal, inst = _row_halo_planes(
            [state.color, state.moments, state.history_len, prev.depth, prev.normal,
             prev.instance], BOUND_Y, mesh)
        tres = K.temporal_filter_band(
            radiance, color, gbuf, _fields_gbuf(depth=depth, normal=normal, instance=inst),
            moments, hist, *thresholds, row0=row0, h_total=h_total)
    else:
        # the exact unbounded gather against the whole previous frame
        full = [gather_rows(x, mesh) for x in (state.color, state.moments, state.history_len,
                                                prev.depth, prev.normal, prev.instance)]
        tres = svgf.temporal_filter(
            radiance, full[0], gbuf, _fields_gbuf(depth=full[3], normal=full[4], instance=full[5]),
            full[1], full[2], *thresholds, row0=row0)
    spans.mark(events, "temporal")

    moments_out = _moments_filter_band(tres.color, tres.moments, gbuf, tres.history_len,
                                       config, mesh, kernels)
    spans.mark(events, "moments")
    out = moments_out
    feedback = tres.color if sv.spatial_filter_steps == 0 else None
    for i in range(sv.spatial_filter_steps):
        out = _atrous_band(out, gbuf, 1 << i, config, mesh, kernels)
        if i == 0:
            feedback = out
    atrous_out = out
    spans.mark(events, "atrous")

    if sv.enable_taa:
        final = _taa_band(atrous_out, state.taa_history, mesh, kernels)
    else:
        rgb = clip(atrous_out[..., :3], 0.0, 1.0)
        final = torch.cat([to_srgb(rgb), torch.ones_like(rgb[..., :1])], dim=-1)
    spans.mark(events, "taa")

    new_gbuf = gbuf.to_dtype(sdtype)
    new_state = TemporalState(
        color=feedback.to(sdtype), moments=tres.moments.to(sdtype),
        history_len=tres.history_len, taa_history=final.to(sdtype), gbuffer=new_gbuf,
        frame_idx=state.frame_idx + 1,
    )
    outputs = FrameOutputs(
        image=final[..., :3], radiance=radiance, temporal=tres.color,
        moments_filtered=moments_out, atrous=atrous_out, final=final[..., :3],
        gbuffer=new_gbuf,
    )
    spans.mark(events, "state")
    return outputs, new_state


def make_sharded_step(config: RenderConfig, mesh: RowMesh):
    """The sharded frame step: (scene, this rank's band of the state) ->
    (this rank's band of FrameOutputs, of the next TemporalState). The
    scene is the whole scene on this rank's device; `events` as in
    render_frame."""

    @torch.no_grad()
    def step(scene, state: TemporalState, events: dict | None = None):
        return _frame_body(scene, state, config, mesh, events)

    return step


def render_frame_sharded(scene, state: TemporalState, config: RenderConfig, mesh: RowMesh):
    return make_sharded_step(config, mesh)(scene, state)


def _detached(x):
    """A record (TemporalState, its GBuffer) with every tensor detached."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_detached, x))
    return x


def train_step_of(frame, config: RenderConfig, size: int):
    """train_step(params, scene, state, target) -> (loss, grads, new_state)
    over `frame(scene, state) -> (outputs, state)`, one rank's part of a
    sharded frame: the loss is the mean of (final - target)**2 over the
    whole H x W x 3 image (each rank's sum, all-reduced), and the grads,
    of the replicated params, are summed over the ranks (svgf_tpu gets both
    from shard_map's psum). `target` is this rank's part of the image."""
    n_total = config.height * config.width * 3

    def train_step(params: dict, scene, state: TemporalState, target):
        names = list(params)
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        with torch.enable_grad():
            out, new_state = frame(dataclasses.replace(scene, **dict(zip(names, leaves))), state)
            if out.final.shape != target.shape:
                raise ValueError(f"target {tuple(target.shape)}, this rank's image is "
                                 f"{tuple(out.final.shape)}")
            local = ((out.final - target) ** 2).sum() / n_total
            grads = torch.autograd.grad(local, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        loss = local.detach().clone()
        if size > 1:
            for t in (loss, *grads):
                dist.all_reduce(t)
        return loss, dict(zip(names, grads)), _detached(new_state)

    return train_step


def make_train_step(config: RenderConfig, mesh: RowMesh,
                    param_fields: tuple = ("mat_colour", "mat_emission")):
    """Differentiable sharded step (svgf_tpu/parallel/sharded.py:364-392):
    `train_step(params, scene, state, target) -> (loss, grads, new_state)`,
    the gradient of an image loss with respect to the SceneArrays fields
    in `params` (made by `init_params`; replicated on every rank):

      materials  "mat_colour", "mat_emission", "mat_roughness", ...
      lights     "mat_emission" (area lights are emissive materials),
                 "env_emission"
      camera     "cam_frame" (ray generation is smooth; the hit choice is
                 constant)

    `state` and `target` are this rank's band; the loss and grads are the
    whole image's on every rank. The filters are differentiable on the
    plain route (use_pallas="off"), as in svgf_tpu; the kernel route's
    filter wrappers refuse autograd (kernels.filter.refuse_autograd).
    `param_fields` names the fields, as svgf_tpu's signature does."""
    del param_fields  # the fields are the keys of `params`
    return train_step_of(lambda scene, state: _frame_body(scene, state, config, mesh),
                         config, mesh.size)


def init_params(scene, param_fields: tuple = ("mat_colour", "mat_emission")) -> dict:
    """The trainable fields for make_train_step."""
    return {f: getattr(scene, f) for f in param_fields}
