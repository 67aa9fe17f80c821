"""2-D tile-mesh image parallelism (svgf_tpu/parallel/tiled.py) on
torch.distributed, one process per GPU: the frame is cut into a
rows x cols grid of (Hs, Ws) tiles (a TileMesh, rank-major), rank r
holding tile (r // cols, r % cols) of every image and of the temporal
state, and a copy of the scene.

Why 2-D: at 8 or more ranks a row mesh leaves 135-row bands at 1080p,
and the a-trous halo (2*step, up to 32 rows) starts to rival the band;
square-ish tiles keep the halo/compute ratio flat.

Per frame each rank rasterises and traces its own tile, with the random
draws keyed by GLOBAL pixel ids, so the tile renders exactly the pixels
of the whole frame; the depth derivative takes the next tile's first row
and column. The stencils run on 2-D halo-extended tiles (parallel.halo:
rows, then columns of the row-extended tile, which carries the corners):
  * temporal: the previous state in a (BY, BX) = reproject_max_motion
    window of zero halos when the tile is larger than the bound (motion
    beyond it leaves the window and is a disocclusion), else the whole
    previous frame all-gathered;
  * moments (3-wide zero halo) and each a-trous step (2*step), or, when
    the halo reaches past the neighbouring tile, the whole image gathered
    and this tile kept;
  * TAA on the 1-wide "edge" halo.

As in svgf_tpu (whose tiled step runs its XLA stencils, not its Pallas
band kernels), the filters here are the plain stencils of render/svgf.py
on every device; the kernels' route is the row mesh (parallel.sharded).
The intersector follows `use_pallas_intersect` (else `use_pallas`), so on
the card it runs K5 or K6. Every collective carries gradients, so
`make_tiled_train_step` differentiates the frame.

    from svgf_tpu_torch.parallel import init_distributed, make_tile_mesh, make_tiled_step
    device = init_distributed()                  # torchrun's variables
    mesh = make_tile_mesh(2, 2)                  # a 4-rank group
    step = make_tiled_step(config, mesh)
    state = TemporalState.initial(config.height // 2, config.width // 2, ..., device)
    out, state = step(scene.flatten(device=device), state)   # this rank's tile
"""

from __future__ import annotations

import torch

from svgf_tpu_torch.config import RenderConfig
from svgf_tpu_torch.ops.geometry import abs_, clip, to_srgb
from svgf_tpu_torch.ops.keys import fold_in, key
from svgf_tpu_torch.ops.sampling import RngStream
from svgf_tpu_torch.parallel.collectives import gather_tiles
from svgf_tpu_torch.parallel.distributed import RowMesh, TileMesh, make_row_mesh, make_tile_mesh
from svgf_tpu_torch.parallel.halo import (
    crop_tile_halo, with_col_halo, with_col_halos, with_row_halo, with_row_halos,
    with_tile_halos,
)
from svgf_tpu_torch.parallel.sharded import _fields_gbuf, make_sharded_step, train_step_of
from svgf_tpu_torch.render import spans, svgf
from svgf_tpu_torch.render.gbuffer import camera_rays, gbuffer_first_hit, raster_gbuffer
from svgf_tpu_torch.render.pathtrace import pathtrace_chunked
from svgf_tpu_torch.render.pipeline import STATE_DTYPES
from svgf_tpu_torch.render.types import FrameOutputs, GBuffer, TemporalState

__all__ = ["make_tile_mesh", "make_mesh_from_config", "make_step_from_config",
           "make_tiled_step", "make_tiled_train_step"]


def make_mesh_from_config(mesh_cfg):
    """MeshConfig -> mesh: a TileMesh when tiles_x > 1, else the row mesh
    of tiles_y ranks."""
    if mesh_cfg.tiles_x > 1:
        return make_tile_mesh(mesh_cfg.tiles_y, mesh_cfg.tiles_x,
                              (mesh_cfg.axis_y, mesh_cfg.axis_x))
    mesh = make_row_mesh()
    if mesh.size != mesh_cfg.tiles_y:
        raise ValueError(f"a row mesh of {mesh_cfg.tiles_y} ranks, the group has {mesh.size}")
    return mesh


def make_step_from_config(config: RenderConfig, mesh=None):
    """The sharded frame step of the mesh's rank: 2-D tiles (plain
    stencils, make_tiled_step) when it has more than one column, else rows
    (make_sharded_step, the band kernels)."""
    if mesh is None:
        mesh = make_mesh_from_config(config.mesh)
    if isinstance(mesh, TileMesh):
        if mesh.cols > 1:
            return make_tiled_step(config, mesh)
        mesh = RowMesh(rank=mesh.rank, size=mesh.size)
    return make_sharded_step(config, mesh)


def _tile_depth_deriv(z, mesh: TileMesh):
    """Tile-exact depth derivative: forward differences with the next
    tile's first row and column ("edge" at the image's border is the whole
    frame's clamp)."""
    ze_r = with_row_halo(z, 1, mesh, "edge")[1:]          # (hs+1, ws): self + next row
    dzy = abs_(ze_r[1:] - ze_r[:-1])
    ze_c = with_col_halo(z, 1, mesh, "edge")[:, 1:]       # (hs, ws+1)
    dzx = abs_(ze_c[:, 1:] - ze_c[:, :-1])
    return torch.maximum(dzx, dzy)


def _own(full, mesh: TileMesh, hs: int, ws: int):
    return full[mesh.iy * hs:(mesh.iy + 1) * hs, mesh.ix * ws:(mesh.ix + 1) * ws]


def _stencil_tile(fn, imgs, gbuf: GBuffer, halo: int, mesh: TileMesh):
    """fn(imgs, gbuf-like) on the tiles extended by a `halo`-wide zero halo
    (imgs and the G-buffer's depth, depth_deriv, normal), cropped back; or,
    when the halo reaches past the neighbouring tile, on the gathered
    image, keeping this tile."""
    hs, ws = imgs[0].shape[:2]
    tiles = [*imgs, gbuf.depth, gbuf.depth_deriv, gbuf.normal]
    if halo >= hs or halo >= ws:
        full = gather_tiles(tiles, mesh)
        out = fn(full[:-3], _fields_gbuf(depth=full[-3], depth_deriv=full[-2],
                                         normal=full[-1]))
        return _own(out, mesh, hs, ws)
    ext = with_tile_halos(tiles, halo, mesh, "zero")
    out = fn(ext[:-3], _fields_gbuf(depth=ext[-3], depth_deriv=ext[-2], normal=ext[-1]))
    return crop_tile_halo(out, halo)


def _tiled_frame_body(scene, state: TemporalState, config: RenderConfig, mesh: TileMesh,
                      events: dict | None = None):
    """One frame on this rank's (Hs, Ws) tile (svgf_tpu/parallel/tiled.py
    _frame_body_2d). Every image of `state` and of the result is a tile."""
    h_total, w_total = config.height, config.width
    if h_total % mesh.rows or w_total % mesh.cols:
        raise ValueError(f"{h_total} x {w_total} is not a multiple of the "
                         f"{mesh.rows} x {mesh.cols} mesh")
    hs, ws = h_total // mesh.rows, w_total // mesh.cols
    row0, col0 = mesh.iy * hs, mesh.ix * ws
    if state.color.shape[:2] != (hs, ws):
        raise ValueError(f"state tile {tuple(state.color.shape[:2])}, expected {(hs, ws)}")
    cam = config.tracing.current_camera
    sdtype = STATE_DTYPES[config.state_dtype]
    isect = config.use_pallas_intersect or config.use_pallas
    dev = scene.device
    sv = config.svgf
    spans.mark(events, "start")

    gbuf = raster_gbuffer(scene, cam, hs, ws, mode=isect, row0=row0, h_total=h_total,
                          col0=col0, w_total=w_total)
    z = gbuf.depth
    gbuf = gbuf._replace(depth_deriv=torch.where(z > 0.0, _tile_depth_deriv(z, mesh), 0.0))
    spans.mark(events, "gbuffer")

    # global lane ids (pixels of the whole image): the draws are the whole frame's
    rr = torch.arange(hs, dtype=torch.int64, device=dev)[:, None] + row0
    cc = torch.arange(ws, dtype=torch.int64, device=dev)[None, :] + col0
    lane_ids = (rr * w_total + cc).reshape(-1)
    frame_key = fold_in(key(config.seed), state.frame_idx)
    radiance = torch.zeros((hs * ws, 3), device=dev)
    for s in range(config.tracing.batch):
        skey = fold_in(frame_key, s)
        jstream = RngStream(fold_in(skey, 987), lane_ids)
        jitter = jstream.uniform2().reshape(hs, ws, 2) * 2.0 - 1.0
        ro, rd = camera_rays(scene.cam_frame[cam], scene.cam_proj[cam], hs, ws, jitter=jitter,
                             row0=row0, h_total=h_total, col0=col0, w_total=w_total)
        first_hit = gbuffer_first_hit(gbuf) if config.hybrid_primary else None
        sample, _ = pathtrace_chunked(
            scene, ro, rd, skey,
            bounces=config.tracing.bounces, clamp=config.tracing.clamp,
            mode=config.tracing.sampling_mode, first_hit=first_hit,
            num_chunks=config.trace_chunks, intersect_mode=isect, lane_ids=lane_ids,
        )
        radiance = radiance + sample / config.tracing.batch
    radiance = radiance.reshape(hs, ws, 3)
    spans.mark(events, "trace")

    thresholds = (sv.depth_threshold, sv.normal_threshold, sv.history_length)
    prev = state.gbuffer
    planes = [state.color.float(), state.moments.float(), state.history_len,
              prev.depth.float(), prev.normal.float(), prev.instance]
    by, bx = config.reproject_max_motion
    if by < hs and bx < ws:
        # motion within (BY, BX) reaches only a (BY, BX) window of the
        # previous state: zero halos, no image-sized gather
        win = with_col_halos(with_row_halos(planes, by, mesh, "zero"), bx, mesh, "zero")
        tres = svgf.temporal_filter(
            radiance, win[0], gbuf, _fields_gbuf(depth=win[3], normal=win[4], instance=win[5]),
            win[1], win[2], *thresholds, row0=row0, col0=col0,
            prev_row0=row0 - by, prev_col0=col0 - bx, full_h=h_total, full_w=w_total)
    else:
        full = gather_tiles(planes, mesh)
        tres = svgf.temporal_filter(
            radiance, full[0], gbuf, _fields_gbuf(depth=full[3], normal=full[4], instance=full[5]),
            full[1], full[2], *thresholds, row0=row0, col0=col0)
    spans.mark(events, "temporal")

    # the halo carries max(history, 1) (svgf_tpu/parallel/tiled.py:216); the
    # gathered image carries the history as it is
    halo = 3
    hist = tres.history_len if halo >= hs or halo >= ws else torch.clamp_min(tres.history_len, 1)
    moments_out = _stencil_tile(
        lambda x, g: svgf.filter_moments(x[0], x[1], g, x[2], sv.phi_colour, sv.phi_normal),
        [tres.color, tres.moments, hist], gbuf, halo, mesh)
    spans.mark(events, "moments")
    out = moments_out
    feedback = tres.color if sv.spatial_filter_steps == 0 else None
    for i in range(sv.spatial_filter_steps):
        step = 1 << i
        out = _stencil_tile(
            lambda x, g, step=step: svgf.atrous_iteration(x[0], g, step, sv.phi_colour,
                                                          sv.phi_normal),
            [out], gbuf, 2 * step, mesh)
        if i == 0:
            feedback = out
    atrous_out = out
    spans.mark(events, "atrous")

    if sv.enable_taa:
        ext_f, ext_h = with_tile_halos([atrous_out, state.taa_history.float()], 1, mesh, "edge")
        final = crop_tile_halo(svgf.taa(ext_f, ext_h), 1)
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


def make_tiled_step(config: RenderConfig, mesh: TileMesh):
    """The 2-D tiled frame step: (scene, this rank's tile of the state) ->
    (this rank's tile of FrameOutputs, of the next TemporalState); the
    scene is the whole scene on this rank's device. `events` as in
    render_frame."""

    @torch.no_grad()
    def step(scene, state: TemporalState, events: dict | None = None):
        return _tiled_frame_body(scene, state, config, mesh, events)

    return step


def make_tiled_train_step(config: RenderConfig, mesh: TileMesh,
                          param_fields: tuple = ("mat_colour", "mat_emission")):
    """Differentiable 2-D tiled step (svgf_tpu/parallel/tiled.py:314-334):
    make_train_step's contract on a TileMesh. `state` and `target` are this
    rank's tile; the loss and the grads, summed over both mesh axes, are
    the whole image's on every rank."""
    del param_fields  # the fields are the keys of `params`
    return train_step_of(lambda scene, state: _tiled_frame_body(scene, state, config, mesh),
                         config, mesh.size)

