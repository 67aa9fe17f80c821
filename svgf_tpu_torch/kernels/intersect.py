"""Wrappers of the two intersector kernels (svgf_tpu_torch/csrc).

| wrapper                    | kernel                      | replaces (svgf_tpu/kernels/intersect_pallas.py) |
|----------------------------|-----------------------------|-------------------------------------------------|
| intersect_dense_kernel     | csrc/intersect_dense.cu     | intersect_dense_pallas (:561)                   |
| intersect_clustered_kernel | csrc/intersect_clustered.cu | intersect_clustered_pallas (:489)               |

Each takes the arguments of its plain version (ops/intersect.py
intersect_dense, traverse_scene_bvh) and returns a Hit. Given CPU tensors
it runs the plain version; given CUDA tensors it launches its kernel on
the current stream, or raises; it never falls back. The dense kernel
writes the whole Hit in its one launch. When autograd needs t/u/v as
functions of the ray or the soup (`needs_recompute`), it also writes the
winning soup column, and `hit_from_winner` gathers the winner and
recomputes t/u/v in torch, as svgf_tpu's wrapper does to keep them
differentiable. The scene-BVH kernel chooses the column only, and
`hit_from_winner` builds its Hit.

The kernels read the soup (and the scene BVH's nodes) packed once per
scene into 16-byte records (`packed_scene`), kept on the device for the
last few scenes packed; an entry holds its source tensors too.
"""

from __future__ import annotations

import ctypes

import torch

from svgf_tpu_torch.kernels.build import library
from svgf_tpu_torch.kernels.launch import LAUNCHES, check, launch, on_cpu, ptr
from svgf_tpu_torch.ops.intersect import (
    Hit, hit_from_winner, intersect_dense, start_dist, traverse_scene_bvh,
)

# packed copies, keyed by the source tensors' ids; an entry holds the
# source tensors (so an id is not reused while it lives) and their
# versions (an in-place edit repacks)
_PACKED: dict = {}
_PACKED_MAX = 4


def _sources(scene):
    return (scene.world_tris9, scene.world_tri_inst, scene.world_tri_prim, scene.world_tri_mat,
            scene.wbvh_bounds6, scene.wbvh_skip, scene.wbvh_leaf_tri)


def packed_scene(scene):
    """(tris (T, 12) f32, nodes (N, 8) f32) on the scene's device.

    tris: per soup column [v0.xyz, instance id bits | e1.xyz, prim id bits |
    e2.xyz, material id bits] with e1 = v1 - v0, e2 = v2 - v0. nodes: per scene-BVH node
    [lo.xyz, skip bits | hi.xyz, leaf column bits]."""
    src = _sources(scene)
    key = tuple(id(t) for t in src)
    versions = tuple(t._version for t in src)
    entry = _PACKED.get(key)
    if entry is None or entry[1] != versions:
        w = scene.world_tris9
        v0 = w[0:3]
        bits = lambda ids: ids.view(torch.float32)[None]
        tris = torch.cat([v0, bits(scene.world_tri_inst), w[3:6] - v0, bits(scene.world_tri_prim),
                          w[6:9] - v0, bits(scene.world_tri_mat)]).T.contiguous()
        b6 = scene.wbvh_bounds6
        nodes = torch.cat([b6[0:3], scene.wbvh_skip.view(torch.float32)[None],
                           b6[3:6], scene.wbvh_leaf_tri.view(torch.float32)[None]]).T.contiguous()
        if len(_PACKED) >= _PACKED_MAX:
            _PACKED.clear()
        entry = _PACKED[key] = (src, versions, tris, nodes)
    return entry[2], entry[3]


def _rays(ro, rd, active, tmax):
    """The kernels' ray inputs: contiguous (R, 3) f32 origins and
    directions, (R,) f32 start distances (None: MAX_LENGTH) and (R,) bool
    active flags (None: all active)."""
    R = ro.shape[0]
    ro = ro.detach().contiguous()
    rd = rd.detach().contiguous()
    t0 = None if tmax is None else start_dist(tmax, R, ro.device).contiguous()
    act = None if active is None else active.contiguous()
    check(ro, "ro", (R, 3), (torch.float32,))
    check(rd, "rd", (R, 3), (torch.float32,))
    if t0 is not None:
        check(t0, "tmax", (R,), (torch.float32,))
    if act is not None:
        check(act, "active", (R,), (torch.bool,))
    return ro, rd, t0, act


def _ptr_or_null(t):
    return ctypes.c_void_p(None) if t is None else ptr(t)


def _columns(scene, only_instance):
    """The soup columns [c0, c1) a search sweeps, and the instance it keeps (-1: all)."""
    if only_instance is None:
        return 0, scene.meta.n_world_tris, -1
    start, count = scene.meta.inst_world_range[only_instance]
    return start, start + count, int(only_instance)


def dense_hit(scene, ro, rd, t0, act, only_instance=None, with_col: bool = False):
    """Launch K5 on prepared rays (`_rays`); returns (the Hit, the winning
    column (R,) i32 with -1 for none, or None unless `with_col`)."""
    tris, _ = packed_scene(scene)
    R, dev = ro.shape[0], ro.device
    f32 = lambda: torch.empty((R,), dtype=torch.float32, device=dev)
    i32 = lambda: torch.empty((R,), dtype=torch.int32, device=dev)
    hit = Hit(dist=f32(), u=f32(), v=f32(), prim=i32(), instance=i32(), material=i32())
    col = i32() if with_col else None
    launch(library().svgf_intersect_dense, dev, ptr(tris), ptr(ro), ptr(rd),
           *map(_ptr_or_null, (t0, act)), *map(ptr, hit), _ptr_or_null(col),
           *_columns(scene, only_instance), R)
    LAUNCHES["intersect_dense"] += 1
    return hit, col


def needs_recompute(scene, ro, rd) -> bool:
    """Whether autograd needs the Hit's t/u/v as functions of the rays or
    the soup: then the wrapper recomputes them in torch from the kernel's
    winner, as svgf_tpu's wrapper does (intersect_pallas.py:582-612). The
    render path never differentiates a ray, so it takes the kernel's Hit."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (ro, rd, scene.world_tris9))


def bvh_select(scene, ro, rd, t0, act, only_instance=None, stats: bool = False):
    """Launch K6 on prepared rays (`_rays`); returns (best t, column,
    per-ray [nodes visited, triangles tested] (R, 2) i32 or None)."""
    tris, nodes = packed_scene(scene)
    R = ro.shape[0]
    t0 = start_dist(None, R, ro.device) if t0 is None else t0
    act = torch.ones((R,), dtype=torch.bool, device=ro.device) if act is None else act
    out_t = torch.empty((R,), dtype=torch.float32, device=ro.device)
    out_col = torch.empty((R,), dtype=torch.int32, device=ro.device)
    st = torch.empty((R, 2), dtype=torch.int32, device=ro.device) if stats else None
    launch(library().svgf_intersect_bvh, ro.device,
           *map(ptr, (nodes, tris, ro, rd, t0, act, out_t, out_col)),
           _ptr_or_null(st),
           nodes.shape[0], -1 if only_instance is None else int(only_instance), R)
    LAUNCHES["intersect_clustered"] += 1
    return out_t, out_col, st


def _scene_tensors(scene):
    return (scene.world_tris9, scene.world_tri_inst, scene.world_tri_prim, scene.world_tri_mat)


def intersect_dense_kernel(scene, ro, rd, active=None, tmax=None, only_instance=None):
    """K5 (csrc/intersect_dense.cu); plain version ops.intersect.intersect_dense.

    Replaces svgf_tpu/kernels/intersect_pallas.py intersect_dense_pallas.
    Bound by the FP32 rate at the Cornell box's 36 triangles: 55
    operations per ray-triangle test against 53 B of ray I/O. The block's
    active rays, compacted, sweep the soup staged through shared memory,
    and the kernel writes the Hit. A ray without a hit reports ids 0, as
    the TPU kernel does (the plain version reports the first column's prim
    and material). One launch a call; with `needs_recompute`, the same
    launch and the torch recompute of t/u/v from its winner."""
    extra = () if active is None else (active,)
    if on_cpu(ro, rd, *extra, *_scene_tensors(scene)):
        return intersect_dense(scene, ro, rd, active=active, tmax=tmax,
                               only_instance=only_instance)
    r = _rays(ro, rd, active, tmax)
    if not needs_recompute(scene, ro, rd):
        return dense_hit(scene, *r, only_instance)[0]
    _, col = dense_hit(scene, *r, only_instance, with_col=True)
    return hit_from_winner(scene, ro, rd, col, start_dist(tmax, ro.shape[0], ro.device), active)


def intersect_clustered_kernel(scene, ro, rd, active=None, tmax=None, only_instance=None):
    """K6 (csrc/intersect_clustered.cu); plain version
    ops.intersect.traverse_scene_bvh.

    Replaces svgf_tpu/kernels/intersect_pallas.py intersect_clustered_pallas.
    One thread per ray walks the skip-linked scene BVH (`wbvh_*`), which
    stays in L2; the node visits per ray bound it."""
    extra = () if active is None else (active,)
    if on_cpu(ro, rd, *extra, *_scene_tensors(scene), scene.wbvh_bounds6):
        return traverse_scene_bvh(scene, ro, rd, active=active, tmax=tmax,
                                  only_instance=only_instance)
    r = _rays(ro, rd, active, tmax)
    _, col, _ = bvh_select(scene, *r, only_instance)
    return hit_from_winner(scene, ro, rd, col, start_dist(tmax, ro.shape[0], ro.device), active)
