"""Wrappers of the two intersector kernels (svgf_tpu_torch/csrc).

| wrapper                    | kernel                      | replaces (svgf_tpu/kernels/intersect_pallas.py) |
|----------------------------|-----------------------------|-------------------------------------------------|
| intersect_dense_kernel     | csrc/intersect_dense.cu     | intersect_dense_pallas (:561)                   |
| intersect_clustered_kernel | csrc/intersect_clustered.cu | intersect_clustered_pallas (:489)               |

Each takes the arguments of its plain version (ops/intersect.py
intersect_dense, traverse_scene_bvh) and returns a Hit. Given CPU tensors
it runs the plain version; given CUDA tensors it launches its kernel on
the current stream, or raises; it never falls back. Each kernel writes the
whole Hit in its one launch. When autograd needs t/u/v as functions of the
ray or the soup (`needs_recompute`), it also writes the winning soup
column, and `hit_from_winner` gathers the winner and recomputes t/u/v in
torch, as svgf_tpu's wrapper does to keep them differentiable.

The kernels read the soup packed once per scene into 16-byte records, and
K6 the scene BVH repacked once into child-pair records (`packed_scene`),
kept on the device for the last few scenes packed; an entry holds its
source tensors too.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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


# entries of csrc/intersect_clustered.cu's per-thread stack (kStack); a
# deeper scene BVH spills the entries past it to a global scratch
BVH_STACK = 64


def spill_entries(depth: int) -> int:
    """The scratch entries a ray K6 needs past its stack for a scene BVH
    of `depth`: 0 where the stack holds the depth."""
    return max(depth - BVH_STACK, 0)


class ChildPairBVH(NamedTuple):
    """The scene BVH as K6 walks it. nodes (M + 1, 16) f32: per internal
    node of the skip-linked tree (M of them, in its order) one record
    [lo0.xyz, ref0 | hi0.xyz, ref1 | lo1.xyz, 0 | hi1.xyz, 0] of its two
    children's boxes and references (a record index >= 1, or ~column for
    a leaf's soup column); record 0 holds the root as its first child and
    an empty NaN box, which no ray hits, as its second. depth: internal
    nodes on the longest root-to-leaf path, the most entries the walk's
    stack can hold (`spill_entries`)."""

    nodes: torch.Tensor
    depth: int


def child_pair_bvh(scene) -> ChildPairBVH:
    """Repack the skip-linked scene BVH (`wbvh_*`: DFS order, a node's
    left child at i + 1, its right child at the left child's skip link)
    into child-pair records; see ChildPairBVH."""
    skip, leaf, b6 = scene.wbvh_skip.long(), scene.wbvh_leaf_tri.long(), scene.wbvh_bounds6
    n, dev = skip.shape[0], skip.device
    inner = torch.nonzero(leaf < 0).flatten()           # internal nodes, the root first
    left = inner + 1
    # children after their parent: a walk's record index only grows as it descends
    if bool((left >= n).any()) or bool((skip[left] >= n).any()) or bool((skip[left] <= left).any()):
        raise ValueError("the scene BVH is not a binary tree of one-triangle leaves")
    right = skip[left]
    rec = torch.zeros((n,), dtype=torch.long, device=dev)
    rec[inner] = torch.arange(1, inner.numel() + 1, device=dev)
    ref = torch.where(leaf >= 0, ~leaf, rec)            # each node as a child
    root = torch.zeros((1,), dtype=torch.long, device=dev)
    c0, c1 = torch.cat([root, left]), torch.cat([root, right])
    box1 = b6[:, c1].clone()
    box1[:, 0] = float("nan")                           # record 0's empty child
    bits = lambda r: r.to(torch.int32).view(torch.float32)[None]
    zero = torch.zeros((1, c0.numel()), device=dev)
    nodes = torch.cat([b6[0:3, c0], bits(ref[c0]), b6[3:6, c0], bits(ref[c1]),
                       box1[0:3], zero, box1[3:6], zero]).T.contiguous()
    depth, frontier = 0, inner[:1]
    while frontier.numel():
        depth += 1
        kids = torch.cat([frontier + 1, skip[frontier + 1]])
        frontier = kids[leaf[kids] < 0]
    return ChildPairBVH(nodes, depth)


def packed_scene(scene):
    """(tris (T, 12) f32, the ChildPairBVH or None without a scene BVH) on
    the scene's device.

    tris: per soup column [v0.xyz, instance id bits | e1.xyz, prim id bits |
    e2.xyz, material id bits] with e1 = v1 - v0, e2 = v2 - v0."""
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
        bvh = child_pair_bvh(scene) if scene.meta.has_scene_bvh else None
        if len(_PACKED) >= _PACKED_MAX:
            _PACKED.clear()
        entry = _PACKED[key] = (src, versions, tris, bvh)
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


def _empty_hit(R: int, dev, with_col: bool):
    """Uninitialised outputs of a kernel: the Hit, and the winning column
    when `with_col`."""
    f32 = lambda: torch.empty((R,), dtype=torch.float32, device=dev)
    i32 = lambda: torch.empty((R,), dtype=torch.int32, device=dev)
    hit = Hit(dist=f32(), u=f32(), v=f32(), prim=i32(), instance=i32(), material=i32())
    return hit, i32() if with_col else None


def dense_hit(scene, ro, rd, t0, act, only_instance=None, with_col: bool = False):
    """Launch K5 on prepared rays (`_rays`); returns (the Hit, the winning
    column (R,) i32 with -1 for none, or None unless `with_col`)."""
    tris, _ = packed_scene(scene)
    R, dev = ro.shape[0], ro.device
    hit, col = _empty_hit(R, dev, with_col)
    launch(library().svgf_intersect_dense, dev, ptr(tris), ptr(ro), ptr(rd),
           *map(_ptr_or_null, (t0, act)), *map(ptr, hit), _ptr_or_null(col),
           *_columns(scene, only_instance), R)
    LAUNCHES["intersect_dense"] += 1
    return hit, col


def bvh_hit(scene, ro, rd, t0, act, only_instance=None, with_col: bool = False,
            stats: bool = False):
    """Launch K6 on prepared rays (`_rays`); returns (the Hit, the winning
    column as dense_hit's, per-ray [records visited, triangles tested]
    (R, 2) i32 or None unless `stats`). Raises for a scene without a scene
    BVH. A tree deeper than the kernel's stack gets a scratch of
    `spill_entries(depth)` entries a ray."""
    tris, bvh = packed_scene(scene)
    if bvh is None:
        raise ValueError("the scene has no scene BVH: K6 takes scenes over DENSE_MAX_TRIS")
    extra = spill_entries(bvh.depth)
    R, dev = ro.shape[0], ro.device
    hit, col = _empty_hit(R, dev, with_col)
    st = torch.empty((R, 2), dtype=torch.int32, device=dev) if stats else None
    spill = torch.empty((extra, R, 2), dtype=torch.int32, device=dev) if extra else None
    launch(library().svgf_intersect_bvh, dev, ptr(bvh.nodes), ptr(tris), ptr(ro), ptr(rd),
           *map(_ptr_or_null, (t0, act)), *map(ptr, hit), *map(_ptr_or_null, (col, st)),
           -1 if only_instance is None else int(only_instance), R, _ptr_or_null(spill))
    LAUNCHES["intersect_clustered"] += 1
    return hit, col, st


def needs_recompute(scene, ro, rd) -> bool:
    """Whether autograd needs the Hit's t/u/v as functions of the rays or
    the soup: then the wrapper recomputes them in torch from the kernel's
    winner, as svgf_tpu's wrapper does (intersect_pallas.py:582-612). The
    render path never differentiates a ray, so it takes the kernel's Hit."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (ro, rd, scene.world_tris9))


def _kernel_hit(select, scene, ro, rd, active, tmax, only_instance) -> Hit:
    """The Hit through `select` (dense_hit or bvh_hit): the kernel's own,
    or with `needs_recompute` the torch recompute of its winner."""
    r = _rays(ro, rd, active, tmax)
    if not needs_recompute(scene, ro, rd):
        return select(scene, *r, only_instance)[0]
    col = select(scene, *r, only_instance, with_col=True)[1]
    return hit_from_winner(scene, ro, rd, col, start_dist(tmax, ro.shape[0], ro.device), active)


def _scene_tensors(scene):
    return (scene.world_tris9, scene.world_tri_inst, scene.world_tri_prim, scene.world_tri_mat)


def intersect_dense_kernel(scene, ro, rd, active=None, any_hit: bool = False, tmax=None,
                           only_instance=None):
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
    return _kernel_hit(dense_hit, scene, ro, rd, active, tmax, only_instance)


def intersect_clustered_kernel(scene, ro, rd, active=None, any_hit: bool = False, tmax=None,
                               only_instance=None):
    """K6 (csrc/intersect_clustered.cu); plain version
    ops.intersect.traverse_scene_bvh.

    Replaces svgf_tpu/kernels/intersect_pallas.py intersect_clustered_pallas.
    One thread per ray walks the scene BVH nearest child first over its
    child-pair records (`packed_scene`), which stay in L2, and writes the
    Hit; its visits per ray bound it. A ray without a hit reports ids 0.
    One launch a call; with `needs_recompute`, the same launch and the
    torch recompute of t/u/v from its winner. The kernel takes `any_hit` as
    closest-hit, as svgf_tpu's does (intersect_pallas.py:493-498); on CPU
    tensors the plain walk ends a lane at its first hit."""
    extra = () if active is None else (active,)
    if on_cpu(ro, rd, *extra, *_scene_tensors(scene), scene.wbvh_bounds6):
        return traverse_scene_bvh(scene, ro, rd, active=active, any_hit=any_hit, tmax=tmax,
                                  only_instance=only_instance)
    return _kernel_hit(bvh_hit, scene, ro, rd, active, tmax, only_instance)
