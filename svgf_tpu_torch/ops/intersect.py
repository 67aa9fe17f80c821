"""Scene intersection (svgf_tpu/ops/intersect.py), plain torch.

Two intersectors, as in svgf_tpu, each with a hand-written CUDA kernel in
svgf_tpu_torch/kernels/intersect.py:

  * `intersect_dense` (`:200-268`): every ray against every real triangle
    of the world soup, for scenes of at most DENSE_MAX_TRIS triangles; its
    kernel replaces svgf_tpu/kernels/intersect_pallas.py
    `intersect_dense_pallas`;
  * `traverse_scene_bvh` (`:145-197`): the stackless skip-link walk of the
    stitched world-space scene BVH, for larger scenes; its kernel replaces
    `intersect_clustered_pallas`.

`intersect_scene` picks between them and the kernels (`:271-325`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svgf_tpu_torch.ops.geometry import (
    MAX_LENGTH, ray_aabb_comp, ray_triangle_comp, ray_triangle_comp_raw,
)

# Scenes whose world soup is at most this big use the dense intersector.
DENSE_MAX_TRIS = 16384

# Triangle columns per step of the closest-hit sweep: bounds the (R, 128)
# temporaries like the JAX chunk loop, and gives the same first-minimum
# winner (a later column wins only when strictly closer).
_TRI_CHUNK = 128


class Hit(NamedTuple):
    """Per-ray intersection record (reference sceneIntersection, Common.cuh:146-162)."""

    dist: torch.Tensor      # (R,) f32, MAX_LENGTH = miss
    u: torch.Tensor         # (R,) f32 barycentric
    v: torch.Tensor         # (R,) f32
    prim: torch.Tensor      # (R,) i32 global triangle id
    instance: torch.Tensor  # (R,) i32
    material: torch.Tensor  # (R,) i32

    def chunk(self, start: int, stop: int) -> "Hit":
        return Hit(*(x[start:stop] for x in self))


def start_dist(tmax, R: int, device) -> torch.Tensor:
    """(R,) f32 start distance of a search: `tmax` broadcast, else MAX_LENGTH."""
    if tmax is None:
        return torch.full((R,), MAX_LENGTH, dtype=torch.float32, device=device)
    return torch.broadcast_to(torch.as_tensor(tmax, dtype=torch.float32, device=device), (R,))


def _components(x):
    return (x[:, 0], x[:, 1], x[:, 2])


def hit_from_winner(scene, ro, rd, col, t0, active=None) -> Hit:
    """The Hit of a chosen soup column per ray (`col`, -1 = no hit before
    the start distance `t0`), as svgf_tpu's kernel wrappers build it
    (intersect_pallas.py:541-558, 602-623): the winner's vertices and ids
    are gathered, and t/u/v are recomputed UNMASKED in torch, so they stay
    differentiable with respect to the ray; the choice itself is constant.
    Lanes without a hit report dist = t0, u = v = 0 and ids 0; inactive
    lanes report dist = t0."""
    ok = col >= 0
    c = torch.clamp_min(col, 0).long()
    w = scene.world_tris9[:, c]                          # (9, R)
    t, u, v = ray_triangle_comp_raw(
        _components(ro), _components(rd), (w[0], w[1], w[2]), (w[3], w[4], w[5]),
        (w[6], w[7], w[8]),
    )
    zero = torch.zeros_like(col, dtype=torch.int32)
    dist = torch.where(ok, t, t0)
    return Hit(
        dist=dist if active is None else torch.where(active, dist, t0),
        u=torch.where(ok, u, 0.0),
        v=torch.where(ok, v, 0.0),
        prim=torch.where(ok, scene.world_tri_prim[c], zero),
        instance=torch.where(ok, scene.world_tri_inst[c], zero),
        material=torch.where(ok, scene.world_tri_mat[c], zero),
    )


# Walk steps between two checks that every lane has finished (each check
# waits for the device); a finished lane's step changes nothing.
_WALK_CHECK_EVERY = 16


@torch.no_grad()
def _walk_scene_bvh(scene, ro, rd, t0, active, only_instance, counts: bool = False,
                    any_hit: bool = False):
    """The skip-link walk; returns (best t, winning soup column or -1),
    and with `counts` also each lane's node visits and triangle tests.
    With `any_hit` a lane ends at the first hit it finds."""
    N = scene.wbvh_skip.shape[0]
    dev = ro.device
    roc, rdc = _components(ro), _components(rd)
    inv_rd = tuple(1.0 / d for d in rdc)
    node = torch.full((ro.shape[0],), N, dtype=torch.int64, device=dev)
    node = torch.where(active, 0, node) if active is not None else torch.zeros_like(node)
    tb = t0.clone()
    col = torch.full_like(node, -1)
    skip = scene.wbvh_skip.long()
    leaf = scene.wbvh_leaf_tri.long()
    visits = torch.zeros_like(node) if counts else None
    tests = torch.zeros_like(node) if counts else None
    step = 0
    while step % _WALK_CHECK_EVERY or bool((node < N).any()):
        step += 1
        live = node < N
        g = torch.clamp_max(node, N - 1)
        b = scene.wbvh_bounds6[:, g]                      # (6, R)
        t_box = ray_aabb_comp(roc, inv_rd, (b[0], b[1], b[2]), (b[3], b[4], b[5]), tb)
        box_hit = live & (t_box < MAX_LENGTH)
        leaf_tri = leaf[g]                                # soup column, -1 internal
        is_leaf = leaf_tri >= 0
        tri = torch.clamp_min(leaf_tri, 0)
        v = scene.world_tris9[:, tri]                     # (9, R)
        t, _, _, m = ray_triangle_comp(
            roc, rdc, (v[0], v[1], v[2]), (v[3], v[4], v[5]), (v[6], v[7], v[8])
        )
        tested = box_hit & is_leaf
        if only_instance is not None:
            tested = tested & (scene.world_tri_inst[tri] == only_instance)
        if counts:
            visits += live
            tests += tested
        closer = tested & m & (t < tb)
        tb = torch.where(closer, t, tb)
        col = torch.where(closer, tri, col)
        nxt = torch.where(box_hit & ~is_leaf, node + 1, skip[g])
        if any_hit:
            nxt = torch.where(closer, N, nxt)
        node = torch.where(live, nxt, node)
    return (tb, col, visits, tests) if counts else (tb, col)


def traverse_scene_bvh(scene, ro, rd, active=None, any_hit: bool = False, tmax=None,
                       only_instance=None) -> Hit:
    """Closest hit by the stitched scene-BVH walk (svgf_tpu
    traverse_scene_bvh, `:145-197`; reference IntersectTLAS,
    PathTrace.cuh:90-142): per ray one node index and the running best;
    at a node, a slab test against the best so far; on a hit descend (or
    test the leaf's soup triangle), else follow the skip link. A host loop
    of tensor steps until every lane is done; it is the plain version of
    the scene-BVH kernel (kernels/intersect.py).

    `only_instance` keeps the leaves of that instance alone (svgf_tpu walks
    that instance's BLAS instead; the hits are the same). With `any_hit` a
    lane ends at the first hit it finds (`:191`): a hit, not always the
    nearest. Inactive lanes and misses report the start distance and ids
    0, as svgf_tpu's Hit.none."""
    t0 = start_dist(tmax, ro.shape[0], ro.device)
    _, col = _walk_scene_bvh(scene, ro, rd, t0, active, only_instance, any_hit=any_hit)
    return hit_from_winner(scene, ro, rd, col, t0, active)


def intersect_dense(scene, ro, rd, active=None, any_hit: bool = False, tmax=None,
                    only_instance=None) -> Hit:
    """Closest hit of every ray against the world soup's real triangles
    (those of instance `only_instance` when given). Inactive lanes report
    dist = the start distance (MAX_LENGTH or `tmax`), as in svgf_tpu.
    `any_hit` is taken as closest-hit, as svgf_tpu's dense sweep does: the
    closest hit is a hit."""
    R = ro.shape[0]
    tw = scene.world_tris9.shape[1]
    if only_instance is not None:
        c0, count = scene.meta.inst_world_range[only_instance]
        c1 = c0 + count
    else:
        c0, c1 = 0, scene.meta.n_world_tris
    roc = tuple(ro[:, k : k + 1] for k in range(3))   # (R, 1) each
    rdc = tuple(rd[:, k : k + 1] for k in range(3))

    t0 = start_dist(tmax, R, ro.device)
    tb, ub, vb = t0, torch.zeros_like(t0), torch.zeros_like(t0)
    ib = torch.zeros((R,), dtype=torch.int64, device=ro.device)
    for off in range(c0, c1, _TRI_CHUNK):
        end = min(off + _TRI_CHUNK, c1)
        v = scene.world_tris9[:, off:end]
        row = lambda k: v[k][None, :]                   # (1, T)
        t, u, vv, m = ray_triangle_comp(
            roc, rdc,
            (row(0), row(1), row(2)), (row(3), row(4), row(5)), (row(6), row(7), row(8)),
        )                                                # (R, T)
        if only_instance is not None:
            m = m & (scene.world_tri_inst[off:end] == only_instance)[None, :]
        t = torch.where(m, t, MAX_LENGTH)
        j = torch.argmin(t, dim=-1, keepdim=True)        # first minimum
        tc = torch.gather(t, 1, j)[:, 0]
        closer = tc < tb
        tb = torch.where(closer, tc, tb)
        ub = torch.where(closer, torch.gather(u, 1, j)[:, 0], ub)
        vb = torch.where(closer, torch.gather(vv, 1, j)[:, 0], vb)
        ib = torch.where(closer, off + j[:, 0], ib)
    ok = tb < t0
    ib = torch.clamp(ib, 0, tw - 1)
    inst = scene.world_tri_inst[ib]
    return Hit(
        dist=tb if active is None else torch.where(active, tb, t0),
        u=ub,
        v=vb,
        prim=scene.world_tri_prim[ib],
        instance=torch.where(ok, inst, torch.zeros_like(inst)),
        material=scene.world_tri_mat[ib],
    )


def intersect_scene(scene, ro, rd, mode: str, active=None, any_hit: bool = False, tmax=None,
                    only_instance=None) -> Hit:
    """Closest-hit (or any-hit) intersection of world-space rays (R, 3)
    with the scene. `any_hit`: the plain scene-BVH walk ends a lane at its
    first hit; the dense sweep and both kernels take it as closest-hit, as
    svgf_tpu's kernels do (intersect_pallas.py:493-498). Either way a lane
    hits iff its closest hit exists.

    `mode` is the intersector's kernel policy (RenderConfig
    `use_pallas_intersect`, else `use_pallas`), resolved by
    `kernels.resolve_kernels` for the rays' device; svgf_tpu keeps it in
    module state (`_PALLAS_MODE`), here it is an argument. As in svgf_tpu:
    scenes of at most DENSE_MAX_TRIS world triangles take the dense
    intersector; larger ones (BLAS-leaf-ordered soup) the scene-BVH walk.
    svgf_tpu's clustered kernel holds the cluster bounds in VMEM and so
    stops at 8,192 clusters; the port's kernel walks the scene BVH per
    thread and has no such ceiling."""
    from svgf_tpu_torch.kernels import resolve_kernels

    on = resolve_kernels(mode, ro.device)
    n = scene.meta.n_world_tris
    if 0 < n <= DENSE_MAX_TRIS:
        if on:
            from svgf_tpu_torch.kernels.intersect import intersect_dense_kernel

            return intersect_dense_kernel(scene, ro, rd, active=active, any_hit=any_hit,
                                          tmax=tmax, only_instance=only_instance)
        return intersect_dense(scene, ro, rd, active=active, any_hit=any_hit, tmax=tmax,
                               only_instance=only_instance)
    if not scene.meta.soup_leaf_order:
        raise NotImplementedError(f"{n} world triangles: no intersector for an empty scene")
    if on:
        from svgf_tpu_torch.kernels.intersect import intersect_clustered_kernel

        return intersect_clustered_kernel(scene, ro, rd, active=active, any_hit=any_hit,
                                          tmax=tmax, only_instance=only_instance)
    return traverse_scene_bvh(scene, ro, rd, active=active, any_hit=any_hit, tmax=tmax,
                              only_instance=only_instance)
