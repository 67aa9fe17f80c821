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

`intersect_scene` picks between them and the kernels (`:271-354`); off the
kernel route a large scene's `only_instance` call walks that instance's
own BLAS in object space (`traverse_shape`, `:67-130`), as svgf_tpu's does.
`intersect_brute_force` (`:357-397`) tests every triangle of every
instance: the tests' oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svgf_tpu_torch.ops.geometry import (
    MAX_LENGTH, components, ray_aabb_comp, ray_triangle_comp, ray_triangle_comp_raw,
    transform_point, transform_point3, transform_vector, transform_vector3,
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

    @staticmethod
    def none(shape, device="cuda") -> "Hit":
        """No hit on any lane: MAX_LENGTH distances, zero u/v and ids."""
        z = torch.zeros(shape, dtype=torch.int32, device=device)
        return Hit(
            dist=torch.full(shape, MAX_LENGTH, dtype=torch.float32, device=device),
            u=torch.zeros(shape, dtype=torch.float32, device=device),
            v=torch.zeros(shape, dtype=torch.float32, device=device),
            prim=z,
            instance=z,
            material=z,
        )

    @property
    def valid(self) -> torch.Tensor:
        return self.dist < MAX_LENGTH

    def chunk(self, start: int, stop: int) -> "Hit":
        return Hit(*(x[start:stop] for x in self))


def start_dist(tmax, R: int, device) -> torch.Tensor:
    """(R,) f32 start distance of a search: `tmax` broadcast, else MAX_LENGTH."""
    if tmax is None:
        return torch.full((R,), MAX_LENGTH, dtype=torch.float32, device=device)
    return torch.broadcast_to(torch.as_tensor(tmax, dtype=torch.float32, device=device), (R,))


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
        components(ro), components(rd), (w[0], w[1], w[2]), (w[3], w[4], w[5]),
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
    roc, rdc = components(ro), components(rd)
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

    `only_instance` keeps the leaves of that instance alone, as K6 does
    (intersect_scene's plain route walks that instance's BLAS instead,
    `traverse_shape`, as svgf_tpu does; the hits are the same, t/u/v
    round otherwise). With `any_hit` a
    lane ends at the first hit it finds (`:191`): a hit, not always the
    nearest. Inactive lanes and misses report the start distance and ids
    0, as svgf_tpu's Hit.none."""
    t0 = start_dist(tmax, ro.shape[0], ro.device)
    _, col = _walk_scene_bvh(scene, ro, rd, t0, active, only_instance, any_hit=any_hit)
    return hit_from_winner(scene, ro, rd, col, t0, active)


@torch.no_grad()
def _walk_shape(scene, shape_id: int, ro, rd, t0, active, any_hit: bool = False):
    """The skip-link walk of shape `shape_id`'s BLAS (its nodes
    shape_node_start .. + shape_node_count of `bvh_*`, skip links local to
    them) on object-space component rays; returns (best t, the winning
    global triangle or -1). Lanes not `active` do not walk."""
    start = int(scene.shape_node_start[shape_id])
    n = int(scene.shape_node_count[shape_id])
    b6 = scene.bvh_bounds6[:, start : start + n]
    skip = scene.bvh_skip[start : start + n].long()
    leaf = scene.bvh_leaf_tri[start : start + n].long()
    inv_rd = tuple(1.0 / d for d in rd)
    node = torch.where(active, 0, n).long()
    tb = t0.clone()
    best = torch.full_like(node, -1)
    step = 0
    while step % _WALK_CHECK_EVERY or bool((node < n).any()):
        step += 1
        live = node < n
        g = torch.clamp_max(node, n - 1)
        b = b6[:, g]                                      # (6, R)
        t_box = ray_aabb_comp(ro, inv_rd, (b[0], b[1], b[2]), (b[3], b[4], b[5]), tb)
        box_hit = live & (t_box < MAX_LENGTH)
        leaf_tri = leaf[g]                                # global triangle, -1 internal
        is_leaf = leaf_tri >= 0
        tri = torch.clamp_min(leaf_tri, 0)
        v = scene.tri_verts9[:, tri]                      # (9, R)
        t, _, _, m = ray_triangle_comp(
            ro, rd, (v[0], v[1], v[2]), (v[3], v[4], v[5]), (v[6], v[7], v[8])
        )
        closer = box_hit & is_leaf & m & (t < tb)
        tb = torch.where(closer, t, tb)
        best = torch.where(closer, tri, best)
        nxt = torch.where(box_hit & ~is_leaf, node + 1, skip[g])
        if any_hit:
            nxt = torch.where(closer, n, nxt)
        node = torch.where(live, nxt, node)
    return tb, best


def traverse_shape(scene, shape_id: int, ro, rd, hit: Hit, instance_id: int, material_id: int,
                   active, any_hit: bool = False) -> Hit:
    """Threaded-BVH walk of one shape for a batch of object-space rays
    (svgf_tpu traverse_shape, `:67-130`): ro / rd are component tuples of
    (R,) tensors, rd not normalized, so t stays in world units and
    compares across instances. A lane takes this shape's triangle where it
    is nearer than `hit.dist`; lanes not `active` keep `hit`. With
    `any_hit` a lane ends at the first hit it finds.

    The walk picks each lane's winner without autograd; t/u/v are then
    recomputed from the winner in object space (`ray_triangle_comp_raw`),
    the values svgf_tpu's walk records, differentiable with respect to
    the rays and the triangles, as the port's other routes are."""
    _, tri = _walk_shape(scene, shape_id, ro, rd, hit.dist.detach(), active, any_hit)
    won = tri >= 0
    c = torch.clamp_min(tri, 0)
    w = scene.tri_verts9[:, c]                            # (9, R)
    t, u, v = ray_triangle_comp_raw(ro, rd, (w[0], w[1], w[2]), (w[3], w[4], w[5]),
                                    (w[6], w[7], w[8]))
    return Hit(
        dist=torch.where(won, t, hit.dist),
        u=torch.where(won, u, hit.u),
        v=torch.where(won, v, hit.v),
        prim=torch.where(won, c.to(torch.int32), hit.prim),
        instance=torch.where(won, instance_id, hit.instance),
        material=torch.where(won, material_id, hit.material),
    )


def intersect_instances(scene, ro, rd, active=None, any_hit: bool = False, tmax=None,
                        only_instance=None) -> Hit:
    """Closest hit by a walk of each instance's BLAS in object space
    (svgf_tpu intersect_scene's instance loop, `:322-354`), or of instance
    `only_instance` alone: rays that miss an instance's world box skip its
    walk; the others are taken to object space by its inverse transform."""
    R, dev = ro.shape[0], ro.device
    hit = Hit.none((R,), dev)._replace(dist=start_dist(tmax, R, dev))
    if active is None:
        active = torch.ones((R,), dtype=torch.bool, device=dev)
    roc, rdc = components(ro), components(rd)
    inv_rd = tuple(1.0 / d for d in rdc)
    ids = range(scene.inst_shape.shape[0]) if only_instance is None else (int(only_instance),)
    for i in ids:
        lo, hi = scene.inst_aabb_min[i], scene.inst_aabb_max[i]
        t_box = ray_aabb_comp(roc, inv_rd, (lo[0], lo[1], lo[2]), (hi[0], hi[1], hi[2]),
                              hit.dist.detach())
        inv = scene.inst_inv_transform[i]
        hit = traverse_shape(scene, int(scene.inst_shape[i]), transform_point3(inv, roc),
                             transform_vector3(inv, rdc), hit, i, int(scene.inst_material[i]),
                             active & (t_box < MAX_LENGTH), any_hit=any_hit)
    return hit


# Triangles a step of the brute-force sweep tests against every ray: (R, 2048)
# temporaries, ~1 GB at 4,096 rays.
_BRUTE_CHUNK = 2048


def intersect_brute_force(scene, ro, rd) -> Hit:
    """Reference-check intersector (svgf_tpu intersect_brute_force,
    `:357-397`): every triangle of every instance in object space, O(rays x
    triangles). A later triangle wins only when strictly nearer, so the
    winner is svgf_tpu's first minimum; prim is the global triangle id."""
    R, dev = ro.shape[0], ro.device
    hit = Hit.none((R,), dev)
    for i in range(scene.inst_shape.shape[0]):
        inv = scene.inst_inv_transform[i]
        ro_o, rd_o = transform_point(inv, ro), transform_vector(inv, rd)
        roc = tuple(ro_o[:, k : k + 1] for k in range(3))    # (R, 1) each
        rdc = tuple(rd_o[:, k : k + 1] for k in range(3))
        s = int(scene.inst_shape[i])
        t_start, t_count = int(scene.shape_tri_start[s]), int(scene.shape_tri_count[s])
        for off in range(t_start, t_start + t_count, _BRUTE_CHUNK):
            w = scene.tri_verts9[:, off : min(off + _BRUTE_CHUNK, t_start + t_count)]
            row = lambda k: w[k][None, :]                      # (1, C)
            t, u, v, m = ray_triangle_comp(
                roc, rdc, (row(0), row(1), row(2)), (row(3), row(4), row(5)),
                (row(6), row(7), row(8)),
            )                                                  # (R, C)
            t = torch.where(m, t, MAX_LENGTH)
            j = torch.argmin(t, dim=-1, keepdim=True)          # first minimum
            tc = torch.gather(t, 1, j)[:, 0]
            closer = tc < hit.dist
            hit = Hit(
                dist=torch.where(closer, tc, hit.dist),
                u=torch.where(closer, torch.gather(u, 1, j)[:, 0], hit.u),
                v=torch.where(closer, torch.gather(v, 1, j)[:, 0], hit.v),
                prim=torch.where(closer, (off + j[:, 0]).to(torch.int32), hit.prim),
                instance=torch.where(closer, i, hit.instance),
                material=torch.where(closer, int(scene.inst_material[i]), hit.material),
            )
    return hit


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
    thread and has no such ceiling. Off the kernel route a large scene's
    `only_instance` call walks that instance's BLAS (`intersect_instances`),
    as svgf_tpu's off its clustered kernel; K6 keeps that instance's leaves
    of the scene BVH, as svgf_tpu's clustered kernel keeps its soup
    columns."""
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
    if only_instance is not None:
        return intersect_instances(scene, ro, rd, active=active, any_hit=any_hit, tmax=tmax,
                                   only_instance=only_instance)
    return traverse_scene_bvh(scene, ro, rd, active=active, any_hit=any_hit, tmax=tmax)
