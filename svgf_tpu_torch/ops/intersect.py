"""Scene intersection (svgf_tpu/ops/intersect.py): the dense intersector
against the pre-transformed world triangle soup.

This is the plain torch counterpart of the XLA `intersect_dense`
(`:200-268`). Its hand-written kernel (svgf_tpu/kernels/intersect_pallas.py
`intersect_dense_pallas`) is ported in a later change, as are the BVH walks
for scenes over DENSE_MAX_TRIS: both raise NotImplementedError here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svgf_tpu_torch.ops.geometry import MAX_LENGTH, ray_triangle_comp

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


def intersect_dense(scene, ro, rd, active=None, tmax=None, only_instance=None) -> Hit:
    """Closest hit of every ray against the world soup's real triangles
    (those of instance `only_instance` when given). Inactive lanes report
    dist = the start distance (MAX_LENGTH or `tmax`), as in svgf_tpu."""
    R = ro.shape[0]
    tw = scene.world_tris9.shape[1]
    if only_instance is not None:
        c0, count = scene.meta.inst_world_range[only_instance]
        c1 = c0 + count
    else:
        c0, c1 = 0, scene.meta.n_world_tris
    roc = tuple(ro[:, k : k + 1] for k in range(3))   # (R, 1) each
    rdc = tuple(rd[:, k : k + 1] for k in range(3))

    if tmax is not None:
        t0 = torch.broadcast_to(torch.as_tensor(tmax, dtype=torch.float32, device=ro.device), (R,))
    else:
        t0 = torch.full((R,), MAX_LENGTH, dtype=torch.float32, device=ro.device)
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


def intersect_scene(scene, ro, rd, mode: str, active=None, tmax=None,
                    only_instance=None) -> Hit:
    """Closest-hit intersection of world-space rays (R, 3) with the scene.

    `mode` is the intersector's kernel policy (RenderConfig
    `use_pallas_intersect`, else `use_pallas`), resolved by
    `kernels.resolve_kernels` for the rays' device. svgf_tpu keeps this
    policy in module state (`_PALLAS_MODE`); here it is an argument."""
    from svgf_tpu_torch.kernels import resolve_kernels

    n = scene.meta.n_world_tris
    if not 0 < n <= DENSE_MAX_TRIS:
        raise NotImplementedError(
            f"{n} world triangles: only the dense intersector (1..{DENSE_MAX_TRIS}) "
            "is ported to svgf_tpu_torch yet"
        )
    if resolve_kernels(mode, ro.device):
        raise NotImplementedError(
            "the dense intersector kernel (svgf_tpu/kernels/intersect_pallas.py "
            "intersect_dense_pallas) is not ported yet; set "
            "use_pallas_intersect='off' to run the plain torch intersector"
        )
    return intersect_dense(scene, ro, rd, active=active, tmax=tmax,
                           only_instance=only_instance)
