"""The reference's own flattening of a scene description (portbench.scenes):
per-triangle object-space positions and normals, the world-space soup, the
instance matrices, the materials, the light's area table and the camera
projection, worked out again from the description, never from the
program's arrays."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.intersect import make_intersector

NEAR, FAR = 0.001, 1000.0


def perspective(fov_deg: float, aspect: float) -> np.ndarray:
    """glm::perspective, row-major (clip = P @ view)."""
    t = np.tan(np.radians(fov_deg) / 2.0)
    p = np.zeros((4, 4), dtype=np.float64)
    p[0, 0] = 1.0 / (aspect * t)
    p[1, 1] = 1.0 / t
    p[2, 2] = -(FAR + NEAR) / (FAR - NEAR)
    p[2, 3] = -(2.0 * FAR * NEAR) / (FAR - NEAR)
    p[3, 2] = -1.0
    return p.astype(np.float32)


def vertex_normals(P: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Flat face normals scattered to the vertices (the last face written
    wins), as the renderer does for a mesh without normals."""
    N = np.zeros_like(P)
    v0, v1, v2 = P[F[:, 0]], P[F[:, 1]], P[F[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    N[F[:, 0]] = fn
    N[F[:, 1]] = fn
    N[F[:, 2]] = fn
    return N


class RefScene(NamedTuple):
    tri_pos: torch.Tensor         # (T, 3, 3) object space, global triangle ids
    tri_nrm: torch.Tensor         # (T, 3, 3)
    inst_transform: torch.Tensor  # (I, 4, 4)
    inst_normal: torch.Tensor     # (I, 4, 4) inverse transpose
    mat_colour: torch.Tensor      # (M, 3)
    mat_emission: torch.Tensor    # (M, 3)
    light_inst: int               # the one area light's instance
    light_tri_start: int          # its shape's first global triangle
    light_cdf: torch.Tensor       # (n,) cumulative world-space areas
    light_area: float
    proj: torch.Tensor            # (4, 4)
    intersect: object             # (ro, rd, active) -> Hit


def build(desc, width: int, height: int, device, transforms=None) -> RefScene:
    """The reference scene of `desc` on `device`. `transforms` maps an
    instance index to a 4x4 matrix that replaces its own (a scene edit)."""
    shapes, insts, mats = desc["shapes"], desc["instances"], desc["materials"]
    if any(m.get("type", "matte") != "matte" for m in mats):
        raise NotImplementedError("the reference shades matte materials only")
    tforms = [np.asarray((transforms or {}).get(i, inst["transform"]), np.float32)
              for i, inst in enumerate(insts)]
    tri_pos, tri_nrm, starts = [], [], []
    start = 0
    for s in shapes:
        P = np.asarray(s["positions"], np.float32)
        F = np.asarray(s["indices"], np.int64)
        tri_pos.append(P[F])
        tri_nrm.append(vertex_normals(P, F)[F])
        starts.append(start)
        start += F.shape[0]
    tri_pos_np = np.concatenate(tri_pos)

    soup, s_inst, s_prim, s_mat = [], [], [], []
    lights = []
    for i, (inst, t) in enumerate(zip(insts, tforms)):
        k = inst["shape"]
        p = tri_pos[k].astype(np.float64)
        t64 = t.astype(np.float64)
        pw = p @ t64[:3, :3].T + t64[:3, 3]
        soup.append(pw.reshape(-1, 9).T.astype(np.float32))
        n = pw.shape[0]
        s_inst.append(np.full(n, i, np.int32))
        s_prim.append(np.arange(n, dtype=np.int32) + starts[k])
        s_mat.append(np.full(n, inst["material"], np.int32))
        if any(e != 0.0 for e in mats[inst["material"]]["emission"]):
            e1, e2 = pw[:, 1] - pw[:, 0], pw[:, 2] - pw[:, 0]
            cdf = np.cumsum(0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1))
            lights.append((i, starts[k], cdf))
    if len(lights) != 1:
        raise NotImplementedError(f"the reference takes one area light, the scene has {len(lights)}")
    (light_inst, light_start, cdf), = lights

    f32 = lambda x: torch.as_tensor(np.ascontiguousarray(np.asarray(x, np.float32)), device=device)
    i32 = lambda x: torch.as_tensor(np.ascontiguousarray(np.asarray(x, np.int32)), device=device)
    world9 = f32(np.concatenate(soup, axis=1))
    inst_t = np.stack(tforms)
    cam = desc["camera"]
    return RefScene(
        tri_pos=f32(tri_pos_np),
        tri_nrm=f32(np.concatenate(tri_nrm)),
        inst_transform=f32(inst_t),
        # an edited instance's inverse is taken in float64, as the edit path does
        inst_normal=f32(np.stack([
            (np.linalg.inv(t.astype(np.float64)).astype(np.float32) if i in (transforms or {})
             else np.linalg.inv(t)).T for i, t in enumerate(inst_t)])),
        mat_colour=f32([m["colour"] for m in mats]),
        mat_emission=f32([m["emission"] for m in mats]),
        light_inst=light_inst,
        light_tri_start=light_start,
        light_cdf=f32(cdf.astype(np.float32)),
        light_area=float(np.float32(cdf[-1])),
        proj=f32(perspective(cam["fov"], width / height)),
        intersect=make_intersector(world9, i32(np.concatenate(s_inst)),
                                   i32(np.concatenate(s_prim)), i32(np.concatenate(s_mat))),
    )


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world frame looking down -Z toward `target`."""
    eye, target, up = (np.asarray(x, np.float64) for x in (eye, target, up))
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    frame = np.eye(4, dtype=np.float64)
    frame[:3, 0] = right
    frame[:3, 1] = np.cross(right, fwd)
    frame[:3, 2] = -fwd
    frame[:3, 3] = eye
    return frame.astype(np.float32)
