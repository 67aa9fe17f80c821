"""The Cornell box in [-1, 1]^3: white floor, ceiling and back wall, red
left and green right walls, a 0.7 x 0.7 area light under the ceiling and
two rotated blocks; 36 triangles in 6 instances, one shape each."""

from __future__ import annotations

import numpy as np


def _quad(p0, p1, p2, p3):
    return np.asarray([p0, p1, p2, p3], np.float32), np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)


def _merge(parts):
    pos, idx, off = [], [], 0
    for p, i in parts:
        pos.append(p)
        idx.append(i + off)
        off += p.shape[0]
    return np.concatenate(pos), np.concatenate(idx)


def _block(cx, cz, hx, hy, hz, rot_deg, s=1.0):
    c, si = np.cos(np.radians(rot_deg)), np.sin(np.radians(rot_deg))
    rot = np.array([[c, 0, si], [0, 1, 0], [-si, 0, c]])
    corners = np.array([[dx * hx, dy * hy, dz * hz] for dy in (0, 2) for dx in (-1, 1)
                        for dz in (-1, 1)])
    corners = corners @ rot.T + np.array([cx, -s, cz])
    faces = ((0, 1, 3, 2), (4, 6, 7, 5), (0, 2, 6, 4), (1, 5, 7, 3), (0, 4, 5, 1), (2, 3, 7, 6))
    return _merge([_quad(*(corners[k] for k in f)) for f in faces])


def make() -> dict:
    s, l = 1.0, 0.35
    floor = _quad([-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s])
    ceil = _quad([-s, s, -s], [-s, s, s], [s, s, s], [s, s, -s])
    back = _quad([-s, -s, -s], [-s, s, -s], [s, s, -s], [s, -s, -s])
    left = _quad([-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s])
    right = _quad([s, -s, -s], [s, s, -s], [s, s, s], [s, -s, s])
    light = _quad([-l, s - 1e-3, -l], [-l, s - 1e-3, l], [l, s - 1e-3, l], [l, s - 1e-3, -l])
    meshes = [_merge([floor, ceil, back]), left, right, light,
              _block(-0.35, -0.3, 0.3, 1.2 / 2, 0.3, 18), _block(0.4, 0.35, 0.28, 0.6 / 2, 0.28, -17)]
    white = {"colour": (0.725, 0.71, 0.68), "emission": (0.0, 0.0, 0.0)}
    materials = [white,
                 {"colour": (0.63, 0.065, 0.05), "emission": (0.0, 0.0, 0.0)},
                 {"colour": (0.14, 0.45, 0.091), "emission": (0.0, 0.0, 0.0)},
                 {"colour": (0.0, 0.0, 0.0), "emission": (17.0, 12.0, 4.0)}]
    names = ("walls", "left", "right", "light", "block0", "block1")
    inst_mat = (0, 1, 2, 3, 0, 0)
    return {
        "shapes": [{"positions": p.astype(np.float32), "indices": i.astype(np.int32), "uvs": None}
                   for p, i in meshes],
        "instances": [{"shape": k, "material": m, "transform": np.eye(4, dtype=np.float32), "name": n}
                      for k, (m, n) in enumerate(zip(inst_mat, names))],
        "materials": [{**m, "roughness": 0.0, "type": "matte"} for m in materials],
        "camera": {"eye": (0.0, 0.0, 3.4), "target": (0.0, 0.0, 0.0), "fov": 40.0},
    }
