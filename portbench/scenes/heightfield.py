"""A procedural bumpy heightfield of (n - 1)^2 quads under a 1.5 x 1.5
quad area light 2.5 units up: 2 (n - 1)^2 + 2 triangles (n = 230: 104,884),
spatially coherent, with self-occluding ridges."""

from __future__ import annotations

import numpy as np


def make(n: int = 230, extent: float = 4.0) -> dict:
    u = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    xx, zz = np.meshgrid(u * extent, u * extent)
    yy = 0.35 * (np.sin(3.1 * xx) * np.cos(2.7 * zz)
                 + 0.5 * np.sin(9.3 * xx + 1.0) * np.sin(8.1 * zz + 2.0)
                 + 0.25 * np.cos(21.0 * xx + 0.3) * np.cos(19.0 * zz + 1.7)).astype(np.float32)
    pos = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.float32)
    i = np.arange(n * n).reshape(n, n)
    a, b, c, d = i[:-1, :-1].ravel(), i[:-1, 1:].ravel(), i[1:, 1:].ravel(), i[1:, :-1].ravel()
    idx = np.concatenate([np.stack([a, c, b], 1), np.stack([a, d, c], 1)]).astype(np.int32)
    uv = (pos[:, [0, 2]] / extent + 0.5).astype(np.float32)
    # the light: a unit quad in the xz plane, scaled by 1.5 and lifted
    plane = np.array([[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5], [-0.5, 0, 0.5]], np.float32)
    plane_idx = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    plane_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    light_t = np.eye(4, dtype=np.float32)
    light_t[1, 3] = 2.5
    light_t[0, 0] = light_t[2, 2] = 1.5
    return {
        "shapes": [{"positions": pos, "indices": idx, "uvs": uv},
                   {"positions": plane, "indices": plane_idx, "uvs": plane_uv}],
        "instances": [{"shape": 0, "material": 0, "transform": np.eye(4, dtype=np.float32),
                       "name": "terrain"},
                      {"shape": 1, "material": 1, "transform": light_t, "name": "light"}],
        "materials": [{"colour": (0.65, 0.62, 0.58), "emission": (0.0, 0.0, 0.0), "roughness": 0.8,
                       "type": "matte"},
                      {"colour": (0.0, 0.0, 0.0), "emission": (30.0, 30.0, 30.0), "roughness": 0.0,
                       "type": "matte"}],
        "camera": {"eye": (2.2, 1.6, 2.2), "target": (0.0, 0.0, 0.0), "fov": 55.0},
    }
