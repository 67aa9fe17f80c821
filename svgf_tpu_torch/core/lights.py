"""Emissive-light discovery + CDF construction (reference Tracing.cpp:93-161).

A NumPy copy of svgf_tpu/core/lights.py: that package's
`core/__init__.py` imports `core/scene.py`, which imports JAX.

Scans instances for emissive materials and builds a per-light cumulative
triangle-area CDF (areas measured on *world-space* (instance-transformed)
triangles). Environment lights with an emission texture get a per-pixel
luminance*sin(theta) CDF over the equirect map.
"""

from __future__ import annotations

import dataclasses

import numpy as np

INVALID_ID = -1


@dataclasses.dataclass
class LightsData:
    instance: np.ndarray    # (L,) i32
    environment: np.ndarray # (L,) i32
    cdf_start: np.ndarray   # (L,) i32
    cdf_count: np.ndarray   # (L,) i32
    cdf: np.ndarray         # (C,) f32
    total: np.ndarray       # (L,) f32 — last CDF entry per light (total area)


def build_lights(scene) -> LightsData:
    instance, environment, starts, counts, totals = [], [], [], [], []
    cdfs: list[np.ndarray] = []
    cursor = 0

    for i, inst in enumerate(scene.instances):
        mat = scene.materials[inst.material]
        if tuple(mat.emission) == (0.0, 0.0, 0.0):
            continue
        shape = scene.shapes[inst.shape]
        if shape.n_triangles == 0:
            continue
        # world-space triangle areas (Tracing.cpp:120-131)
        t = np.asarray(inst.transform, np.float64)
        p = shape.tri_pos.astype(np.float64)  # (F,3,3)
        pw = p @ t[:3, :3].T + t[:3, 3]
        e1 = pw[:, 1] - pw[:, 0]
        e2 = pw[:, 2] - pw[:, 0]
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        cdf = np.cumsum(area)
        instance.append(i)
        environment.append(INVALID_ID)
        starts.append(cursor)
        counts.append(cdf.shape[0])
        totals.append(cdf[-1])
        cdfs.append(cdf)
        cursor += cdf.shape[0]

    for e, env in enumerate(scene.environments):
        if tuple(env.emission) == (0.0, 0.0, 0.0):
            continue
        instance.append(INVALID_ID)
        environment.append(e)
        if env.emission_texture != INVALID_ID:
            tex = np.asarray(scene.env_textures[env.emission_texture], np.float64)
            h, w = tex.shape[:2]
            theta = (np.arange(h) + 0.5) * np.pi / h
            weight = tex[..., :3].max(axis=-1) * np.sin(theta)[:, None]  # (h, w)
            cdf = np.cumsum(weight.reshape(-1))
            starts.append(cursor)
            counts.append(cdf.shape[0])
            totals.append(cdf[-1])
            cdfs.append(cdf)
            cursor += cdf.shape[0]
        else:
            starts.append(cursor)
            counts.append(0)
            totals.append(0.0)

    if not cdfs:
        cdfs = [np.zeros((1,), np.float64)]  # placeholder, never indexed
    return LightsData(
        instance=np.asarray(instance, np.int32),
        environment=np.asarray(environment, np.int32),
        cdf_start=np.asarray(starts, np.int32),
        cdf_count=np.asarray(counts, np.int32),
        cdf=np.concatenate(cdfs).astype(np.float32),
        total=np.asarray(totals, np.float32),
    )
