"""Minimal Wavefront OBJ loader (the reference uses Assimp for OBJ,
AssimpLoader.cpp:171-192, with triangulate + gen-normals + calc-tangents;
Shape.preprocess covers the latter two).

A copy of svgf_tpu/io/objloader.py over the port's host classes.
"""

from __future__ import annotations

import numpy as np

from svgf_tpu_torch.core.scene import Shape


def load_obj(path: str, name: str | None = None) -> Shape:
    positions: list = []
    normals: list = []
    uvs: list = []
    # corner -> (vi, ti, ni); we re-index to unified vertices
    corner_map: dict = {}
    out_pos, out_nrm, out_uv, faces = [], [], [], []
    has_n = has_t = False

    def corner(tok: str) -> int:
        nonlocal has_n, has_t
        if tok in corner_map:
            return corner_map[tok]
        parts = (tok + "//").split("/")[:3]
        vi = int(parts[0])
        ti = int(parts[1]) if parts[1] else 0
        ni = int(parts[2]) if parts[2] else 0
        idx = len(out_pos)
        out_pos.append(positions[vi - 1 if vi > 0 else vi])
        if ti:
            has_t = True
            out_uv.append(uvs[ti - 1 if ti > 0 else ti])
        else:
            out_uv.append((0.0, 0.0))
        if ni:
            has_n = True
            out_nrm.append(normals[ni - 1 if ni > 0 else ni])
        else:
            out_nrm.append((0.0, 0.0, 0.0))
        corner_map[tok] = idx
        return idx

    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                positions.append(tuple(float(x) for x in t[1:4]))
            elif t[0] == "vn":
                normals.append(tuple(float(x) for x in t[1:4]))
            elif t[0] == "vt":
                uvs.append(tuple(float(x) for x in t[1:3]))
            elif t[0] == "f":
                ids = [corner(tok) for tok in t[1:]]
                for k in range(1, len(ids) - 1):  # fan triangulation
                    faces.append((ids[0], ids[k], ids[k + 1]))

    return Shape(
        positions=np.asarray(out_pos, np.float32),
        indices=np.asarray(faces, np.int32),
        normals=np.asarray(out_nrm, np.float32) if has_n else None,
        uvs=np.asarray(out_uv, np.float32) if has_t else None,
        name=name or path.rsplit("/", 1)[-1],
    )
