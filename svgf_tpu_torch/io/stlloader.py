"""STL loader (ascii + binary) and OFF loader.

Part of the Assimp-breadth import surface (reference AssimpLoader.cpp:171-192
loads any Assimp format); STL carries no shared vertices or UVs, so vertices
are welded by exact position to give Shape.preprocess meaningful adjacency
for its generated normals.

A copy of svgf_tpu/io/stlloader.py over the port's host classes.
"""

from __future__ import annotations

import os

import numpy as np

from svgf_tpu_torch.core.scene import Shape


def _weld(tris: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(F, 3, 3) corner soup -> (V, 3) positions + (F, 3) indices (exact
    position weld, like Assimp's JoinIdenticalVertices)."""
    flat = tris.reshape(-1, 3)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    return uniq.astype(np.float32), inv.reshape(-1, 3).astype(np.int32)


def load_stl(path: str, name: str | None = None) -> Shape:
    with open(path, "rb") as f:
        data = f.read()
    name = name or os.path.splitext(os.path.basename(path))[0]

    is_ascii = data[:5] == b"solid"
    if is_ascii:
        # ascii "solid" headers can lie on binary files: verify with size
        n_bin = (
            int.from_bytes(data[80:84], "little") if len(data) >= 84 else -1
        )
        if len(data) == 84 + 50 * n_bin:
            is_ascii = False

    if is_ascii:
        verts = []
        for line in data.decode("ascii", "replace").splitlines():
            tok = line.split()
            if tok[:1] == ["vertex"]:
                verts.append([float(tok[1]), float(tok[2]), float(tok[3])])
        tris = np.asarray(verts, np.float32).reshape(-1, 3, 3)
    else:
        n = int.from_bytes(data[80:84], "little")
        rec = np.dtype(
            [("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")]
        )
        tris = np.frombuffer(data, rec, n, 84)["v"].astype(np.float32)

    pos, idx = _weld(tris)
    return Shape(positions=pos, indices=idx, name=name)


def load_off(path: str, name: str | None = None) -> Shape:
    """Object File Format: counts line, V vertex lines, F polygon lines.

    Handles the common header variants: counts on the 'OFF' line itself
    ('OFF 8 6 12'), COFF/NOFF-style leading keywords, and per-vertex
    color/extra fields (vertices are parsed line-by-line taking the first
    3 floats, so trailing fields cannot shift the face records).
    """
    lines: list[list[str]] = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if line:
                lines.append(line.split())
    if not lines:
        raise ValueError(f"{path}: empty OFF file")
    # header: strip a leading [C|N|ST]OFF keyword, with or without counts after
    head = lines[0]
    if head[0].upper().endswith("OFF"):
        head = head[1:]
        if not head:                # counts on the next line
            lines = lines[1:]
            head = lines[0]
        else:
            lines[0] = head
    nv, nf = int(head[0]), int(head[1])
    body = lines[1:]
    if len(body) < nv + nf:
        raise ValueError(f"{path}: expected {nv} vertices + {nf} faces, "
                         f"got {len(body)} records")
    pos = np.asarray(
        [[float(t) for t in body[i][:3]] for i in range(nv)], np.float64
    )
    faces = []
    for i in range(nv, nv + nf):
        toks = body[i]
        n = int(toks[0])
        idx = [int(t) for t in toks[1 : 1 + n]]
        for k in range(1, n - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])
    return Shape(
        positions=pos.astype(np.float32),
        indices=np.asarray(faces, np.int32),
        name=name or os.path.splitext(os.path.basename(path))[0],
    )
