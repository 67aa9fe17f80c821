"""Stanford PLY loader (ascii + binary little/big endian).

The reference reaches PLY through Assimp (AssimpLoader.cpp:171-192 loads any
Assimp-supported format with triangulate + gen-normals + calc-tangents);
here the parser is native Python/numpy and Shape.preprocess supplies the
generated normals/tangents, matching that pipeline's output contract.

A copy of svgf_tpu/io/plyloader.py over the port's host classes.
"""

from __future__ import annotations

import numpy as np

from svgf_tpu_torch.core.scene import Shape

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str, name: str | None = None) -> Shape:
    with open(path, "rb") as f:
        data = f.read()

    # ---- header ----
    end = data.find(b"end_header")
    if not data.startswith(b"ply") or end < 0:
        raise ValueError(f"not a PLY file: {path}")
    end = data.find(b"\n", end) + 1
    header = data[:end].decode("ascii", "replace")
    body = data[end:]

    fmt = None
    elements = []  # [(name, count, [(prop_name, dtype) | ("list", idx_dt, cnt_dt, name)])]
    for line in header.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", _PLY_DTYPES[tok[2]],
                                        _PLY_DTYPES[tok[3]], tok[4]))
            else:
                elements[-1][2].append((tok[-1], _PLY_DTYPES[tok[1]]))
    if fmt is None:
        raise ValueError(f"PLY missing format line: {path}")

    verts = norms = uvs = None
    faces: list = []

    if fmt == "ascii":
        lines = body.decode("ascii", "replace").split("\n")
        cursor = 0
        for ename, count, props in elements:
            rows = lines[cursor : cursor + count]
            cursor += count
            if ename == "vertex":
                arr = np.array(
                    [r.split() for r in rows], dtype=np.float64
                )
                names = [p[0] for p in props]
                verts, norms, uvs = _vertex_channels(arr, names)
            elif ename == "face":
                for r in rows:
                    t = r.split()
                    n = int(t[0])
                    idx = [int(x) for x in t[1 : 1 + n]]
                    faces.extend(_fan(idx))
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        off = 0
        for ename, count, props in elements:
            if all(p[0] != "list" for p in props):
                dt = np.dtype([(p[0], endian + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                if ename == "vertex":
                    names = [p[0] for p in props]
                    cols = np.stack(
                        [arr[n].astype(np.float64) for n in names], axis=1
                    )
                    verts, norms, uvs = _vertex_channels(cols, names)
            else:
                # list properties force per-row parsing (variable length)
                for _ in range(count):
                    row_vals = []
                    for p in props:
                        if p[0] == "list":
                            cnt_dt = np.dtype(endian + p[1])
                            idx_dt = np.dtype(endian + p[2])
                            n = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                            off += cnt_dt.itemsize
                            vals = np.frombuffer(body, idx_dt, n, off)
                            off += idx_dt.itemsize * n
                            if ename == "face":
                                row_vals = [int(x) for x in vals]
                        else:
                            off += np.dtype(endian + p[1]).itemsize
                    if ename == "face" and row_vals:
                        faces.extend(_fan(row_vals))

    if verts is None:
        raise ValueError(f"PLY has no vertex element: {path}")
    idx = (
        np.asarray(faces, np.int32).reshape(-1, 3)
        if faces
        else np.zeros((0, 3), np.int32)
    )
    import os

    return Shape(
        positions=verts.astype(np.float32),
        indices=idx,
        normals=None if norms is None else norms.astype(np.float32),
        uvs=None if uvs is None else uvs.astype(np.float32),
        name=name or os.path.splitext(os.path.basename(path))[0],
    )


def _vertex_channels(cols: np.ndarray, names: list):
    def pick(keys):
        try:
            j = [names.index(k) for k in keys]
        except ValueError:
            return None
        return cols[:, j]

    verts = pick(["x", "y", "z"])
    if verts is None:
        raise ValueError("PLY vertex element lacks x/y/z")
    norms = pick(["nx", "ny", "nz"])
    uvs = pick(["u", "v"]) if "u" in names else pick(["s", "t"])
    return verts, norms, uvs


def _fan(idx: list) -> list:
    """Triangulate a polygon as a fan (Assimp aiProcess_Triangulate)."""
    out = []
    for k in range(1, len(idx) - 1):
        out.append([idx[0], idx[k], idx[k + 1]])
    return out
