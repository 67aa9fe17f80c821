"""The port's file I/O against svgf_tpu's (svgf_tpu_torch/io, utils/image.py).

Every loader reads the same file through both packages and must give
bit-equal shapes, materials, instances and textures; the files are
written into tmp_path as tests/test_io.py, tests/test_mesh_loaders.py and
tests/test_textures.py write theirs. Scene npz files and binary `.scene`
files written by either package load into the other, and the flattened
scenes are bit-equal (both packages with the NumPy BVH builder:
svgf_tpu's native builder makes another tree). Checkpoints cross both
ways in fp32, fp16 and bf16, and svgf_tpu's planar fp16 pair-packed
states load into the port bit for bit. svgf_tpu cannot read its own bf16
checkpoints (its loader raises TypeError on the `|V2` fields); the port
reads them. Images and the image metrics equal svgf_tpu's.
"""

import base64
import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgf_tpu.core.camera import Camera as JCamera
from svgf_tpu.core.scene import Environment as JEnvironment
from svgf_tpu.core.scene import Material as JMaterial
from svgf_tpu.core.scene import MaterialType as JMaterialType
from svgf_tpu.io import assets as j_assets
from svgf_tpu.io import binscene as j_binscene
from svgf_tpu.io import gltf as j_gltf
from svgf_tpu.io import objloader as j_obj
from svgf_tpu.io import plyloader as j_ply
from svgf_tpu.io import serialization as j_ser
from svgf_tpu.io import stlloader as j_stl
from svgf_tpu.kernels.planar import make_layout, pack_prev_from_state, pack_taa_from_state
from svgf_tpu.render.types import GBuffer as JGBuffer
from svgf_tpu.render.types import PlanarState
from svgf_tpu.render.types import TemporalState as JTemporalState
from svgf_tpu.scenes import cornell_box as j_cornell
from svgf_tpu.scenes.stress import stress_scene as j_stress
from svgf_tpu.utils import image as j_image
from svgf_tpu_torch import convert
from svgf_tpu_torch import io as t_io
from svgf_tpu_torch.core.camera import Camera
from svgf_tpu_torch.core.scene import Scene, SceneArrays
from svgf_tpu_torch.io import assets as t_assets
from svgf_tpu_torch.io import binscene as t_binscene
from svgf_tpu_torch.io import gltf as t_gltf
from svgf_tpu_torch.io import objloader as t_obj
from svgf_tpu_torch.io import plyloader as t_ply
from svgf_tpu_torch.io import serialization as t_ser
from svgf_tpu_torch.io import stlloader as t_stl
from svgf_tpu_torch.render.types import GBuffer, TemporalState
from svgf_tpu_torch.scenes.cornell import cornell_box
from svgf_tpu_torch.scenes.materials import cornell_materials, dress_cornell
from svgf_tpu_torch.scenes.stress import stress_scene
from svgf_tpu_torch.utils import image as t_image

# a unit right tetrahedron (tests/test_mesh_loaders.py)
TET_V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
TET_F = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32)


# ---------------------------------------------------------------------------
# bit-equality of host records
# ---------------------------------------------------------------------------


def assert_same(want, got, what):
    """Both None, or equal arrays of one dtype (a tuple or scalar as NumPy sees it)."""
    if want is None or got is None:
        assert want is None and got is None, what
        return
    w, g = np.asarray(want), np.asarray(got)
    assert w.dtype == g.dtype and w.shape == g.shape, (what, w.dtype, g.dtype, w.shape, g.shape)
    np.testing.assert_array_equal(g, w, err_msg=what)


def assert_record_equal(want, got, what):
    """Every dataclass field of `got` (the port's record) equals `want`'s."""
    for f in dataclasses.fields(got):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "blas":
            continue
        if isinstance(g, str):
            assert w == g, (what, f.name)
        elif f.name == "material_type":
            assert int(w) == int(g), (what, f.name)
        else:
            assert_same(w, g, f"{what}.{f.name}")


def assert_scene_equal(want, got):
    for name in ("shapes", "instances", "materials", "cameras", "environments"):
        ws, gs = getattr(want, name), getattr(got, name)
        assert len(ws) == len(gs), name
        for k, (w, g) in enumerate(zip(ws, gs)):
            assert_record_equal(w, g, f"{name}[{k}]")
    for name in ("textures", "env_textures"):
        ws, gs = getattr(want, name), getattr(got, name)
        assert len(ws) == len(gs), name
        for k, (w, g) in enumerate(zip(ws, gs)):
            assert_same(w, g, f"{name}[{k}]")
    assert want.textures_enabled == got.textures_enabled


def assert_flattened_equal(j_scene, t_scene, monkeypatch):
    """Both scenes flattened (svgf_tpu with the NumPy builder) are bit-equal."""
    monkeypatch.setenv("SVGF_NATIVE", "0")
    want = convert.scene_arrays(jax.tree.map(np.asarray, j_scene.flatten()), device="cpu")
    got = t_scene.flatten(device="cpu")
    assert got.meta == want.meta
    for name in SceneArrays.tensor_fields():
        w, g = getattr(want, name), getattr(got, name)
        assert g.dtype == w.dtype and torch.equal(g, w), name


# ---------------------------------------------------------------------------
# the files (as the svgf_tpu tests write them)
# ---------------------------------------------------------------------------


def write_obj(d):
    p = d / "tri.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0 0\nvt 1 0\nvt 0 1\nvn 0 0 1\n"
                 "f 1/1/1 2/2/1 3/3/1\nf 2/2/1 4/1/1 3/3/1\nf 1 2 4 3\n")
    return p


def write_ply_ascii(d):
    p = d / "tet.ply"
    lines = ["ply", "format ascii 1.0", f"element vertex {len(TET_V)}",
             "property float x", "property float y", "property float z",
             f"element face {len(TET_F)}", "property list uchar int vertex_indices", "end_header"]
    lines += [" ".join(str(float(x)) for x in v) for v in TET_V]
    lines += ["3 " + " ".join(str(int(i)) for i in f) for f in TET_F]
    p.write_text("\n".join(lines) + "\n")
    return p


def write_ply_binary(d):
    p = d / "tet_bin.ply"
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(TET_V)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property float nx\nproperty float ny\nproperty float nz\n"
              "property float u\nproperty float v\n"
              f"element face {len(TET_F)}\n"
              "property list uchar int vertex_indices\nend_header\n").encode()
    nrm = TET_V / np.maximum(np.linalg.norm(TET_V, axis=1, keepdims=True), 1)
    body = b"".join(struct.pack("<8f", *v, *n, v[0], v[2]) for v, n in zip(TET_V, nrm))
    body += b"".join(struct.pack("<B3i", 3, *f) for f in TET_F)
    p.write_bytes(header + body)
    return p


def write_ply_quad(d):
    p = d / "quad.ply"
    p.write_text("ply\nformat ascii 1.0\nelement vertex 4\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "element face 1\nproperty list uchar int vertex_indices\nend_header\n"
                 "0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    return p


def write_stl_binary(d):
    p = d / "tet.stl"
    data = b"\0" * 80 + struct.pack("<I", len(TET_F))
    for f in TET_F:
        tri = TET_V[f]
        n = np.cross(tri[1] - tri[0], tri[2] - tri[0])
        data += struct.pack("<3f", *(n / max(np.linalg.norm(n), 1e-9)))
        data += b"".join(struct.pack("<3f", *v) for v in tri) + struct.pack("<H", 0)
    p.write_bytes(data)
    return p


def write_stl_ascii(d):
    p = d / "tet_ascii.stl"
    out = ["solid tet"]
    for f in TET_F:
        out.append(" facet normal 0 0 0\n  outer loop")
        out += [f"   vertex {v[0]} {v[1]} {v[2]}" for v in TET_V[f]]
        out.append("  endloop\n endfacet")
    p.write_text("\n".join(out + ["endsolid tet"]))
    return p


def write_off(d):
    p = d / "tet.off"
    lines = ["OFF", f"{len(TET_V)} {len(TET_F)} 0"]
    lines += [" ".join(str(float(x)) for x in v) for v in TET_V]
    lines += ["3 " + " ".join(str(int(i)) for i in f) for f in TET_F]
    p.write_text("\n".join(lines) + "\n")
    return p


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def write_gltf(d):
    """tests/test_io.py's one-triangle glTF: a node translation, a MATTE
    material, u16 indices in a data-URI buffer."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    buf = pos.tobytes() + np.array([0, 1, 2], np.uint16).tobytes() + b"\x00\x00"
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0, 0, -2], "name": "tri"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [0.5, 0.25, 0.125, 1.0],
                                                 "metallicFactor": 0.0, "roughnessFactor": 1.0}}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
                      {"bufferView": 1, "componentType": 5123, "count": 3, "type": "SCALAR"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 36},
                        {"buffer": 0, "byteOffset": 36, "byteLength": 6}],
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64," + _b64(buf)}],
    }
    p = d / "tri.gltf"
    p.write_text(json.dumps(doc))
    return p


def _png_bytes(d, img, name):
    path = d / name
    j_image.write_png(str(path), img)
    return path.read_bytes()


def write_glb_textured(d):
    """A GLB container: two meshes (one with normals, UVs, tangents and a
    strided interleaved buffer view), a node hierarchy with rotation, scale
    and a matrix, and PBR materials with colour (alpha below 1), roughness,
    emissive and normal textures, embedded PNGs by data URI and by buffer
    view, and a PNG file beside the GLB."""
    rng = np.random.default_rng(0)
    colour = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)
    colour[..., 3] = np.where(rng.random((8, 8)) < 0.25, 100, 255)
    normal = np.full((4, 4, 3), 128, np.uint8)
    normal[..., 0] = 220
    normal[..., 2] = 200
    rough = rng.integers(0, 256, (4, 8, 3), dtype=np.uint8)
    j_image.write_png(str(d / "rough.png"), rough)
    png_normal = _png_bytes(d, normal, "n.png")

    quad_pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    quad_nrm = np.tile(np.array([0, 0, 1], np.float32), (4, 1))
    quad_uv = quad_pos[:, :2] * 2.0
    quad_tan = np.tile(np.array([1, 0, 0, 1], np.float32), (4, 1))
    inter = np.concatenate([quad_pos, quad_nrm], axis=1).astype(np.float32)  # stride 24
    quad_idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    tri_pos = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)

    chunks, views = [], []

    def add(data: bytes, stride=None):
        off = sum(len(c) for c in chunks)
        pad = (-len(data)) % 4
        chunks.append(data + b"\0" * pad)
        view = {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        if stride:
            view["byteStride"] = stride
        views.append(view)
        return len(views) - 1

    v_inter = add(inter.tobytes(), stride=24)
    v_uv = add(quad_uv.tobytes())
    v_tan = add(quad_tan.tobytes())
    v_idx = add(quad_idx.tobytes())
    v_tri = add(tri_pos.tobytes())
    v_png = add(png_normal)
    acc = [
        {"bufferView": v_inter, "componentType": 5126, "count": 4, "type": "VEC3"},
        {"bufferView": v_inter, "byteOffset": 12, "componentType": 5126, "count": 4, "type": "VEC3"},
        {"bufferView": v_uv, "componentType": 5126, "count": 4, "type": "VEC2"},
        {"bufferView": v_tan, "componentType": 5126, "count": 4, "type": "VEC4"},
        {"bufferView": v_idx, "componentType": 5125, "count": 6, "type": "SCALAR"},
        {"bufferView": v_tri, "componentType": 5126, "count": 3, "type": "VEC3"},
    ]
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0, 3]}],
        "nodes": [
            {"name": "root", "translation": [0.1, 0.2, -1.0], "rotation": [0, 0.3826834, 0, 0.9238795],
             "scale": [1.5, 1.0, 0.5], "children": [1, 2]},
            {"mesh": 0, "name": "quad"},
            {"mesh": 1, "matrix": [1, 0, 0, 0, 0, 0.8, 0.6, 0, 0, -0.6, 0.8, 0, 0.3, 0, 0, 1]},
            {"mesh": 1, "translation": [0, 0.5, 0]},
        ],
        "meshes": [
            {"name": "quad", "primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                                            "TEXCOORD_0": 2, "TANGENT": 3},
                                             "indices": 4, "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": 5}, "material": 1}]},
        ],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.8, 0.7, 0.75],
                                      "baseColorTexture": {"index": 0},
                                      "metallicRoughnessTexture": {"index": 2},
                                      "metallicFactor": 0.2, "roughnessFactor": 0.6},
             "normalTexture": {"index": 1}, "emissiveTexture": {"index": 3}},
            {"emissiveFactor": [2.0, 1.5, 1.0],
             "pbrMetallicRoughness": {"metallicFactor": 0.0}},
        ],
        "textures": [{"source": 0}, {"source": 1}, {"source": 2}, {}],
        "images": [{"uri": "data:image/png;base64," + _b64(_png_bytes(d, colour, "c.png"))},
                   {"bufferView": v_png, "mimeType": "image/png"},
                   {"uri": "rough.png"}],
        "accessors": acc,
        "bufferViews": views,
        "buffers": [{"byteLength": sum(len(c) for c in chunks)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    binary = b"".join(chunks)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(binary), 0x004E4942) + binary)
    p = d / "scene.glb"
    p.write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
    return p


MESHES = {
    "obj": (write_obj, j_obj.load_obj, t_obj.load_obj),
    "ply_ascii": (write_ply_ascii, j_ply.load_ply, t_ply.load_ply),
    "ply_binary": (write_ply_binary, j_ply.load_ply, t_ply.load_ply),
    "ply_quad_fan": (write_ply_quad, j_ply.load_ply, t_ply.load_ply),
    "stl_binary": (write_stl_binary, j_stl.load_stl, t_stl.load_stl),
    "stl_ascii": (write_stl_ascii, j_stl.load_stl, t_stl.load_stl),
    "off": (write_off, j_stl.load_off, t_stl.load_off),
}


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_mesh_loader_matches_jax(kind, tmp_path):
    write, j_load, t_load = MESHES[kind]
    path = str(write(tmp_path))
    want, got = j_load(path), t_load(path)
    assert_record_equal(want, got, "shape")
    # and the preprocessed triangle arrays built from them
    assert_record_equal(want.preprocess(), got.preprocess(), "preprocessed")


@pytest.mark.parametrize("kind", ["gltf", "glb_textured"])
def test_gltf_loader_matches_jax(kind, tmp_path, monkeypatch):
    path = str((write_gltf if kind == "gltf" else write_glb_textured)(tmp_path))
    want, got = j_gltf.load_gltf(path), t_gltf.load_gltf(path)
    assert_scene_equal(want, got)
    if kind == "glb_textured":
        assert len(got.textures) == 3 and len(got.instances) == 3
        assert [m.normal_texture for m in got.materials] == [2, -1]   # colour, roughness, normal
        # the texture stack, opacity from the colour alpha, normal maps and
        # their tangents follow into the flattened scene
        for s, camera in ((want, JCamera), (got, Camera)):
            s.textures_enabled = True
            s.cameras.append(camera())
        assert_flattened_equal(want, got, monkeypatch)
        meta = got.flatten(device="cpu").meta
        assert meta.textures_enabled and meta.has_opacity and meta.has_normal_maps


@pytest.mark.parametrize("ext", ["gltf", "obj", "ply", "stl", "off"])
def test_load_asset_dispatch_matches_jax(ext, tmp_path):
    write = {"gltf": write_gltf, "obj": write_obj, "ply": write_ply_binary,
             "stl": write_stl_ascii, "off": write_off}[ext]
    path = str(write(tmp_path))
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = (0.25, -0.5, 1.0)
    kw = {} if ext == "gltf" else {"material": 2, "transform": t}
    want = j_assets.load_asset(path, j_cornell(), **kw)
    got = t_assets.load_asset(path, cornell_box(), **kw)
    assert_scene_equal(want, got)
    with pytest.raises(ValueError, match="unsupported asset type"):
        t_assets.load_asset(str(tmp_path / "x.fbx"), Scene())


# ---------------------------------------------------------------------------
# scene npz and binary scenes
# ---------------------------------------------------------------------------


def _scenes(name):
    """(svgf_tpu's scene, the port's) of one kind, the same data."""
    if name == "cornell":
        return j_cornell(aspect=16 / 9), cornell_box(aspect=16 / 9)
    if name == "stress":
        return j_stress(n=24), stress_scene(n=24)
    return (dress_cornell(j_cornell(aspect=16 / 9), JMaterial, JMaterialType, JEnvironment),
            cornell_materials(aspect=16 / 9))


@pytest.mark.parametrize("writer", ["svgf_tpu", "port"])
@pytest.mark.parametrize("name", ["cornell", "stress", "materials"])
def test_scene_npz_crosses(name, writer, tmp_path, monkeypatch):
    j_scene, t_scene = _scenes(name)
    path = str(tmp_path / "scene.npz")
    (j_ser if writer == "svgf_tpu" else t_ser).save_scene_npz(path, j_scene if writer == "svgf_tpu"
                                                              else t_scene)
    j_back, t_back = j_ser.load_scene_npz(path), t_ser.load_scene_npz(path)
    assert_scene_equal(j_back, t_back)
    assert_flattened_equal(j_back, t_back, monkeypatch)
    assert len(t_back.shapes) == len(t_scene.shapes)


def test_scene_npz_files_equal(tmp_path):
    """The port writes the arrays svgf_tpu writes for the same scene."""
    j_scene, t_scene = _scenes("materials")
    j_ser.save_scene_npz(str(tmp_path / "j.npz"), j_scene)
    t_ser.save_scene_npz(str(tmp_path / "t.npz"), t_scene)
    assert_npz_equal(tmp_path / "j.npz", tmp_path / "t.npz")


def assert_npz_equal(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k
        assert za[k].tobytes() == zb[k].tobytes(), k


@pytest.mark.parametrize("name", ["cornell", "materials"])
def test_binscene_round_trips_through_both(name, tmp_path, monkeypatch):
    monkeypatch.setenv("SVGF_NATIVE", "0")
    j_scene, t_scene = _scenes(name)
    jp, tp = str(tmp_path / "j.scene"), str(tmp_path / "t.scene")
    j_binscene.save_reference_scene(j_scene, jp)
    t_binscene.save_reference_scene(t_scene, tp)
    assert (tmp_path / "j.scene").read_bytes() == (tmp_path / "t.scene").read_bytes()
    j_back, t_back = j_binscene.load_reference_scene(jp), t_io.load_reference_scene(jp)
    assert_scene_equal(j_back, t_back)
    assert_scene_equal(j_back, t_assets.load_asset(jp, Scene()))
    assert_flattened_equal(j_back, t_back, monkeypatch)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

CH, CW = 6, 10
J_TYPES = {"fp32": jnp.float32, "fp16": jnp.float16, "bf16": jnp.bfloat16}
T_TYPES = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}


def seeded_fields(seed=0):
    """Seeded image-layout state fields as float32/int32 NumPy arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *c: rng.normal(0.5, 2.0, (CH, CW) + c).astype(np.float32)
    g = {name: f(*shape) for name, shape in (("position", (3,)), ("normal", (3,)),
                                             ("motion", (2,)), ("depth", ()),
                                             ("depth_deriv", ()), ("uv", (2,)))}
    g["depth"] = np.abs(g["depth"])
    for name in ("instance", "prim", "material"):
        g[name] = rng.integers(-1, 40, (CH, CW)).astype(np.int32)
    return dict(color=f(4), moments=np.abs(f(2)), taa_history=np.abs(f(4)),
                history_len=rng.integers(0, 32, (CH, CW)).astype(np.int32), gbuffer=g,
                frame_idx=int(rng.integers(1, 1000)))


def jax_state(fields, label):
    dt = J_TYPES[label]
    cast = lambda x: jnp.asarray(x, dt) if x.dtype == np.float32 else jnp.asarray(x)
    return JTemporalState(
        color=cast(fields["color"]), moments=cast(fields["moments"]),
        history_len=jnp.asarray(fields["history_len"]), taa_history=cast(fields["taa_history"]),
        gbuffer=JGBuffer(**{k: cast(v) for k, v in fields["gbuffer"].items()}),
        frame_idx=jnp.int32(fields["frame_idx"]))


def bits(x):
    """A state field as comparable NumPy bits (bf16 as its 16-bit patterns)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 and x.dtype.kind == "V" else x


def assert_state_matches(want_jax, got):
    """The port's TemporalState holds svgf_tpu's state bit for bit."""
    pairs = [("color", want_jax.color, got.color), ("moments", want_jax.moments, got.moments),
             ("history_len", want_jax.history_len, got.history_len),
             ("taa_history", want_jax.taa_history, got.taa_history)]
    pairs += [(f"g_{k}", getattr(want_jax.gbuffer, k), getattr(got.gbuffer, k))
              for k in JGBuffer._fields]
    for name, w, g in pairs:
        w = np.asarray(w)
        assert str(g.dtype) == f"torch.{w.dtype}", (name, g.dtype, w.dtype)
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(bits(g), w.view(np.int16), err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got.frame_idx == int(want_jax.frame_idx) and isinstance(got.frame_idx, int)


@pytest.mark.parametrize("label", ["fp32", "fp16", "bf16"])
def test_jax_checkpoint_loads_into_port(label, tmp_path):
    state = jax_state(seeded_fields(), label)
    path = str(tmp_path / "ckpt.npz")
    j_ser.save_checkpoint(path, state)
    got = t_io.load_checkpoint(path, device="cpu")
    assert_state_matches(state, got)


@pytest.mark.parametrize("label", ["fp32", "fp16", "bf16"])
def test_port_checkpoint_equals_jax_file(label, tmp_path):
    """The port writes the arrays svgf_tpu writes for the same state, and
    svgf_tpu reads them (fp32, fp16: its loader refuses bf16, see below)."""
    state = jax_state(seeded_fields(1), label)
    port_state = convert.temporal_state(
        jax.tree.map(lambda x: np.asarray(x).astype(np.float32)
                     if np.asarray(x).dtype.kind in "fV" else np.asarray(x), state), "cpu")
    port_state = port_state._replace(
        color=port_state.color.to(T_TYPES[label]), moments=port_state.moments.to(T_TYPES[label]),
        taa_history=port_state.taa_history.to(T_TYPES[label]),
        gbuffer=port_state.gbuffer.to_dtype(T_TYPES[label]))
    jp, tp = tmp_path / "j.npz", tmp_path / "t.npz"
    j_ser.save_checkpoint(str(jp), state)
    t_io.save_checkpoint(str(tp), port_state)
    assert_npz_equal(jp, tp)
    assert_state_matches(state, t_io.load_checkpoint(str(tp), device="cpu"))
    if label != "bf16":
        back = j_ser.load_checkpoint(str(tp))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_checkpoint_departure(tmp_path):
    """svgf_tpu's load_checkpoint raises on its own bf16 file (NumPy stores
    the bf16 fields as raw |V2); the port returns the bits."""
    state = jax_state(seeded_fields(2), "bf16")
    path = str(tmp_path / "bf16.npz")
    j_ser.save_checkpoint(path, state)
    assert np.load(path)["color"].dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        j_ser.load_checkpoint(path)
    with pytest.raises(TypeError):
        j_ser.load_checkpoint(path, dtype=jnp.bfloat16)
    got = t_io.load_checkpoint(path, device="cpu")
    assert_state_matches(state, got)
    as32 = t_io.load_checkpoint(path, dtype=torch.float32, device="cpu")
    assert as32.color.dtype == torch.float32 and as32.history_len.dtype == torch.int32
    assert torch.equal(as32.color, got.color.float())


@pytest.mark.parametrize("label", ["fp16", "fp32"])
def test_planar_checkpoint_loads_into_port(label, tmp_path):
    """A planar svgf_tpu state (fp16: the pair-packed prev and TAA planes)
    is written in the image layout and loads into the port bit for bit."""
    fields = seeded_fields(3)
    image = jax_state(fields, "fp32")
    lo = make_layout(CH, CW)
    dt = J_TYPES[label]
    planar = JTemporalState(
        color=None, moments=None, history_len=None, taa_history=None, gbuffer=None,
        frame_idx=jnp.int32(fields["frame_idx"]),
        planar=PlanarState(
            prev=pack_prev_from_state(image.color, image.gbuffer, image.moments,
                                      image.history_len, lo, dtype=dt),
            taa=pack_taa_from_state(image.taa_history, lo, dtype=dt)))
    if label == "fp16":
        assert planar.planar.prev.shape[0] == 6 and planar.planar.taa.shape[0] == 2
    path = str(tmp_path / "planar.npz")
    j_ser.save_checkpoint(path, planar, height=CH, width=CW)
    want = j_ser.load_checkpoint(path)
    got = t_io.load_checkpoint(path, device="cpu")
    assert_state_matches(want, got)
    q = (lambda x: x.astype(np.float16).astype(np.float32)) if label == "fp16" else (lambda x: x)
    np.testing.assert_array_equal(got.color[..., :3].numpy(), q(fields["color"][..., :3]))
    np.testing.assert_array_equal(got.taa_history.numpy(), q(fields["taa_history"]))
    np.testing.assert_array_equal(got.history_len.numpy(), fields["history_len"])


def test_checkpoint_needs_the_card_by_default(tmp_path):
    path = str(tmp_path / "c.npz")
    t_io.save_checkpoint(path, TemporalState.initial(2, 3, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_io.load_checkpoint(path)
    back = t_io.load_checkpoint(path, device="cpu")
    assert back.frame_idx == 0 and back.color.dtype == torch.float16
    assert isinstance(back.gbuffer, GBuffer)


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [3, 4])
def test_png_crosses(channels, tmp_path):
    rng = np.random.default_rng(channels)
    img = rng.random((13, 21, channels)).astype(np.float32)
    a, b = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    j_image.write_png(a, img)
    t_image.write_png(b, img)
    assert (tmp_path / "j.png").read_bytes() == (tmp_path / "t.png").read_bytes()
    assert_same(j_image.read_png(a), t_image.read_png(a), "png")
    assert_same(j_image.to_uint8(img), t_image.read_image(b), "read_image")
    assert_same(j_image.read_image(a, as_float=True), t_image.read_image(a, as_float=True), "float")


def test_png_filters_match_jax(tmp_path):
    """A PNG with every scanline filter (PIL's encoder picks them) decodes
    alike in both packages."""
    from PIL import Image

    rng = np.random.default_rng(7)
    img = (np.cumsum(rng.integers(0, 9, (24, 32, 3)), axis=1) % 256).astype(np.uint8)
    path = str(tmp_path / "f.png")
    Image.fromarray(img).save(path, optimize=True)
    assert_same(img, t_image.read_png(path), "decode")
    assert_same(j_image.read_png(path), t_image.read_png(path), "png")


def test_hdr_crosses(tmp_path):
    img = np.abs(np.random.default_rng(0).normal(1.0, 2.0, (9, 17, 3))).astype(np.float32)
    img[0, 0] = 0.0
    a, b = str(tmp_path / "j.hdr"), str(tmp_path / "t.hdr")
    j_image.write_hdr(a, img)
    t_image.write_hdr(b, img)
    assert (tmp_path / "j.hdr").read_bytes() == (tmp_path / "t.hdr").read_bytes()
    assert_same(j_image.read_hdr(a), t_image.read_hdr(a), "hdr")
    assert_same(j_image.read_hdr(b), t_image.read_image(b), "read_image")
    tol = img.max(axis=-1, keepdims=True) / 128.0   # RGBE shared-exponent precision
    assert np.all(np.abs(t_image.read_hdr(b) - img) <= tol)


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(4)
    a = rng.random((40, 56, 3))
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
    np.testing.assert_allclose(t_image.psnr(a, b), j_image.psnr(a, b), rtol=1e-6)
    np.testing.assert_allclose(t_image.ssim(a, b), j_image.ssim(a, b), rtol=1e-6)
    np.testing.assert_allclose(t_image.ssim(a[..., 0], b[..., 0]),
                               j_image.ssim(a[..., 0], b[..., 0]), rtol=1e-6)
    assert t_image.psnr(a, a) == float("inf")
