"""glTF 2.0 loader (.gltf JSON + .bin, and .glb containers) — no external
deps. Mirrors the reference GLTFLoader.cpp: meshes/primitives become shapes,
the node hierarchy becomes instances with TRS/matrix transforms
(GLTFLoader.cpp:311-389), PBR materials map to MATTE/PBR with the
metallic-roughness convention (GLTFLoader.cpp:265-308).

A copy of svgf_tpu/io/gltf.py over the port's host classes.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from svgf_tpu_torch.core.scene import Instance, Material, MaterialType, Scene, Shape

_COMP_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_N = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_glb(path: str):
    with open(path, "rb") as f:
        magic, version, length = struct.unpack("<III", f.read(12))
        assert magic == 0x46546C67, "not a glb file"
        gltf = None
        buffers = []
        while f.tell() < length:
            clen, ctype = struct.unpack("<II", f.read(8))
            data = f.read(clen)
            if ctype == 0x4E4F534A:  # JSON
                gltf = json.loads(data)
            elif ctype == 0x004E4942:  # BIN
                buffers.append(data)
        return gltf, buffers


def _read_buffers(doc, base_dir: str, glb_buffers):
    out = []
    for i, buf in enumerate(doc.get("buffers", [])):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_buffers[i])
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _accessor(doc, buffers, idx):
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _COMP_DTYPE[acc["componentType"]]
    ncomp = _TYPE_N[acc["type"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize * ncomp
    stride = view.get("byteStride", itemsize)
    off = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    raw = buffers[view["buffer"]]
    if stride == itemsize:
        a = np.frombuffer(raw, dtype, count * ncomp, off).reshape(count, ncomp)
    else:
        a = np.zeros((count, ncomp), dtype)
        for k in range(count):
            a[k] = np.frombuffer(raw, dtype, ncomp, off + k * stride)
    return np.ascontiguousarray(a)


def _node_matrix(node) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float64)
    if "scale" in node:
        m = np.diag(list(node["scale"]) + [1.0])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
                [0, 0, 0, 1],
            ]
        )
        m = r @ m
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m.astype(np.float32)


def load_gltf(path: str, scene: Scene | None = None) -> Scene:
    """Append a glTF file's meshes/materials/instances to `scene`."""
    base_dir = os.path.dirname(path)
    if path.endswith(".glb"):
        doc, glb_buffers = _load_glb(path)
    else:
        with open(path) as f:
            doc = json.load(f)
        glb_buffers = []
    buffers = _read_buffers(doc, base_dir, glb_buffers)
    scene = scene if scene is not None else Scene()

    # images + textures (reference imports the 4 PBR texture slots and
    # resizes each image into the scene atlas, GLTFLoader.cpp:16-71,265-308)
    image_slot: dict[int, int] = {}

    def load_image(img_idx: int) -> int:
        """Decode glTF image `img_idx` into scene.textures; returns slot id."""
        if img_idx in image_slot:
            return image_slot[img_idx]
        img = doc["images"][img_idx]
        data = None
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
            else:
                from svgf_tpu_torch.utils.image import read_image

                arr = read_image(os.path.join(base_dir, uri))
                scene.textures.append(arr)
                image_slot[img_idx] = len(scene.textures) - 1
                return image_slot[img_idx]
        elif "bufferView" in img:
            view = doc["bufferViews"][img["bufferView"]]
            off = view.get("byteOffset", 0)
            data = buffers[view["buffer"]][off : off + view["byteLength"]]
        if data is not None:
            import io as _io

            from PIL import Image as _PILImage

            with _PILImage.open(_io.BytesIO(data)) as im:
                arr = np.asarray(im.convert("RGBA"))
            scene.textures.append(arr)
        else:
            scene.textures.append(np.full((1, 1, 4), 255, np.uint8))
        image_slot[img_idx] = len(scene.textures) - 1
        return image_slot[img_idx]

    def tex_slot(tex_info) -> int:
        """glTF textureInfo -> scene texture slot id (-1 = none)."""
        if tex_info is None:
            return -1
        try:
            src = doc["textures"][tex_info["index"]].get("source")
            if src is None:
                return -1
            return load_image(src)
        except Exception:
            return -1

    mat_base = len(scene.materials)
    for m in doc.get("materials", [{}]):
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        metallic = pbr.get("metallicFactor", 1.0)
        rough = pbr.get("roughnessFactor", 1.0)
        emissive = m.get("emissiveFactor", [0, 0, 0])
        mtype = MaterialType.PBR if (metallic > 0 or rough < 1) else MaterialType.MATTE
        scene.materials.append(
            Material(
                colour=tuple(base[:3]),
                metallic=float(metallic),
                roughness=float(rough),
                emission=tuple(emissive),
                opacity=float(base[3]),
                material_type=mtype,
                colour_texture=tex_slot(pbr.get("baseColorTexture")),
                roughness_texture=tex_slot(pbr.get("metallicRoughnessTexture")),
                emission_texture=tex_slot(m.get("emissiveTexture")),
                normal_texture=tex_slot(m.get("normalTexture")),
            )
        )
    if not doc.get("materials"):
        scene.materials.append(Material(colour=(0.8, 0.8, 0.8)))

    # meshes -> (shape ids, material ids) per primitive
    shape_base = len(scene.shapes)
    mesh_prims: list[list[tuple[int, int]]] = []
    for mesh in doc.get("meshes", []):
        prims = []
        for prim in mesh.get("primitives", []):
            attrs = prim["attributes"]
            pos = _accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            nrm = (
                _accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs
                else None
            )
            uv = (
                _accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs
                else None
            )
            tan = (
                _accessor(doc, buffers, attrs["TANGENT"]).astype(np.float32)
                if "TANGENT" in attrs
                else None
            )
            if "indices" in prim:
                idx = _accessor(doc, buffers, prim["indices"]).astype(np.int32).reshape(-1, 3)
            else:
                idx = np.arange(pos.shape[0], dtype=np.int32).reshape(-1, 3)
            scene.shapes.append(
                Shape(
                    positions=pos, indices=idx, normals=nrm, uvs=uv, tangents=tan,
                    name=mesh.get("name", f"mesh{len(scene.shapes)}"),
                )
            )
            prims.append(
                (len(scene.shapes) - 1, mat_base + prim.get("material", 0))
            )
        mesh_prims.append(prims)

    # node hierarchy -> instances (GLTFLoader.cpp:311-389)
    nodes = doc.get("nodes", [])
    scene_nodes = doc.get("scenes", [{}])[doc.get("scene", 0)].get(
        "nodes", list(range(len(nodes)))
    )

    def visit(ni, parent):
        node = nodes[ni]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            for shape_id, mat_id in mesh_prims[node["mesh"]]:
                scene.instances.append(
                    Instance(
                        shape=shape_id, material=mat_id,
                        transform=world.astype(np.float32),
                        name=node.get("name", f"node{ni}"),
                    )
                )
        for c in node.get("children", []):
            visit(c, world)

    for ni in scene_nodes:
        visit(ni, np.eye(4, dtype=np.float32))
    return scene
