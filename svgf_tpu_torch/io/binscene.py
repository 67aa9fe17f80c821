"""Reader for the reference's custom binary scene format.

Format per scene::ToFile/FromFile (reference Scene.cpp:515-651): size_t-
prefixed raw dumps of cameras (legacy oldCamStruct layout, Scene.cpp:573-590)
/ materials / instances / environments, then shapes (per-vertex arrays +
packed triangles, Scene.cpp:287-296), env textures, textures, name string
tables, and atlas dimensions. Little-endian, size_t = 8 bytes.

A copy of svgf_tpu/io/binscene.py over the port's host classes.
"""

from __future__ import annotations

import struct

import numpy as np

from svgf_tpu_torch.core.camera import Camera
from svgf_tpu_torch.core.scene import Environment, Instance, Material, MaterialType, Scene, Shape

_OLD_CAM = 112       # mat4 + 4f + vec3+f + 2i + ivec2
_MATERIAL = 80       # 16 floats + 4 ints
_INSTANCE = 240      # 3x mat4 + aabb(32) + 4x u32
_ENVIRONMENT = 96    # mat4 + vec4 + ivec4
_TRIANGLE = 160      # 9x vec4 + vec3 + pad


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def raw(self, n: int) -> bytes:
        b = self.d[self.p : self.p + n]
        self.p += n
        return b

    def size(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def ints(self, n: int):
        return struct.unpack(f"<{n}i", self.raw(4 * n))

    def vec(self, elem_size: int, dtype=np.float32):
        n = self.size()
        return np.frombuffer(self.raw(n * elem_size), dtype=np.uint8).copy(), n

    def farray(self, elem_floats: int):
        n = self.size()
        a = np.frombuffer(self.raw(n * elem_floats * 4), dtype=np.float32).copy()
        return a.reshape(n, elem_floats) if n else np.zeros((0, elem_floats), np.float32)

    def strvec(self):
        n = self.size()
        out = []
        for _ in range(n):
            ln = self.size()
            out.append(self.raw(ln).decode("utf-8", "replace"))
        return out


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def raw(self, b: bytes):
        self.parts.append(b)

    def size(self, n: int):
        self.parts.append(struct.pack("<Q", n))

    def ints(self, *vals):
        self.parts.append(struct.pack(f"<{len(vals)}i", *vals))

    def strvec(self, strs):
        self.size(len(strs))
        for s in strs:
            b = s.encode("utf-8")
            self.size(len(b))
            self.raw(b)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


def save_reference_scene(scene: Scene, path: str) -> None:
    """Writer for the reference's binary format (scene::ToFile,
    Scene.cpp:515-549) — symmetric with load_reference_scene, so a scene
    round-trips write -> read -> render, and the reference application's
    FromFile can open the result.

    Cameras are written in the legacy oldCamStruct layout (112 bytes,
    Scene.cpp:573-590) because the reference's FromFile unconditionally
    parses that layout. Shapes write EMPTY vertex vectors + packed triangles:
    FromFile rebuilds the vertex arrays from the triangles regardless
    (Scene.cpp:307-345), and the shipped BaseScene uses the same convention.
    """
    scene.preprocess()
    w = _Writer()

    # cameras (oldCamStruct: mat4 + lens/film/aspect/focus + vec3 pad +
    # aperture + orthographic/controlled + ivec2 pad)
    w.size(len(scene.cameras))
    for cam in scene.cameras:
        frame = np.asarray(cam.frame, np.float32).T  # row-major math -> glm column-major
        w.raw(frame.tobytes())
        w.raw(struct.pack("<4f", 0.05, 0.036, float(cam.aspect), 1.0))
        w.raw(struct.pack("<4f", 0.0, 0.0, 0.0, 0.0))      # padding0 + aperture
        w.raw(struct.pack("<4i", 0, 1, 0, 0))              # ortho, controlled, pad

    # materials (material POD, Scene.h:69-89 — MaterialType is a float)
    w.size(len(scene.materials))
    for m in scene.materials:
        w.raw(struct.pack(
            "<16f",
            *m.emission, m.roughness,
            *m.colour, m.metallic,
            0.0, m.anisotropy, float(int(m.material_type)), m.opacity,
            *m.scattering_colour, m.transmission_depth,
        ))
        w.raw(struct.pack(
            "<4i", m.emission_texture, m.colour_texture,
            m.roughness_texture, m.normal_texture,
        ))

    # instances (3x mat4 + aabb + Shape/Index/Material/Selected)
    w.size(len(scene.instances))
    for k, inst in enumerate(scene.instances):
        t = np.asarray(inst.transform, np.float64)
        inv = np.linalg.inv(t)
        w.raw(t.astype(np.float32).T.tobytes())
        w.raw(inv.astype(np.float32).T.tobytes())
        w.raw(inv.T.astype(np.float32).T.tobytes())        # normal = inv-transpose
        sh = scene.shapes[inst.shape]
        pts = sh.tri_pos.reshape(-1, 3).astype(np.float64) @ t[:3, :3].T + t[:3, 3]
        lo = pts.min(axis=0).astype(np.float32) if len(pts) else np.full(3, 1e30, np.float32)
        hi = pts.max(axis=0).astype(np.float32) if len(pts) else np.full(3, -1e30, np.float32)
        w.raw(struct.pack("<4f", *lo, 0.0))
        w.raw(struct.pack("<4f", *hi, 0.0))
        w.raw(struct.pack("<4I", inst.shape, k, inst.material, 0))

    # environments (mat4 + vec4 emission + ivec4 with tex id last)
    w.size(len(scene.environments))
    for e in scene.environments:
        w.raw(np.asarray(e.transform, np.float32).T.tobytes())
        w.raw(struct.pack("<4f", *e.emission, 0.0))
        w.raw(struct.pack("<4i", 0, 0, 0, e.emission_texture))

    # shapes (shape::ToFile, Scene.cpp:287-296)
    w.size(len(scene.shapes))
    for s in scene.shapes:
        for _ in range(5):        # Positions/Normals/TexCoords/Tangents/Indices
            w.size(0)
        T = s.tri_pos.shape[0]
        w.size(T)
        tri = np.zeros((T, 40), np.float32)
        for k in range(3):
            tri[:, 4 * k + 0 : 4 * k + 3] = s.tri_pos[:, k]
            tri[:, 4 * k + 3] = s.tri_uv[:, k, 0]
            tri[:, 12 + 4 * k : 12 + 4 * k + 3] = s.tri_nrm[:, k]
            tri[:, 12 + 4 * k + 3] = s.tri_uv[:, k, 1]
            tri[:, 24 + 4 * k : 24 + 4 * k + 4] = s.tri_tan[:, k]
        tri[:, 36:39] = s.tri_pos.mean(axis=1)             # per-tri centroid
        w.raw(tri.tobytes())
        w.raw(struct.pack("<3f", *s.tri_pos.reshape(-1, 3).mean(axis=0))
              if T else struct.pack("<3f", 0, 0, 0))       # shape centroid

    # env textures then textures (texture::ToFile: u8 vec, float vec, w/h/ch)
    w.size(len(scene.env_textures))
    for img in scene.env_textures:
        a = np.asarray(img, np.float32)
        if a.ndim == 3 and a.shape[2] == 3:                # store 4-channel
            a = np.concatenate([a, np.ones_like(a[..., :1])], axis=-1)
        w.size(0)
        w.size(a.size)
        w.raw(a.astype(np.float32).tobytes())
        w.ints(a.shape[1], a.shape[0], a.shape[2])
    w.size(len(scene.textures))
    for img in scene.textures:
        a = np.asarray(img)
        if a.dtype != np.uint8:
            a = np.clip(a * 255.0, 0, 255).astype(np.uint8)
        w.size(a.size)
        w.raw(a.tobytes())
        w.size(0)
        w.ints(a.shape[1], a.shape[0], a.shape[2])

    # name tables
    w.strvec([f"camera{i}" for i in range(len(scene.cameras))])
    w.strvec([getattr(i, "name", f"instance{k}") for k, i in enumerate(scene.instances)])
    w.strvec([getattr(s, "name", f"shape{k}") for k, s in enumerate(scene.shapes)])
    w.strvec([getattr(m, "name", f"material{k}") for k, m in enumerate(scene.materials)])
    w.strvec([f"texture{i}" for i in range(len(scene.textures))])
    w.strvec([f"envtex{i}" for i in range(len(scene.env_textures))])
    w.strvec([f"environment{i}" for i in range(len(scene.environments))])

    # atlas dims footer (overridden by constants on load, Scene.cpp:641-645)
    etw = scene.env_textures[0].shape[1] if scene.env_textures else 2048
    eth = scene.env_textures[0].shape[0] if scene.env_textures else 1024
    w.ints(512, 512, etw, eth)

    with open(path, "wb") as f:
        f.write(w.bytes())


def load_reference_scene(path: str) -> Scene:
    with open(path, "rb") as f:
        r = _Reader(f.read())
    scene = Scene()

    # cameras: legacy layout (Scene.cpp:573-599)
    n_cam = r.size()
    for _ in range(n_cam):
        raw = np.frombuffer(r.raw(_OLD_CAM), np.float32).copy()
        frame = raw[:16].reshape(4, 4).T  # glm column-major -> row-major math
        aspect = float(raw[18])
        scene.cameras.append(Camera(frame=frame, fov=60.0, aspect=aspect))

    n_mat = r.size()
    for _ in range(n_mat):
        raw = r.raw(_MATERIAL)
        f20 = np.frombuffer(raw[:64], np.float32)
        tex = struct.unpack("<4i", raw[64:80])
        scene.materials.append(
            Material(
                emission=tuple(f20[0:3]),
                roughness=float(f20[3]),
                colour=tuple(f20[4:7]),
                metallic=float(f20[7]),
                anisotropy=float(f20[9]),
                material_type=MaterialType(int(f20[10])),
                opacity=float(f20[11]),
                scattering_colour=tuple(f20[12:15]),
                transmission_depth=float(f20[15]),
                emission_texture=tex[0],
                colour_texture=tex[1],
                roughness_texture=tex[2],
                normal_texture=tex[3],
            )
        )

    n_inst = r.size()
    inst_raw = []
    for _ in range(n_inst):
        raw = r.raw(_INSTANCE)
        t = np.frombuffer(raw[:64], np.float32).reshape(4, 4).T
        ids = struct.unpack("<4I", raw[224:240])
        inst_raw.append((t.copy(), ids[0], ids[2]))  # transform, shape, material

    n_env = r.size()
    for _ in range(n_env):
        raw = r.raw(_ENVIRONMENT)
        t = np.frombuffer(raw[:64], np.float32).reshape(4, 4).T
        em = np.frombuffer(raw[64:76], np.float32)
        tex = struct.unpack("<i", raw[92:96])[0]
        scene.environments.append(
            Environment(emission=tuple(em), transform=t.copy(), emission_texture=tex)
        )

    n_shapes = r.size()
    for _ in range(n_shapes):
        positions = r.farray(3)
        normals = r.farray(3)
        texcoords = r.farray(2)
        tangents = r.farray(4)
        n_idx = r.size()
        indices = (
            np.frombuffer(r.raw(n_idx * 12), np.int32).copy().reshape(n_idx, 3)
            if n_idx
            else np.zeros((0, 3), np.int32)
        )
        n_tri = r.size()
        tris = np.frombuffer(r.raw(n_tri * _TRIANGLE), np.float32).reshape(n_tri, 40)
        r.raw(12)  # centroid
        if positions.shape[0] == 0 and n_tri:
            # rebuild vertex arrays from packed triangles (Scene.cpp:307-345)
            pos = np.stack([tris[:, 0:3], tris[:, 4:7], tris[:, 8:11]], 1).reshape(-1, 3)
            nrm = np.stack([tris[:, 12:15], tris[:, 16:19], tris[:, 20:23]], 1).reshape(-1, 3)
            uv = np.stack(
                [tris[:, [3, 15]], tris[:, [7, 19]], tris[:, [11, 23]]], 1
            ).reshape(-1, 2)
            tan = np.stack([tris[:, 24:28], tris[:, 28:32], tris[:, 32:36]], 1).reshape(-1, 4)
            idx = np.arange(n_tri * 3, dtype=np.int32).reshape(n_tri, 3)
            positions, normals, texcoords, tangents, indices = pos, nrm, uv, tan, idx
        scene.shapes.append(
            Shape(
                positions=np.ascontiguousarray(positions),
                indices=indices,
                normals=np.ascontiguousarray(normals) if normals.shape[0] else None,
                uvs=np.ascontiguousarray(texcoords) if texcoords.shape[0] else None,
                tangents=np.ascontiguousarray(tangents) if tangents.shape[0] else None,
            )
        )

    # env textures then textures (pixel payloads; HDR env kept, LDR skipped —
    # reference scene-texture sampling is stubbed, Common.cuh:1386-1394)
    n_envtex = r.size()
    for _ in range(n_envtex):
        n_u8 = r.size()
        u8 = r.raw(n_u8)
        n_f = r.size()
        fl = np.frombuffer(r.raw(n_f * 4), np.float32).copy()
        wd, ht, ch = r.ints(3)
        if n_f:
            scene.env_textures.append(fl.reshape(ht, wd, ch)[..., :3])
        del u8
    n_tex = r.size()
    for _ in range(n_tex):
        n_u8 = r.size()
        u8 = np.frombuffer(r.raw(n_u8), np.uint8).copy()
        n_f = r.size()
        r.raw(n_f * 4)
        wd, ht, ch = r.ints(3)
        # keep the LDR pixels so textures can be *enabled* on this scene
        # (Scene.textures_enabled stays False by default = the reference's
        # stubbed fetch, Common.cuh:1386-1394)
        if n_u8 and n_u8 == wd * ht * ch:
            scene.textures.append(u8.reshape(ht, wd, ch))
        else:
            scene.textures.append(np.full((1, 1, 4), 255, np.uint8))

    names = {}
    for key in ("camera", "instance", "shape", "material", "texture", "envtex", "env"):
        names[key] = r.strvec()

    for k, (t, shape_id, mat_id) in enumerate(inst_raw):
        nm = names["instance"][k] if k < len(names["instance"]) else f"instance{k}"
        scene.instances.append(
            Instance(shape=int(shape_id), material=int(mat_id), transform=t, name=nm)
        )
    for k, s in enumerate(scene.shapes):
        if k < len(names["shape"]):
            s.name = names["shape"][k]
    return scene
