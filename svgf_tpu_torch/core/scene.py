"""Scene data model + flattening to device tensors.

The host classes are NumPy copies of svgf_tpu/core/scene.py (Material,
Shape, Instance, Environment, Scene, SceneMeta): that module imports JAX.
`Scene.flatten(device=...)` runs the same host build and ends in
`torch.as_tensor` where the JAX version ends in `jnp.asarray`, so both
packages hold bit-identical scene data when both build BVHs and tangents
the same way: natively (the default; accel/native.py,
tests/test_torch_native.py) or with NumPy under SVGF_NATIVE=0
(tests/test_torch_convert.py, tests/test_torch_intersect.py).

Scenes over `ops.intersect.DENSE_MAX_TRIS` world triangles get svgf_tpu's
large-scene layout: the soup in BLAS-leaf order, padded to whole
superclusters, with cluster bounds and the stitched world-space scene BVH
(`wbvh_*`). With `textures_enabled`, the scene textures become the
(K, 256, 256, 4) u8 stack of `core/textures.py`, a colour texture whose
alpha falls below 1 sets `has_opacity`, and a normal texture sets
`has_normal_maps`, as in svgf_tpu.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from svgf_tpu_torch.accel import native
from svgf_tpu_torch.accel.bvh import (
    BLAS, FlatBVH, _transform_aabbs, build_blas, build_scene_bvh, flatten_blases,
)
from svgf_tpu_torch.accel.clusters import CLUSTER_TRIS, SUPER_CLUSTERS, compute_cluster_bounds
from svgf_tpu_torch.core.lights import build_lights
from svgf_tpu_torch.core.textures import build_texture_stack, resize_nearest, texture_alpha_min
from svgf_tpu_torch.ops.intersect import DENSE_MAX_TRIS

INVALID_ID = -1


class MaterialType(enum.IntEnum):
    """Reference Scene.h:11-15."""

    MATTE = 0
    PBR = 1
    VOLUMETRIC = 2
    GLASS = 3
    SUBSURFACE = 4


@dataclasses.dataclass
class Material:
    """Reference material POD (Scene.h:69-89)."""

    emission: tuple = (0.0, 0.0, 0.0)
    colour: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.0
    metallic: float = 0.0
    anisotropy: float = 0.0
    material_type: MaterialType = MaterialType.MATTE
    opacity: float = 1.0
    scattering_colour: tuple = (0.0, 0.0, 0.0)
    transmission_depth: float = 0.01
    emission_texture: int = INVALID_ID
    colour_texture: int = INVALID_ID
    roughness_texture: int = INVALID_ID
    normal_texture: int = INVALID_ID


@dataclasses.dataclass
class Shape:
    """A triangle mesh. PreProcess follows reference Scene.cpp:163-285."""

    positions: np.ndarray                  # (V, 3) f32
    indices: np.ndarray                    # (F, 3) i32
    normals: np.ndarray | None = None      # (V, 3)
    uvs: np.ndarray | None = None          # (V, 2)
    tangents: np.ndarray | None = None     # (V, 4)
    name: str = "shape"

    # filled by preprocess():
    tri_pos: np.ndarray | None = None      # (F, 3, 3)
    tri_nrm: np.ndarray | None = None      # (F, 3, 3)
    tri_uv: np.ndarray | None = None       # (F, 3, 2)
    tri_tan: np.ndarray | None = None      # (F, 3, 4)
    blas: BLAS | None = None

    def preprocess(self) -> "Shape":
        P = np.asarray(self.positions, dtype=np.float32)
        F = np.asarray(self.indices, dtype=np.int64)
        if self.normals is None:
            # flat per-face normals scattered to vertices (Scene.cpp:166-180)
            N = np.zeros_like(P)
            v0, v1, v2 = P[F[:, 0]], P[F[:, 1]], P[F[:, 2]]
            fn = np.cross(v1 - v0, v2 - v0)
            fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
            N[F[:, 0]] = fn
            N[F[:, 1]] = fn
            N[F[:, 2]] = fn
            self.normals = N
        if self.uvs is None:
            self.uvs = np.zeros((P.shape[0], 2), dtype=np.float32)
        if self.tangents is None and native.enabled():
            self.tangents = native.tangents_native(
                P, np.asarray(self.normals, np.float32), np.asarray(self.uvs, np.float32),
                F.astype(np.int32),
            )
        if self.tangents is None:
            # SVGF_NATIVE=0: svgf_tpu's NumPy reference method
            self.tangents = _lengyel_tangents(
                P, np.asarray(self.normals), np.asarray(self.uvs), F
            )

        self.tri_pos = P[F]                                   # (F,3,3)
        self.tri_nrm = np.asarray(self.normals, np.float32)[F]
        self.tri_uv = np.asarray(self.uvs, np.float32)[F]
        self.tri_tan = np.asarray(self.tangents, np.float32)[F]
        self.blas = build_blas(self.tri_pos)
        return self

    @property
    def n_triangles(self) -> int:
        return int(np.asarray(self.indices).shape[0])


def _lengyel_tangents(P: np.ndarray, N: np.ndarray, UV: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Per-vertex tangents, Lengyel's method (reference Scene.cpp:111-161)."""
    tan1 = np.zeros((P.shape[0], 3), dtype=np.float64)
    tan2 = np.zeros((P.shape[0], 3), dtype=np.float64)
    v1, v2, v3 = P[F[:, 0]], P[F[:, 1]], P[F[:, 2]]
    w1, w2, w3 = UV[F[:, 0]], UV[F[:, 1]], UV[F[:, 2]]
    e1 = (v2 - v1).astype(np.float64)
    e2 = (v3 - v1).astype(np.float64)
    s1 = (w2 - w1).astype(np.float64)
    s2 = (w3 - w1).astype(np.float64)
    det = s1[:, 0] * s2[:, 1] - s2[:, 0] * s1[:, 1]
    r = np.where(np.abs(det) > 1e-20, 1.0 / np.where(det == 0, 1.0, det), 0.0)[:, None]
    sdir = (s2[:, 1:2] * e1 - s1[:, 1:2] * e2) * r
    tdir = (s1[:, 0:1] * e2 - s2[:, 0:1] * e1) * r
    for k in range(3):
        np.add.at(tan1, F[:, k], sdir)
        np.add.at(tan2, F[:, k], tdir)
    n = N.astype(np.float64)
    t = tan1
    ortho = t - n * np.sum(n * t, axis=-1, keepdims=True)
    norm = np.linalg.norm(ortho, axis=-1, keepdims=True)
    # degenerate UVs: fall back to an arbitrary perpendicular
    fallback = np.cross(n, np.where(np.abs(n[:, 0:1]) < 0.9,
                                    np.array([[1.0, 0, 0]]), np.array([[0, 1.0, 0]])))
    ortho = np.where(norm > 1e-12, ortho, fallback)
    ortho /= np.maximum(np.linalg.norm(ortho, axis=-1, keepdims=True), 1e-20)
    w = np.where(np.sum(np.cross(n, t) * tan2, axis=-1) < 0.0, -1.0, 1.0)
    return np.concatenate([ortho, w[:, None]], axis=-1).astype(np.float32)


@dataclasses.dataclass
class Instance:
    """Reference instance (Scene.h:104-115): transform + shape/material refs."""

    shape: int
    material: int
    transform: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))
    name: str = "instance"


@dataclasses.dataclass
class Environment:
    """IBL environment (Scene.h:161-170)."""

    emission: tuple = (1.0, 1.0, 1.0)
    transform: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))
    emission_texture: int = INVALID_ID


# ---------------------------------------------------------------------------
# Device-side flattened scene
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static scene topology (svgf_tpu/core/scene.py SceneMeta): the host
    reads it to decide which branches the tracer runs."""

    n_instances: int
    n_lights: int
    n_envs: int
    light_instance: tuple      # per light: instance id or -1
    light_env: tuple           # per light: environment id or -1
    light_cdf_start: tuple
    light_cdf_count: tuple
    light_tri_start: tuple     # per light: global triangle base of its shape (-1 env)
    env_tex: tuple             # per environment: emission texture id or -1
    n_world_tris: int = 0      # unpadded world-triangle-soup size
    inst_world_range: tuple = ()  # per instance: (start, count) in the soup
    has_media: bool = False    # any VOLUMETRIC/GLASS/SUBSURFACE material
    has_opacity: bool = False  # any material with opacity < 1
    textures_enabled: bool = False
    has_normal_maps: bool = False
    has_scene_bvh: bool = False
    soup_leaf_order: bool = False
    mat_types_used: tuple = (0, 1, 2, 3, 4)


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """Every device tensor of a flattened scene. The fields, their shapes
    and dtypes are those of svgf_tpu's SceneArrays (core/scene.py:215-310)."""

    meta: SceneMeta

    tri_pos: torch.Tensor       # (T, 3, 3) f32
    tri_nrm: torch.Tensor       # (T, 3, 3) f32
    tri_uv: torch.Tensor        # (T, 3, 2) f32
    tri_tan: torch.Tensor       # (T, 3, 4) f32
    bvh_node_min: torch.Tensor  # (N, 3) f32
    bvh_node_max: torch.Tensor  # (N, 3) f32
    bvh_skip: torch.Tensor      # (N,) i32
    bvh_tri_first: torch.Tensor # (N,) i32
    bvh_tri_count: torch.Tensor # (N,) i32
    bvh_tri_order: torch.Tensor # (O,) i32
    bvh_bounds6: torch.Tensor   # (6, N) f32
    bvh_leaf_tri: torch.Tensor  # (N,) i32
    tri_verts9: torch.Tensor    # (9, T) f32
    world_tris9: torch.Tensor   # (9, TW) f32 world-space soup, padded to 128
                                # (large scenes: BLAS-leaf order, padded to 2048)
    world_tri_inst: torch.Tensor  # (TW,) i32, -1 = padding
    world_tri_mat: torch.Tensor   # (TW,) i32
    world_tri_prim: torch.Tensor  # (TW,) i32
    world_cluster_bounds: torch.Tensor  # (C, 8) large scenes, else (1, 8) zeros
    world_sclust_bounds: torch.Tensor   # (C/16, 8) large scenes, else (1, 8) zeros
    wbvh_bounds6: torch.Tensor  # (6, NW) scene BVH boxes (large scenes), else (6, 1)
    wbvh_skip: torch.Tensor     # (NW,) i32 skip links
    wbvh_leaf_tri: torch.Tensor # (NW,) i32 soup column at leaves, -1 internal
    inst_aabb_min: torch.Tensor # (I, 3) f32
    inst_aabb_max: torch.Tensor # (I, 3) f32
    shape_node_start: torch.Tensor  # (S,) i32
    shape_node_count: torch.Tensor  # (S,) i32
    shape_tri_start: torch.Tensor   # (S,) i32
    shape_tri_count: torch.Tensor   # (S,) i32
    inst_transform: torch.Tensor    # (I, 4, 4) f32
    inst_inv_transform: torch.Tensor
    inst_normal_transform: torch.Tensor
    inst_shape: torch.Tensor        # (I,) i32
    inst_material: torch.Tensor     # (I,) i32
    mat_emission: torch.Tensor      # (M, 3)
    mat_colour: torch.Tensor        # (M, 3)
    mat_roughness: torch.Tensor     # (M,)
    mat_metallic: torch.Tensor      # (M,)
    mat_anisotropy: torch.Tensor    # (M,)
    mat_opacity: torch.Tensor       # (M,)
    mat_scattering: torch.Tensor    # (M, 3)
    mat_transmission_depth: torch.Tensor  # (M,)
    mat_type: torch.Tensor          # (M,) i32
    mat_emission_tex: torch.Tensor  # (M,) i32
    mat_colour_tex: torch.Tensor    # (M,) i32
    mat_roughness_tex: torch.Tensor # (M,) i32
    mat_normal_tex: torch.Tensor    # (M,) i32
    textures: torch.Tensor          # (K, S, S, 4) u8 (textures off: a (1, 1, 2, 4) placeholder)
    light_instance: torch.Tensor    # (L,) i32
    light_env: torch.Tensor         # (L,) i32
    light_cdf_start: torch.Tensor   # (L,) i32
    light_cdf_count: torch.Tensor   # (L,) i32
    lights_cdf: torch.Tensor        # (C,) f32
    light_area: torch.Tensor        # (L,) f32
    env_transform: torch.Tensor     # (E, 4, 4)
    env_inv_transform: torch.Tensor # (E, 4, 4)
    env_emission: torch.Tensor      # (E, 3)
    env_tex: torch.Tensor           # (E,) i32
    env_textures: torch.Tensor      # (K, He, We, 3) f32
    cam_frame: torch.Tensor         # (C, 4, 4)
    cam_prev_frame: torch.Tensor    # (C, 4, 4)
    cam_proj: torch.Tensor          # (C, 4, 4)

    @property
    def device(self) -> torch.device:
        return self.tri_pos.device

    @property
    def n_triangles(self) -> int:
        return self.tri_pos.shape[0]

    @property
    def n_instances(self) -> int:
        return self.inst_shape.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_instance.shape[0]

    @property
    def n_environments(self) -> int:
        return self.env_emission.shape[0]

    @staticmethod
    def tensor_fields() -> list[str]:
        return [f.name for f in dataclasses.fields(SceneArrays) if f.name != "meta"]


def material_flags(materials, tex_alpha) -> dict:
    """The SceneMeta fields that follow from the materials: has_media,
    has_opacity and mat_types_used. `tex_alpha`: each texture's least
    alpha when textures are enabled, else empty."""
    return dict(
        has_media=any(
            m.material_type in (MaterialType.VOLUMETRIC, MaterialType.GLASS,
                                MaterialType.SUBSURFACE)
            for m in materials
        ),
        # the colour texture's alpha folds into opacity (Common.cuh:1458)
        has_opacity=any(
            m.opacity < 1.0
            or (0 <= m.colour_texture < len(tex_alpha) and tex_alpha[m.colour_texture] < 1.0)
            for m in materials
        ),
        mat_types_used=tuple(sorted({int(m.material_type) for m in materials})) or (0,),
    )


def target_device(device) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device when torch sees
    no card (the port never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def as_device_tensor(x, dtype, device) -> torch.Tensor:
    """A host array as a contiguous device tensor of `dtype` (a NumPy dtype)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype))).to(device)


@dataclasses.dataclass
class Scene:
    """Host-side scene container (reference scene struct, Scene.h:172-226)."""

    cameras: list = dataclasses.field(default_factory=list)
    shapes: list = dataclasses.field(default_factory=list)
    instances: list = dataclasses.field(default_factory=list)
    materials: list = dataclasses.field(default_factory=list)
    environments: list = dataclasses.field(default_factory=list)
    env_textures: list = dataclasses.field(default_factory=list)  # (He,We,3) float arrays
    textures: list = dataclasses.field(default_factory=list)      # (H,W,4) u8/float images
    textures_enabled: bool = False

    def with_camera(self, index: int, camera) -> "Scene":
        """A copy of the scene with camera `index` replaced (svgf_tpu's
        Scene.with_camera); the shapes and their BVHs are shared."""
        cams = list(self.cameras)
        cams[index] = camera
        return dataclasses.replace(self, cameras=cams)

    def preprocess(self) -> "Scene":
        for s in self.shapes:
            if s.blas is None:
                s.preprocess()
        return self

    def flatten(self, device="cuda") -> SceneArrays:
        """Build every flattened tensor on `device` (reference
        scene::PreProcess). The default is the card; device="cpu" runs on
        the CPU. Shapes keep their BVHs, so a second flatten of the same
        scene does not rebuild them."""
        device = target_device(device)
        self.preprocess()
        shapes = self.shapes

        tri_pos = np.concatenate([s.tri_pos for s in shapes], axis=0)
        tri_nrm = np.concatenate([s.tri_nrm for s in shapes], axis=0)
        tri_uv = np.concatenate([s.tri_uv for s in shapes], axis=0)
        tri_tan = np.concatenate([s.tri_tan for s in shapes], axis=0)
        flat: FlatBVH = flatten_blases([s.blas for s in shapes], [s.n_triangles for s in shapes])

        inst_t = np.stack([np.asarray(i.transform, np.float32) for i in self.instances])
        inst_inv = np.stack([np.linalg.inv(t) for t in inst_t]).astype(np.float32)
        inst_nrm = np.stack([np.linalg.inv(t).T for t in inst_t]).astype(np.float32)

        mats = self.materials
        lights = build_lights(self)

        env_t = (
            np.stack([np.asarray(e.transform, np.float32) for e in self.environments])
            if self.environments
            else np.zeros((0, 4, 4), np.float32)
        )
        env_inv = (
            np.stack([np.linalg.inv(t) for t in env_t]).astype(np.float32)
            if self.environments
            else np.zeros((0, 4, 4), np.float32)
        )
        if self.env_textures:
            envs = [np.asarray(t, np.float32) for t in self.env_textures]
            if len({e.shape for e in envs}) > 1:
                he = max(e.shape[0] for e in envs)
                we = max(e.shape[1] for e in envs)
                envs = [resize_nearest(e, he, we) for e in envs]
            et = np.stack(envs)
        else:
            et = np.zeros((1, 1, 2, 3), np.float32)  # placeholder, never indexed

        cam_frame = np.stack([c.frame for c in self.cameras])
        cam_prev = np.stack([c.previous_frame for c in self.cameras])
        cam_proj = np.stack([c.projection for c in self.cameras])

        total_world = sum(self.shapes[i.shape].n_triangles for i in self.instances)
        # Large scenes: each instance's triangles in BLAS-leaf (DFS) order,
        # so consecutive soup columns are spatially local (svgf_tpu's
        # clustered layout, accel/clusters.py). Small scenes keep the
        # original order, which the dense intersector's tie-break sees.
        soup_leaf_order = total_world > DENSE_MAX_TRIS
        ws9, ws_inst, ws_mat, ws_prim, inst_ws = [], [], [], [], []
        cursor = 0
        for i, inst in enumerate(self.instances):
            sh = self.shapes[inst.shape]
            t = np.asarray(inst.transform, np.float64)
            pw = sh.tri_pos.astype(np.float64) @ t[:3, :3].T + t[:3, 3]  # (F,3,3)
            prim = np.arange(sh.n_triangles, dtype=np.int32)
            if soup_leaf_order:
                order = sh.blas.tri_order.astype(np.int64)
                pw = pw[order]
                prim = prim[order]
            ws9.append(pw.reshape(pw.shape[0], 9).T.astype(np.float32))
            n = sh.n_triangles
            ws_inst.append(np.full(n, i, np.int32))
            ws_mat.append(np.full(n, inst.material, np.int32))
            ws_prim.append(prim + int(flat.shape_tri_start[inst.shape]))
            inst_ws.append((cursor, n))
            cursor += n
        world9 = np.concatenate(ws9, axis=1) if ws9 else np.zeros((9, 0), np.float32)
        tw = world9.shape[1]
        # the large-scene soup is padded to whole superclusters, whose
        # padding clusters get never-hit bounds
        grain = CLUSTER_TRIS * SUPER_CLUSTERS if soup_leaf_order else 128
        tw_pad = max(grain, -(-tw // grain) * grain)
        pad = tw_pad - tw
        world9 = np.pad(world9, ((0, 0), (0, pad)))
        w_inst = np.pad(np.concatenate(ws_inst) if ws_inst else np.zeros(0, np.int32),
                        (0, pad), constant_values=-1)
        w_mat = np.pad(np.concatenate(ws_mat) if ws_mat else np.zeros(0, np.int32),
                       (0, pad))
        w_prim = np.pad(np.concatenate(ws_prim) if ws_prim else np.zeros(0, np.int32),
                        (0, pad))
        if soup_leaf_order:
            cb_np, sb_np = compute_cluster_bounds(world9, w_inst)
        else:
            cb_np = np.zeros((1, 8), np.float32)
            sb_np = np.zeros((1, 8), np.float32)

        # per-instance world AABBs (8-corner transform of the BLAS root box,
        # reference scene::CalculateInstanceTransform, Scene.cpp:355-373)
        if self.instances:
            roots_lo = np.stack(
                [self.shapes[i.shape].blas.root_min for i in self.instances]
            )
            roots_hi = np.stack(
                [self.shapes[i.shape].blas.root_max for i in self.instances]
            )
            i_lo = np.zeros((len(self.instances), 3), np.float32)
            i_hi = np.zeros((len(self.instances), 3), np.float32)
            for k, i in enumerate(self.instances):
                lo, hi = _transform_aabbs(
                    roots_lo[k : k + 1], roots_hi[k : k + 1],
                    np.asarray(i.transform, np.float64),
                )
                i_lo[k], i_hi[k] = lo[0], hi[0]
        else:
            i_lo = np.zeros((0, 3), np.float32)
            i_hi = np.zeros((0, 3), np.float32)

        has_scene_bvh = tw > DENSE_MAX_TRIS
        if has_scene_bvh:
            sbvh = build_scene_bvh(
                i_lo, i_hi,
                np.asarray([i.shape for i in self.instances], np.int32),
                inst_t,
                [s.blas for s in self.shapes],
                np.asarray([r[0] for r in inst_ws], np.int32),
                soup_leaf_order=soup_leaf_order,
            )
            wbvh_bounds6 = np.concatenate([sbvh.node_min.T, sbvh.node_max.T], axis=0)
            wbvh_skip = sbvh.skip
            wbvh_leaf = sbvh.leaf_tri
        else:
            wbvh_bounds6 = np.zeros((6, 1), np.float32)
            wbvh_skip = np.ones((1,), np.int32)
            wbvh_leaf = np.full((1,), -1, np.int32)

        light_tri_start = tuple(
            int(flat.shape_tri_start[self.instances[int(li)].shape]) if li >= 0 else -1
            for li in lights.instance
        )
        tex_on = bool(self.textures_enabled and self.textures)
        tex_stack = build_texture_stack(self.textures if tex_on else [])
        tex_alpha = texture_alpha_min(self.textures) if tex_on else []

        meta = SceneMeta(
            n_instances=len(self.instances),
            n_lights=int(lights.instance.shape[0]),
            n_envs=len(self.environments),
            light_instance=tuple(int(x) for x in lights.instance),
            light_env=tuple(int(x) for x in lights.environment),
            light_cdf_start=tuple(int(x) for x in lights.cdf_start),
            light_cdf_count=tuple(int(x) for x in lights.cdf_count),
            light_tri_start=light_tri_start,
            env_tex=tuple(int(e.emission_texture) for e in self.environments),
            n_world_tris=tw,
            inst_world_range=tuple(inst_ws),
            textures_enabled=tex_on,
            has_normal_maps=tex_on and any(m.normal_texture >= 0 for m in self.materials),
            has_scene_bvh=has_scene_bvh,
            soup_leaf_order=soup_leaf_order,
            **material_flags(self.materials, tex_alpha),
        )
        assert len(self.instances) < 65536, (
            f"{len(self.instances)} instances; ids must fit u16/f32 exactly"
        )

        f32 = lambda x: as_device_tensor(x, np.float32, device)
        i32 = lambda x: as_device_tensor(x, np.int32, device)
        return SceneArrays(
            meta=meta,
            tri_pos=f32(tri_pos),
            tri_nrm=f32(tri_nrm),
            tri_uv=f32(tri_uv),
            tri_tan=f32(tri_tan),
            bvh_node_min=f32(flat.node_min),
            bvh_node_max=f32(flat.node_max),
            bvh_skip=i32(flat.skip),
            bvh_tri_first=i32(flat.tri_first),
            bvh_tri_count=i32(flat.tri_count),
            bvh_tri_order=i32(flat.tri_order),
            bvh_bounds6=f32(
                np.concatenate([flat.node_min.T, flat.node_max.T], axis=0)
            ),
            bvh_leaf_tri=i32(
                np.where(
                    flat.tri_count > 0,
                    flat.tri_order[np.clip(flat.tri_first, 0, max(len(flat.tri_order) - 1, 0))],
                    -1,
                )
            ),
            tri_verts9=f32(tri_pos.reshape(tri_pos.shape[0], 9).T),
            world_tris9=f32(world9),
            world_tri_inst=i32(w_inst),
            world_tri_mat=i32(w_mat),
            world_tri_prim=i32(w_prim),
            world_cluster_bounds=f32(cb_np),
            world_sclust_bounds=f32(sb_np),
            wbvh_bounds6=f32(wbvh_bounds6),
            wbvh_skip=i32(wbvh_skip),
            wbvh_leaf_tri=i32(wbvh_leaf),
            inst_aabb_min=f32(i_lo),
            inst_aabb_max=f32(i_hi),
            shape_node_start=i32(flat.shape_node_start),
            shape_node_count=i32(flat.shape_node_count),
            shape_tri_start=i32(flat.shape_tri_start),
            shape_tri_count=i32([s.n_triangles for s in shapes]),
            inst_transform=f32(inst_t),
            inst_inv_transform=f32(inst_inv),
            inst_normal_transform=f32(inst_nrm),
            inst_shape=i32([i.shape for i in self.instances]),
            inst_material=i32([i.material for i in self.instances]),
            mat_emission=f32([m.emission for m in mats]),
            mat_colour=f32([m.colour for m in mats]),
            mat_roughness=f32([m.roughness for m in mats]),
            mat_metallic=f32([m.metallic for m in mats]),
            mat_anisotropy=f32([m.anisotropy for m in mats]),
            mat_opacity=f32([m.opacity for m in mats]),
            mat_scattering=f32([m.scattering_colour for m in mats]),
            mat_transmission_depth=f32([m.transmission_depth for m in mats]),
            mat_type=i32([int(m.material_type) for m in mats]),
            mat_emission_tex=i32([m.emission_texture for m in mats]),
            mat_colour_tex=i32([m.colour_texture for m in mats]),
            mat_roughness_tex=i32([m.roughness_texture for m in mats]),
            mat_normal_tex=i32([m.normal_texture for m in mats]),
            textures=as_device_tensor(tex_stack, np.uint8, device),
            light_instance=i32(lights.instance),
            light_env=i32(lights.environment),
            light_cdf_start=i32(lights.cdf_start),
            light_cdf_count=i32(lights.cdf_count),
            lights_cdf=f32(lights.cdf),
            light_area=f32(lights.total),
            env_transform=f32(env_t),
            env_inv_transform=f32(env_inv),
            env_emission=f32(
                [e.emission for e in self.environments] if self.environments else np.zeros((0, 3))
            ),
            env_tex=i32(
                [e.emission_texture for e in self.environments] if self.environments else []
            ),
            env_textures=f32(et),
            cam_frame=f32(cam_frame),
            cam_prev_frame=f32(cam_prev),
            cam_proj=f32(cam_proj),
        )
