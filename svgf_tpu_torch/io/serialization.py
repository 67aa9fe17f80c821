"""Scene and temporal-state (de)serialization, in svgf_tpu's file formats
(svgf_tpu/io/serialization.py), so that files cross between the packages.

The reference checkpoints only the scene (custom binary, Scene.cpp:515-651)
and never the filter history. Here:
  * scenes round-trip through npz (the idiomatic flat-array form); the
    scene half is a copy of svgf_tpu's, over the port's host classes;
  * TemporalState checkpoints (colour/moments/history/TAA/G-buffer + frame
    index) make orbit sequences resumable deterministically (SURVEY.md §5
    checkpoint/resume).

A checkpoint holds the image layout (H, W, C) at the state's type.
svgf_tpu converts its planar states to that layout when it writes them,
so the port, which has no planar state, reads every checkpoint either
package writes. bfloat16 fields are stored as svgf_tpu stores them: NumPy
has no bfloat16 type, so `np.savez_compressed` keeps their 16-bit
patterns as raw `|V2` items; the port writes the same bits and reads
`V2` fields back as bfloat16 (svgf_tpu's own `load_checkpoint` raises on
them).
"""

from __future__ import annotations

import numpy as np
import torch

from svgf_tpu_torch.core.camera import Camera
from svgf_tpu_torch.core.scene import (
    Environment, Instance, Material, MaterialType, Scene, Shape, target_device,
)
from svgf_tpu_torch.render.types import GBuffer, TemporalState


def save_scene_npz(path: str, scene: Scene) -> None:
    data: dict = {}
    data["n_shapes"] = len(scene.shapes)
    data["n_instances"] = len(scene.instances)
    data["n_materials"] = len(scene.materials)
    data["n_cameras"] = len(scene.cameras)
    data["n_envs"] = len(scene.environments)
    data["n_envtex"] = len(scene.env_textures)
    for i, s in enumerate(scene.shapes):
        data[f"shape{i}_pos"] = np.asarray(s.positions, np.float32)
        data[f"shape{i}_idx"] = np.asarray(s.indices, np.int32)
        if s.normals is not None:
            data[f"shape{i}_nrm"] = np.asarray(s.normals, np.float32)
        if s.uvs is not None:
            data[f"shape{i}_uv"] = np.asarray(s.uvs, np.float32)
        data[f"shape{i}_name"] = np.bytes_(s.name.encode())
    for i, inst in enumerate(scene.instances):
        data[f"inst{i}"] = np.asarray(inst.transform, np.float32)
        data[f"inst{i}_ids"] = np.asarray([inst.shape, inst.material], np.int32)
        data[f"inst{i}_name"] = np.bytes_(inst.name.encode())
    for i, m in enumerate(scene.materials):
        data[f"mat{i}"] = np.asarray(
            list(m.emission) + list(m.colour)
            + [m.roughness, m.metallic, m.anisotropy, float(m.material_type),
               m.opacity, m.transmission_depth]
            + list(m.scattering_colour),
            np.float32,
        )
        data[f"mat{i}_tex"] = np.asarray(
            [m.emission_texture, m.colour_texture, m.roughness_texture,
             m.normal_texture], np.int32,
        )
    data["n_textures"] = len(scene.textures)
    data["textures_enabled"] = bool(scene.textures_enabled)
    for i, t in enumerate(scene.textures):
        data[f"tex{i}"] = np.asarray(t)
    for i, c in enumerate(scene.cameras):
        data[f"cam{i}_frame"] = c.frame
        data[f"cam{i}_prev"] = c.previous_frame
        data[f"cam{i}_meta"] = np.asarray([c.fov, c.aspect], np.float32)
    for i, e in enumerate(scene.environments):
        data[f"env{i}_t"] = np.asarray(e.transform, np.float32)
        data[f"env{i}_meta"] = np.asarray(
            list(e.emission) + [float(e.emission_texture)], np.float32
        )
    for i, t in enumerate(scene.env_textures):
        data[f"envtex{i}"] = np.asarray(t, np.float32)
    np.savez_compressed(path, **data)


def load_scene_npz(path: str) -> Scene:
    z = np.load(path, allow_pickle=False)
    scene = Scene()
    for i in range(int(z["n_shapes"])):
        scene.shapes.append(
            Shape(
                positions=z[f"shape{i}_pos"],
                indices=z[f"shape{i}_idx"],
                normals=z[f"shape{i}_nrm"] if f"shape{i}_nrm" in z else None,
                uvs=z[f"shape{i}_uv"] if f"shape{i}_uv" in z else None,
                name=bytes(z[f"shape{i}_name"]).decode(),
            )
        )
    for i in range(int(z["n_instances"])):
        ids = z[f"inst{i}_ids"]
        scene.instances.append(
            Instance(
                shape=int(ids[0]), material=int(ids[1]),
                transform=z[f"inst{i}"],
                name=bytes(z[f"inst{i}_name"]).decode(),
            )
        )
    for i in range(int(z["n_materials"])):
        v = z[f"mat{i}"]
        tex = z[f"mat{i}_tex"] if f"mat{i}_tex" in z else np.full(4, -1, np.int32)
        scene.materials.append(
            Material(
                emission=tuple(v[0:3]), colour=tuple(v[3:6]),
                roughness=float(v[6]), metallic=float(v[7]), anisotropy=float(v[8]),
                material_type=MaterialType(int(v[9])), opacity=float(v[10]),
                transmission_depth=float(v[11]), scattering_colour=tuple(v[12:15]),
                emission_texture=int(tex[0]), colour_texture=int(tex[1]),
                roughness_texture=int(tex[2]), normal_texture=int(tex[3]),
            )
        )
    for i in range(int(z["n_cameras"])):
        meta = z[f"cam{i}_meta"]
        scene.cameras.append(
            Camera(
                frame=z[f"cam{i}_frame"], previous_frame=z[f"cam{i}_prev"],
                fov=float(meta[0]), aspect=float(meta[1]),
            )
        )
    for i in range(int(z["n_envs"])):
        meta = z[f"env{i}_meta"]
        scene.environments.append(
            Environment(
                transform=z[f"env{i}_t"], emission=tuple(meta[0:3]),
                emission_texture=int(meta[3]),
            )
        )
    for i in range(int(z["n_envtex"])):
        scene.env_textures.append(z[f"envtex{i}"])
    if "n_textures" in z:
        for i in range(int(z["n_textures"])):
            scene.textures.append(z[f"tex{i}"])
        scene.textures_enabled = bool(z["textures_enabled"])
    return scene


# ---------------------------------------------------------------------------
# temporal-state checkpoints
# ---------------------------------------------------------------------------


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A state tensor as the array svgf_tpu writes for it: bfloat16 as its
    16-bit patterns in `V2` items, every other type as itself."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _to_tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A checkpoint array on `device`; `V2` items are bfloat16 bits. A
    floating field is cast to `dtype` when one is given."""
    if a.dtype == np.dtype("V2"):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def save_checkpoint(path: str, state: TemporalState) -> None:
    """Checkpoint a TemporalState in svgf_tpu's format: each field as its
    array (`_to_numpy`), `frame_idx` as an int32 scalar."""
    np.savez_compressed(
        path,
        color=_to_numpy(state.color), moments=_to_numpy(state.moments),
        history_len=_to_numpy(state.history_len),
        taa_history=_to_numpy(state.taa_history),
        frame_idx=np.asarray(state.frame_idx, np.int32),
        **{f"g_{k}": _to_numpy(v) for k, v in state.gbuffer._asdict().items()},
    )


def load_checkpoint(path: str, dtype: torch.dtype | None = None, device="cuda") -> TemporalState:
    """A checkpoint of either package as the port's TemporalState on
    `device` (the card unless the caller asks for the CPU). Floating
    fields keep their stored type, or are cast to `dtype`; integer fields
    keep theirs; `frame_idx` becomes a host int."""
    device = target_device(device)
    z = np.load(path)
    field = lambda name: _to_tensor(z[name], dtype, device)
    return TemporalState(
        color=field("color"), moments=field("moments"),
        history_len=field("history_len"), taa_history=field("taa_history"),
        gbuffer=GBuffer(**{k: field(f"g_{k}") for k in GBuffer._fields}),
        frame_idx=int(z["frame_idx"]),
    )
