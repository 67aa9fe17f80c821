"""Asset dispatch by extension (reference AssetLoader.cpp:11-56).

Mesh formats: glTF/GLB (own materials + instances), OBJ, PLY (ascii/binary),
STL (ascii/binary), OFF — the Assimp-breadth surface the reference reaches
through AssimpLoader.cpp:171-192 — plus the reference's binary .scene format
(io.binscene).

A copy of svgf_tpu/io/assets.py over the port's host classes.
"""

from __future__ import annotations

import numpy as np

from svgf_tpu_torch.core.scene import Instance, Scene


def load_asset(path: str, scene: Scene, material: int = 0,
               transform: np.ndarray | None = None) -> Scene:
    """Load a model file into `scene`, adding shapes + instances.

    glTF files carry their own materials/instances; OBJ adds one instance
    bound to `material` with `transform`.
    """
    low = path.lower()
    if low.endswith((".gltf", ".glb")):
        from svgf_tpu_torch.io.gltf import load_gltf

        return load_gltf(path, scene)
    mesh_loaders = None
    if low.endswith(".obj"):
        from svgf_tpu_torch.io.objloader import load_obj

        mesh_loaders = load_obj
    elif low.endswith(".ply"):
        from svgf_tpu_torch.io.plyloader import load_ply

        mesh_loaders = load_ply
    elif low.endswith(".stl"):
        from svgf_tpu_torch.io.stlloader import load_stl

        mesh_loaders = load_stl
    elif low.endswith(".off"):
        from svgf_tpu_torch.io.stlloader import load_off

        mesh_loaders = load_off
    if mesh_loaders is not None:
        shape = mesh_loaders(path)
        scene.shapes.append(shape)
        scene.instances.append(
            Instance(
                shape=len(scene.shapes) - 1,
                material=material,
                transform=transform if transform is not None else np.eye(4, dtype=np.float32),
                name=shape.name,
            )
        )
        return scene
    if low.endswith((".bin", ".scene")) or "/Scenes/" in path or low.endswith("basescene"):
        from svgf_tpu_torch.io.binscene import load_reference_scene

        loaded = load_reference_scene(path)
        if not scene.shapes and not scene.instances:
            return loaded
        raise ValueError("binary scenes can only be loaded into an empty scene")
    raise ValueError(f"unsupported asset type: {path}")
