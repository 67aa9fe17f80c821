"""The reference's default scene (Scene.cpp:375-429): a floor plane and an
emissive quad light above it, one camera (a copy of
svgf_tpu/scenes/default_scene.py over the port's host classes)."""

from __future__ import annotations

import numpy as np

from svgf_tpu_torch.core.camera import Camera, look_at_frame
from svgf_tpu_torch.core.scene import Instance, Material, Scene, Shape


def _plane() -> Shape:
    """Unit plane in XZ, like resources/models/BaseShapes/Plane/Plane.obj."""
    pos = np.array(
        [[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5], [-0.5, 0, 0.5]], np.float32
    )
    idx = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return Shape(positions=pos, indices=idx, uvs=uv, name="plane")


def default_scene(aspect: float = 800.0 / 600.0) -> Scene:
    scene = Scene()
    scene.shapes.append(_plane())

    scene.materials.append(Material(colour=(0.725, 0.71, 0.68)))      # "Base"
    scene.materials.append(Material(emission=(40.0, 40.0, 40.0)))     # "Light"

    floor_t = np.diag([4.0, 4.0, 4.0, 1.0]).astype(np.float32)
    floor_t[1, 3] = -1.0
    scene.instances.append(Instance(shape=0, material=0, transform=floor_t, name="Floor"))

    light_t = np.eye(4, dtype=np.float32)
    light_t[1, 3] = 2.0
    scene.instances.append(Instance(shape=0, material=1, transform=light_t, name="Light"))

    cam = Camera(
        frame=look_at_frame(eye=[0.0, 1.0, 4.0], target=[0.0, 0.0, 0.0]),
        fov=60.0,
        aspect=aspect,
    )
    scene.cameras.append(cam)
    return scene
