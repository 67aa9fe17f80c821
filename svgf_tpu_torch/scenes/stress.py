"""Large-scene stress geometry (a copy of svgf_tpu/scenes/stress.py over the
port's host classes).

A procedural bumpy heightfield of any triangle count: spatially coherent
geometry with real depth complexity (self-occluding ridges), the class of
scene over DENSE_MAX_TRIS triangles that the scene-BVH intersector serves
(ops/intersect.py, csrc/intersect_clustered.cu). It needs no asset file.
"""

from __future__ import annotations

import numpy as np

from svgf_tpu_torch.core.camera import Camera, look_at_frame
from svgf_tpu_torch.core.scene import Instance, Material, Scene, Shape
from svgf_tpu_torch.scenes.default_scene import _plane


def heightfield_shape(n: int = 230, extent: float = 4.0) -> Shape:
    """(n x n)-vertex bumpy grid => 2*(n-1)^2 triangles."""
    u = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    xx, zz = np.meshgrid(u * extent, u * extent)
    yy = 0.35 * (
        np.sin(3.1 * xx) * np.cos(2.7 * zz)
        + 0.5 * np.sin(9.3 * xx + 1.0) * np.sin(8.1 * zz + 2.0)
        + 0.25 * np.cos(21.0 * xx + 0.3) * np.cos(19.0 * zz + 1.7)
    ).astype(np.float32)
    pos = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)

    i = np.arange(n * n).reshape(n, n)
    a = i[:-1, :-1].ravel()
    b = i[:-1, 1:].ravel()
    c = i[1:, 1:].ravel()
    d = i[1:, :-1].ravel()
    idx = np.concatenate(
        [np.stack([a, c, b], axis=1), np.stack([a, d, c], axis=1)], axis=0
    ).astype(np.int32)
    uv = (pos[:, [0, 2]] / extent + 0.5).astype(np.float32)
    return Shape(positions=pos.astype(np.float32), indices=idx, uvs=uv,
                 name=f"heightfield{n}")


def stress_scene(n: int = 230, aspect: float = 16.0 / 9.0) -> Scene:
    """Heightfield + quad area light + camera: 2*(n-1)^2 + 2 world triangles
    (n=230 -> 104,884; n=96 -> 18,052, just over the dense crossover)."""
    scene = Scene()
    scene.shapes.append(heightfield_shape(n))
    scene.shapes.append(_plane())

    scene.materials.append(Material(colour=(0.65, 0.62, 0.58), roughness=0.8))
    scene.materials.append(Material(emission=(30.0, 30.0, 30.0)))

    scene.instances.append(Instance(shape=0, material=0, name="terrain"))
    light_t = np.eye(4, dtype=np.float32)
    light_t[1, 3] = 2.5
    light_t[0, 0] = light_t[2, 2] = 1.5
    scene.instances.append(Instance(shape=1, material=1, transform=light_t, name="light"))

    cam = Camera(
        frame=look_at_frame(eye=[2.2, 1.6, 2.2], target=[0.0, 0.0, 0.0]),
        fov=55.0,
        aspect=aspect,
    )
    scene.cameras.append(cam)
    return scene
