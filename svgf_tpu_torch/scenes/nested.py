"""Nested instances: a scene whose scene BVH is deep.

Instance k of n is one small heightfield (`heightfield_shape(11, extent=1.0)`,
200 triangles) scaled s^k in x and z and raised 0.01 k: n sheets nested one
inside the next. The agglomerative instance tree nests their boxes the same
way, so the scene BVH's depth grows with n (n=100, s=1.05: 20,002 world
triangles, depth 79), where the terrain of scenes/stress.py, with five
times the triangles, has depth 21. The scene takes the large-scene path
(over DENSE_MAX_TRIS triangles), and K6 keeps the entries past its
64-entry stack in a global scratch (kernels/intersect.py spill_entries).
The camera looks up at the sheets' undersides from below the nest,
beside a quad light, and sees nearly every sheet; its rays start inside
many of the nested boxes, where a walk holds many levels of the tree on
its stack at once.
"""

from __future__ import annotations

import numpy as np

from svgf_tpu_torch.core.camera import Camera, look_at_frame
from svgf_tpu_torch.core.scene import Instance, Material, Scene
from svgf_tpu_torch.scenes.default_scene import _plane
from svgf_tpu_torch.scenes.stress import heightfield_shape

EYE = (0.5, -0.3, 0.5)
TARGET = (0.0, 0.5, 0.0)


def nested_scene(n: int = 100, scale: float = 1.05, aspect: float = 16.0 / 9.0) -> Scene:
    """n nested heightfield sheets, a quad light below them and a camera
    looking up into the nest: 200 n + 2 triangles."""
    scene = Scene()
    scene.shapes.append(heightfield_shape(11, extent=1.0))
    scene.shapes.append(_plane())
    scene.materials.append(Material(colour=(0.65, 0.62, 0.58), roughness=0.8))
    scene.materials.append(Material(emission=(30.0, 30.0, 30.0)))
    for k in range(n):
        t = np.eye(4, dtype=np.float32)
        t[0, 0] = t[2, 2] = scale ** k
        t[1, 3] = 0.01 * k
        scene.instances.append(Instance(shape=0, material=0, transform=t, name=f"sheet{k}"))
    light_t = np.diag([0.8, 1.0, 0.8, 1.0]).astype(np.float32)
    light_t[1, 3] = -0.7
    scene.instances.append(Instance(shape=1, material=1, transform=light_t, name="light"))
    scene.cameras.append(Camera(frame=look_at_frame(eye=list(EYE), target=list(TARGET)),
                                fov=100.0, aspect=aspect))
    return scene
