"""Cornell box — the canonical test/benchmark scene (a copy of
svgf_tpu/scenes/cornell.py over the port's host classes)."""

from __future__ import annotations

import numpy as np

from svgf_tpu_torch.core.camera import Camera, look_at_frame
from svgf_tpu_torch.core.scene import Instance, Material, Scene, Shape


def _quad(p0, p1, p2, p3) -> tuple[np.ndarray, np.ndarray]:
    """Two triangles for the quad p0-p1-p2-p3 (counter-clockwise)."""
    pos = np.asarray([p0, p1, p2, p3], dtype=np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
    return pos, idx


def _merge(parts):
    pos, idx = [], []
    off = 0
    for p, i in parts:
        pos.append(p)
        idx.append(i + off)
        off += p.shape[0]
    return np.concatenate(pos), np.concatenate(idx)


def cornell_box(aspect: float = 1.0, with_blocks: bool = True) -> Scene:
    """Classic Cornell box in [-1,1]^3, light at the ceiling.

    Walls/floor/ceiling are separate shapes so each instance can bind its own
    material (white / red / green), mirroring how the reference binds one
    material per instance (Scene.h:104-115).
    """
    s = 1.0
    floor = _quad([-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s])
    ceil = _quad([-s, s, -s], [-s, s, s], [s, s, s], [s, s, -s])
    back = _quad([-s, -s, -s], [-s, s, -s], [s, s, -s], [s, -s, -s])
    left = _quad([-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s])
    right = _quad([s, -s, -s], [s, s, -s], [s, s, s], [s, -s, s])
    white_pos, white_idx = _merge([floor, ceil, back])

    # area light: a small quad just below the ceiling
    l = 0.35
    light = _quad([-l, s - 1e-3, -l], [-l, s - 1e-3, l], [l, s - 1e-3, l], [l, s - 1e-3, -l])

    parts = []
    if with_blocks:
        # tall box and short box (axis-aligned approximations of the classic)
        def box(cx, cz, hx, hy, hz, rot_deg):
            c, si = np.cos(np.radians(rot_deg)), np.sin(np.radians(rot_deg))
            R = np.array([[c, 0, si], [0, 1, 0], [-si, 0, c]])
            corners = np.array(
                [
                    [dx * hx, dy * hy, dz * hz]
                    for dy in (0, 2)
                    for dx in (-1, 1)
                    for dz in (-1, 1)
                ]
            )
            corners = corners @ R.T + np.array([cx, -s, cz])
            q = []
            idx_faces = [
                (0, 1, 3, 2),  # bottom
                (4, 6, 7, 5),  # top
                (0, 2, 6, 4),
                (1, 5, 7, 3),
                (0, 4, 5, 1),
                (2, 3, 7, 6),
            ]
            for f in idx_faces:
                q.append(_quad(corners[f[0]], corners[f[1]], corners[f[2]], corners[f[3]]))
            return _merge(q)

        parts.append(box(-0.35, -0.3, 0.3, 1.2 / 2, 0.3, 18))
        parts.append(box(0.4, 0.35, 0.28, 0.6 / 2, 0.28, -17))

    scene = Scene()
    scene.shapes.append(Shape(positions=white_pos, indices=white_idx, name="white_walls"))
    scene.shapes.append(Shape(positions=left[0], indices=left[1], name="left_wall"))
    scene.shapes.append(Shape(positions=right[0], indices=right[1], name="right_wall"))
    scene.shapes.append(Shape(positions=light[0], indices=light[1], name="light"))

    scene.materials.append(Material(colour=(0.725, 0.71, 0.68)))   # white
    scene.materials.append(Material(colour=(0.63, 0.065, 0.05)))   # red
    scene.materials.append(Material(colour=(0.14, 0.45, 0.091)))   # green
    scene.materials.append(Material(colour=(0.0, 0.0, 0.0), emission=(17.0, 12.0, 4.0)))

    scene.instances.append(Instance(shape=0, material=0, name="walls"))
    scene.instances.append(Instance(shape=1, material=1, name="left"))
    scene.instances.append(Instance(shape=2, material=2, name="right"))
    scene.instances.append(Instance(shape=3, material=3, name="light"))

    if with_blocks:
        for n, (p, i) in enumerate(parts):
            scene.shapes.append(Shape(positions=p, indices=i, name=f"block{n}"))
            scene.instances.append(
                Instance(shape=len(scene.shapes) - 1, material=0, name=f"block{n}")
            )

    cam = Camera(
        frame=look_at_frame(eye=[0.0, 0.0, 3.4], target=[0.0, 0.0, 0.0]),
        fov=40.0,
        aspect=aspect,
    )
    scene.cameras.append(cam)
    return scene
