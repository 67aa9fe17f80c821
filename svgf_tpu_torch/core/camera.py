"""Camera model — perspective camera with current + previous frame.

A NumPy copy of svgf_tpu/core/camera.py: that package's
`core/__init__.py` imports `core/scene.py`, which imports JAX.

Semantics follow the reference camera (Scene.h:37-49, Scene.cpp:100-109):
`Frame` is the camera-to-world matrix, `PreviousFrame` feeds motion vectors,
and the projection is glm::perspective(radians(FOV), aspect, 0.001, 1000).

Conventions used throughout svgf_tpu_torch (the same as svgf_tpu):
  - world space: right-handed, camera looks down its local -Z (GL style)
  - image space: row 0 is the TOP of the image; pixel coord = (x=col, y=row)
  - NDC: x right in [-1,1], y UP in [-1,1] (flipped when mapping to rows)
"""

from __future__ import annotations

import dataclasses

import numpy as np

NEAR = 0.001
FAR = 1000.0


def perspective(fov_deg: float, aspect: float, near: float = NEAR, far: float = FAR) -> np.ndarray:
    """glm::perspective — returns a 4x4 row-major math matrix (clip = P @ view)."""
    t = np.tan(np.radians(fov_deg) / 2.0)
    p = np.zeros((4, 4), dtype=np.float64)
    p[0, 0] = 1.0 / (aspect * t)
    p[1, 1] = 1.0 / t
    p[2, 2] = -(far + near) / (far - near)
    p[2, 3] = -(2.0 * far * near) / (far - near)
    p[3, 2] = -1.0
    return p.astype(np.float32)


def look_at_frame(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world frame: camera looks down -Z toward `target`."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    frame = np.eye(4, dtype=np.float64)
    frame[:3, 0] = right
    frame[:3, 1] = true_up
    frame[:3, 2] = -fwd  # -Z is forward
    frame[:3, 3] = eye
    return frame.astype(np.float32)


def orbit_frame(target, distance: float, theta: float, phi: float, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Spherical-orbit camera frame (reference CameraController.cpp:41-95 analogue).

    theta: azimuth around `up` (radians); phi: elevation from the horizontal plane.
    """
    target = np.asarray(target, dtype=np.float64)
    eye = target + distance * np.array(
        [np.cos(phi) * np.sin(theta), np.sin(phi), np.cos(phi) * np.cos(theta)]
    )
    return look_at_frame(eye, target, up)


@dataclasses.dataclass
class Camera:
    frame: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))
    previous_frame: np.ndarray | None = None  # defaults to `frame`
    fov: float = 60.0
    aspect: float = 1.0

    def __post_init__(self):
        self.frame = np.asarray(self.frame, dtype=np.float32)
        if self.previous_frame is None:
            self.previous_frame = self.frame.copy()
        self.previous_frame = np.asarray(self.previous_frame, dtype=np.float32)

    @property
    def projection(self) -> np.ndarray:
        return perspective(self.fov, self.aspect)

    def advance(self, new_frame: np.ndarray) -> "Camera":
        """Functional frame-advance: previous <- current, current <- new.

        Mirrors application::EndFrame (App.cu:372): PreviousFrame = Frame.
        """
        return Camera(
            frame=np.asarray(new_frame, dtype=np.float32),
            previous_frame=self.frame.copy(),
            fov=self.fov,
            aspect=self.aspect,
        )

    def flat(self) -> dict[str, np.ndarray]:
        return {
            "frame": self.frame,
            "prev_frame": self.previous_frame,
            "proj": self.projection,
            "fov": np.float32(self.fov),
            "aspect": np.float32(self.aspect),
        }
