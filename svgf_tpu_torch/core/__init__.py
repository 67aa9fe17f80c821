from svgf_tpu_torch.core.camera import Camera, look_at_frame, perspective, orbit_frame
from svgf_tpu_torch.core.scene import (
    MaterialType,
    Material,
    Shape,
    Instance,
    Environment,
    Scene,
    SceneArrays,
    INVALID_ID,
)
from svgf_tpu_torch.core.lights import build_lights

__all__ = [
    "Camera",
    "look_at_frame",
    "perspective",
    "orbit_frame",
    "MaterialType",
    "Material",
    "Shape",
    "Instance",
    "Environment",
    "Scene",
    "SceneArrays",
    "INVALID_ID",
    "build_lights",
]
