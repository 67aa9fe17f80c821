from svgf_tpu_torch.io.binscene import load_reference_scene
from svgf_tpu_torch.io.objloader import load_obj
from svgf_tpu_torch.io.gltf import load_gltf
from svgf_tpu_torch.io.serialization import (
    save_scene_npz,
    load_scene_npz,
    save_checkpoint,
    load_checkpoint,
)
from svgf_tpu_torch.io.assets import load_asset

__all__ = [
    "load_reference_scene",
    "load_obj",
    "load_gltf",
    "load_asset",
    "save_scene_npz",
    "load_scene_npz",
    "save_checkpoint",
    "load_checkpoint",
]
