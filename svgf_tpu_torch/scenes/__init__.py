from svgf_tpu_torch.scenes.cornell import cornell_box
from svgf_tpu_torch.scenes.default_scene import default_scene

__all__ = ["cornell_box", "default_scene"]
