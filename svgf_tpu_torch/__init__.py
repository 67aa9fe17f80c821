"""svgf_tpu_torch — the PyTorch + CUDA port of svgf_tpu for NVIDIA Hopper.

The same renderer as svgf_tpu (a hybrid 1spp path tracer with a G-buffer
pass and the SVGF denoiser), written as plain torch functions with the
filter stencils and the two intersectors as hand-written CUDA kernels
(csrc/, kernels/). Module paths mirror svgf_tpu's, so each port module
sits where its JAX counterpart does; svgf_tpu stays the reference the
tests hold it against. The port imports neither JAX nor svgf_tpu: it keeps
its own copies of the JAX-free modules it needs (config, accel).

    from svgf_tpu_torch import RenderConfig
    from svgf_tpu_torch.scenes import cornell_box
    from svgf_tpu_torch.render.pipeline import Renderer

    r = Renderer(cornell_box(aspect=16/9), RenderConfig(width=640, height=360))
    out = r.step()   # on the card; Renderer(..., device="cpu") runs on the CPU

The package namespaces export what svgf_tpu's do (`svgf_tpu_torch.core`,
`.accel`, `.scenes`, `.io`, `.parallel`), so svgf_tpu's imports work with
only the package name changed.
"""

__version__ = "0.1.0"

from svgf_tpu_torch.config import RenderConfig, SVGFConfig, TracingConfig, SamplingMode, DebugOutput

__all__ = [
    "RenderConfig",
    "SVGFConfig",
    "TracingConfig",
    "SamplingMode",
    "DebugOutput",
]
