"""Configuration dataclasses, shared with svgf_tpu unchanged: svgf_tpu's
config module imports no JAX, so both packages read one RenderConfig."""

from svgf_tpu.config import DebugOutput, RenderConfig, SamplingMode, SVGFConfig, TracingConfig

__all__ = ["DebugOutput", "RenderConfig", "SamplingMode", "SVGFConfig", "TracingConfig"]
