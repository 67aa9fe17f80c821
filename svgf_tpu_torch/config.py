"""Configuration dataclasses (svgf_tpu/config.py), the port's own copy.

The field names, defaults and JSON form are svgf_tpu's, so one JSON config
loads into either package. The reference's two mutable parameter structs
become frozen dataclasses:
  - tracingParameters (reference src/Tracing.h:17-38)
  - the SVGF knobs on `application` (reference src/App.h:106-114)
plus resolution, debug tap and kernel policy.
"""

from __future__ import annotations

import dataclasses
import enum
import json


class SamplingMode(enum.IntEnum):
    """Reference src/Tracing.h:9-12 (BSDF / LIGHT / BOTH / MIS)."""

    BSDF = 0
    LIGHT = 1
    BOTH = 2
    MIS = 3


class DebugOutput(enum.IntEnum):
    """Debug taps into the pipeline (reference src/App.h:92-105, 11 modes):
    which intermediate buffer `render_frame` returns as its `image`."""

    FINAL = 0
    RAW = 1                # raster + trace only (no filtering)
    NORMAL = 2
    MOTION = 3
    POSITION = 4
    BARYCENTRIC = 5
    TEMPORAL = 6           # after temporal accumulation
    ATROUS = 7             # after wavelet filtering (pre-TAA)
    MOMENTS = 8
    VARIANCE = 9
    DEPTH = 10


@dataclasses.dataclass(frozen=True)
class TracingConfig:
    """Path-tracing parameters. Defaults per reference src/Tracing.h:28-38."""

    batch: int = 1                 # samples per pixel per frame
    bounces: int = 3
    current_camera: int = 0
    clamp: float = 10.0            # radiance clamp
    sampling_mode: SamplingMode = SamplingMode.MIS


@dataclasses.dataclass(frozen=True)
class SVGFConfig:
    """SVGF filter parameters. Defaults per reference src/App.h:109-114."""

    spatial_filter_steps: int = 3      # a-trous iterations (GUI 0-10; paper uses 5)
    depth_threshold: float = 0.8       # temporal reprojection |dz| rejection
    normal_threshold: float = 0.9      # temporal reprojection dot(n,n') rejection
    history_length: int = 24           # EMA history cap ("HistoryBaseLength")
    phi_colour: float = 10.0
    phi_normal: float = 128.0
    enable_taa: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Multi-device layout: image rows over `tiles_y` devices, columns over
    `tiles_x`. The port renders on one device (1 x 1) so far."""

    tiles_y: int = 1
    tiles_x: int = 1
    axis_y: str = "ty"
    axis_x: str = "tx"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 800
    height: int = 600
    tracing: TracingConfig = dataclasses.field(default_factory=TracingConfig)
    svgf: SVGFConfig = dataclasses.field(default_factory=SVGFConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    debug_output: DebugOutput = DebugOutput.FINAL
    # Return every intermediate stage in FrameOutputs (radiance, temporal,
    # moments, a-trous, gbuffer); debug_output != FINAL implies it.
    keep_taps: bool = True
    # Storage dtype of the temporal state (the reference stores fp16,
    # App.cu:763-773); "float32" for tests.
    state_dtype: str = "float16"
    # Use the G-buffer for the primary hit ("hybrid" trick, Common.cuh:1542-1568).
    hybrid_primary: bool = True
    # Deterministic RNG seed (replaces the reference's wall-clock Time seed).
    seed: int = 0
    # Trace-stage lane chunks per frame: peak memory of the shading stage
    # scales as 1/chunks.
    trace_chunks: int = 1
    # Ray load balancing on sharded meshes (no effect on one device).
    trace_balance: bool = True
    # Kernel policy of the filter stages (kernels.resolve_kernels):
    #   "auto"      the CUDA kernels for CUDA tensors, the plain torch
    #               versions on the CPU
    #   "on"/"off"  force
    #   "interpret" svgf_tpu's Pallas interpreter; raises in the port
    use_pallas: str = "auto"
    # svgf_tpu's channel-planar filter layout; the port has one layout and
    # ignores it.
    planar_chain: bool = True
    # Separate policy for the INTERSECTOR kernels (None = follow
    # use_pallas), so a test can pin the intersector while it exercises the
    # filter kernels: a ray through a shared triangle edge may pick either
    # side under another rounding, and one flipped primary pixel spreads
    # through the variance-guided filters.
    use_pallas_intersect: str | None = None
    # Motion bound (|dy|, |dx|) in pixels of svgf_tpu's Pallas reprojection;
    # the port gathers anywhere, as the reference does, and ignores it.
    reproject_max_motion: tuple = (8, 63)

    # ---- (de)serialization: the reference has no config files; JSON. ----
    def to_json(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return {k: enc(v) for k, v in dataclasses.asdict(o).items()}
            if isinstance(o, enum.IntEnum):
                return int(o)
            return o

        return json.dumps(enc(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "RenderConfig":
        d = json.loads(text)
        tracing = d.pop("tracing", {})
        svgf = d.pop("svgf", {})
        mesh = d.pop("mesh", {})
        if "sampling_mode" in tracing:
            tracing["sampling_mode"] = SamplingMode(tracing["sampling_mode"])
        if "debug_output" in d:
            d["debug_output"] = DebugOutput(d["debug_output"])
        if "reproject_max_motion" in d:
            d["reproject_max_motion"] = tuple(d["reproject_max_motion"])
        return RenderConfig(
            tracing=TracingConfig(**tracing),
            svgf=SVGFConfig(**svgf),
            mesh=MeshConfig(**mesh),
            **d,
        )


__all__ = ["DebugOutput", "MeshConfig", "RenderConfig", "SamplingMode", "SVGFConfig",
           "TracingConfig"]
