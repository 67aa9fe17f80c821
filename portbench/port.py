"""What the benchmark takes from the program under test, svgf_tpu_torch:
the Scene built from a scene description, the RenderConfig of a
configuration, the Renderer and the filter chain, and the program's
spans (Renderer.step's CUDA events), counters (FrameMetrics.rays_traced)
and kernel names. Nothing else of the benchmark imports the program."""

from __future__ import annotations

import numpy as np
import torch

# substrings of the program's hand kernels as the profiler names them
KERNELS = {"temporal": "svgf::temporal_kernel", "moments": "svgf::moments_kernel",
           "atrous": "svgf::atrous_kernel", "taa": "svgf::taa_kernel",
           "intersect_dense": "svgf::intersect_dense_kernel"}
STATE_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32}


def scene(desc: dict, camera_frame):
    """The program's Scene of a description, its one camera at `camera_frame`."""
    from svgf_tpu_torch.core.camera import Camera
    from svgf_tpu_torch.core.scene import Instance, Material, Scene, Shape

    sc = Scene()
    for s in desc["shapes"]:
        sc.shapes.append(Shape(positions=np.asarray(s["positions"], np.float32),
                               indices=np.asarray(s["indices"], np.int32),
                               uvs=None if s["uvs"] is None else np.asarray(s["uvs"], np.float32)))
    for m in desc["materials"]:
        sc.materials.append(Material(colour=tuple(m["colour"]), emission=tuple(m["emission"]),
                                     roughness=float(m["roughness"])))
    for i in desc["instances"]:
        sc.instances.append(Instance(shape=i["shape"], material=i["material"],
                                     transform=np.asarray(i["transform"], np.float32),
                                     name=i["name"]))
    sc.cameras.append(Camera(frame=np.asarray(camera_frame, np.float32),
                             fov=float(desc["camera"]["fov"])))
    return sc


def render_config(render: dict, device):
    """The RenderConfig of a run's render settings (drive.settings). On the CPU
    (the CPU tests) the kernel policy "on" becomes "auto": the plain versions."""
    from svgf_tpu_torch.config import RenderConfig, SamplingMode, SVGFConfig, TracingConfig

    policy = render["use_pallas"]
    if torch.device(device).type == "cpu" and policy == "on":
        policy = "auto"
    return RenderConfig(
        width=render["width"], height=render["height"],
        tracing=TracingConfig(batch=render["spp"], bounces=render["bounces"],
                              clamp=render["clamp"],
                              sampling_mode=SamplingMode[render["sampling"]]),
        svgf=SVGFConfig(**render["svgf"]), state_dtype=render["state_dtype"],
        hybrid_primary=render["hybrid_primary"], seed=render["seed"],
        trace_chunks=render["trace_chunks"], use_pallas=policy, keep_taps=render["keep_taps"])


def renderer(sc, config, device):
    from svgf_tpu_torch.render.pipeline import Renderer

    return Renderer(sc, config, device=device)


def filter_chain(radiance, gbuf, state, config, events=None):
    from svgf_tpu_torch.render.pipeline import filter_chain as chain

    return chain(radiance, gbuf, state, config, events)


def gbuffer(fields: dict):
    from svgf_tpu_torch.render.types import GBuffer

    return GBuffer(**fields)


def temporal_state(fields: dict):
    from svgf_tpu_torch.render.types import TemporalState

    return TemporalState(**fields)


def as_fields(state) -> dict:
    """A program state (TemporalState) as the plain dict the check reads:
    its tensors, the G-buffer as a dict, and frame_idx."""
    d = state._asdict()
    d["gbuffer"] = d["gbuffer"]._asdict()
    return d
