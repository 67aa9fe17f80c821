"""Wrappers of the MIS bounce's two shading kernels (csrc/shade.cu).

| wrapper    | kernel                            | replaces                                      |
|------------|-----------------------------------|-----------------------------------------------|
| shade_pre  | csrc/shade.cu shade_pre_kernel    | no Pallas kernel: render/pathtrace.py         |
|            |                                   | _bounce_mis's surface and sample parts        |
| shade_post | csrc/shade.cu shade_post_kernel   | no Pallas kernel: _bounce_mis's MIS part and  |
|            |                                   | pathtrace's cull (and, last, its final clamp) |

svgf_tpu's bounce is plain jnp, and the port's plain route
(render/pathtrace.py _bounce_mis) stays the route on the CPU, under
autograd, in the BSDF, LIGHT and BOTH modes and for every scene the kernels
do not take. `takes_kernels` decides from what it can observe: the kernel
policy (`use_pallas`), the device, grad mode, the sampling mode and the
scene's static meta (`scene_fits`). Each wrapper takes CUDA tensors and
launches its kernel once on the current stream; it reads nothing back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from svgf_tpu_torch.config import SamplingMode
from svgf_tpu_torch import kernels
from svgf_tpu_torch.kernels.build import library
from svgf_tpu_torch.kernels.launch import LAUNCHES, check, launch, on_cpu
from svgf_tpu_torch.ops.bsdf import MATTE

MAX_LIGHTS = 8  # csrc/shade.cu kMaxLights: the lights a kernel's parameters hold

_F32, _I32 = (torch.float32,), (torch.int32,)


def scene_fits(meta) -> bool:
    """Whether a scene asks for nothing the kernels lack: matte materials
    only, instance lights only (at most MAX_LIGHTS), no environment, media,
    opacity, textures or normal maps."""
    return (set(meta.mat_types_used) <= {MATTE} and meta.n_envs == 0
            and not (meta.has_media or meta.has_opacity or meta.textures_enabled
                     or meta.has_normal_maps)
            and meta.n_lights <= MAX_LIGHTS and all(i >= 0 for i in meta.light_instance))


def takes_kernels(meta, mode: SamplingMode, kernel_mode: str, device) -> bool:
    """Whether a trace takes the shading kernels: the kernel policy
    resolves to the kernels for `device` (kernels.resolve_kernels, which
    raises where the policy cannot hold), autograd is off, the bounce is
    MIS and the scene fits."""
    return (kernels.resolve_kernels(kernel_mode, device) and not torch.is_grad_enabled()
            and mode == SamplingMode.MIS and scene_fits(meta))


def _tensor(t, name: str, shape: tuple, dtypes):
    t = t.contiguous()
    check(t, name, shape, dtypes)
    return t


def _scene_args(scene) -> list:
    """The kernels' scene parameters: the tables, then the lights' ints as
    a host array (the cast pointer keeps it alive), then the counts."""
    meta = scene.meta
    T, I, M = scene.tri_pos.shape[0], scene.inst_transform.shape[0], scene.mat_type.shape[0]
    C = scene.lights_cdf.shape[0]
    tables = [
        _tensor(scene.tri_pos, "tri_pos", (T, 3, 3), _F32),
        _tensor(scene.tri_nrm, "tri_nrm", (T, 3, 3), _F32),
        _tensor(scene.inst_transform, "inst_transform", (I, 4, 4), _F32),
        _tensor(scene.inst_normal_transform, "inst_normal_transform", (I, 4, 4), _F32),
        _tensor(scene.mat_colour, "mat_colour", (M, 3), _F32),
        _tensor(scene.mat_emission, "mat_emission", (M, 3), _F32),
        _tensor(scene.mat_type, "mat_type", (M,), _I32),
        _tensor(scene.lights_cdf, "lights_cdf", (C,), _F32),
        _tensor(scene.light_area, "light_area", (meta.n_lights,), _F32),
    ]
    ints = [x for l in range(meta.n_lights) for x in (
        meta.light_instance[l], meta.light_cdf_start[l], meta.light_cdf_count[l],
        meta.light_tri_start[l])]
    lights = (ctypes.c_int * max(len(ints), 1))(*ints)
    # sampling.py upper_bound_segment's step count over the whole CDF
    iters = max(1, math.ceil(math.log2(max(C, 2))) + 1)
    return [*tables, ctypes.cast(lights, ctypes.c_void_p), meta.n_lights, T, I, M, C, iters]


def _hit_args(hit, R: int) -> list:
    return [_tensor(x, name, (R,), _F32 if name in ("dist", "u", "v") else _I32)
            for name, x in zip(hit._fields, hit)]



def _on_card(*tensors) -> None:
    if on_cpu(*tensors):
        raise ValueError("the shading kernels take CUDA tensors; on the CPU the bounce is "
                         "render/pathtrace.py _bounce_mis")


def shade_pre(scene, hit, state, lane_ids, seed: int, nrays):
    """The bounce's surface and sample parts (csrc/shade.cu shade_pre):
    from the bounce's `hit` and `state` (a PathState), the shadow and BSDF
    rays of every lane as the batched intersect takes them: origins (2R,
    3), directions (2R, 3) and active flags (2R,), shadow rays first. Adds
    the rays it traces to `nrays` (a () int64 tensor) in place. `seed`: the
    bounce's RngStream seed (ops/sampling.py key_to_seed32)."""
    R, dev = state.rd.shape[0], state.rd.device
    _on_card(state.rd, hit.dist, scene.tri_pos, nrays)
    args = _scene_args(scene)
    active = _tensor(state.active, "active", (R,), (torch.bool,))
    rd = _tensor(state.rd, "rd", (R, 3), _F32)
    lane = _tensor(lane_ids, "lane_ids", (R,), (torch.int64,))
    check(nrays, "nrays", (), (torch.int64,))
    ro2 = torch.empty((2 * R, 3), device=dev)
    rd2 = torch.empty((2 * R, 3), device=dev)
    act2 = torch.empty((2 * R,), dtype=torch.bool, device=dev)
    launch(library().svgf_shade_pre, dev, *args, *_hit_args(hit, R), active, rd, lane, ro2, rd2,
           act2, nrays, seed, R)
    LAUNCHES["shade_pre"] += 1
    return ro2, rd2, act2


def shade_post(scene, hit, hit2, ro2, rd2, state, lane_ids, seed: int, roulette: bool,
               clamp: float | None = None):
    """The bounce's MIS and cull parts (csrc/shade.cu shade_post): from the
    bounce's `hit` and `state`, shade_pre's rays `ro2`, `rd2` and the
    intersect's 2R-lane Hit `hit2` of them, the new (radiance, weight,
    active, use_mis, ro, rd), each a fresh tensor; Russian roulette where
    `roulette` (after bounce 3) and, with `clamp`, the trace's final
    finite-and-clamp step on the radiance (the last bounce)."""
    R, dev = state.rd.shape[0], state.rd.device
    _on_card(state.rd, hit.dist, hit2.dist, scene.tri_pos)
    args = _scene_args(scene)
    ins = [_tensor(state.radiance, "radiance", (R, 3), _F32),
           _tensor(state.weight, "weight", (R, 3), _F32),
           _tensor(state.active, "active", (R,), (torch.bool,)),
           _tensor(state.use_mis, "use_mis", (R,), (torch.bool,)),
           _tensor(state.ro, "ro", (R, 3), _F32),
           _tensor(state.rd, "rd", (R, 3), _F32)]
    lane = _tensor(lane_ids, "lane_ids", (R,), (torch.int64,))
    rays = [_tensor(ro2, "ro2", (2 * R, 3), _F32), _tensor(rd2, "rd2", (2 * R, 3), _F32)]
    outs = [torch.empty((R, 3), device=dev), torch.empty((R, 3), device=dev),
            torch.empty((R,), dtype=torch.bool, device=dev),
            torch.empty((R,), dtype=torch.bool, device=dev),
            torch.empty((R, 3), device=dev), torch.empty((R, 3), device=dev)]
    launch(library().svgf_shade_post, dev, *args, *_hit_args(hit, R), *_hit_args(hit2, 2 * R),
           *rays, *ins, lane, *outs, seed, int(roulette), int(clamp is not None),
           0.0 if clamp is None else float(clamp), R)
    LAUNCHES["shade_post"] += 1
    return tuple(outs)
