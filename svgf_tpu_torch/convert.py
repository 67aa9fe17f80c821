"""Carry svgf_tpu's data across to the port.

Given svgf_tpu's `SceneArrays` or legacy-layout `TemporalState` with NumPy
leaves (`jax.tree.map(np.asarray, x)`; the scene's `SceneMeta` may be any
object with the same attributes), these return the port's records on
`device` (the card unless the caller asks for the CPU), every field with
its values and dtype unchanged, the large-scene ones (cluster bounds,
`wbvh_*`) too. Both packages then compute on identical inputs, which is
what the tests compare.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from svgf_tpu_torch.core.scene import SceneArrays, SceneMeta
from svgf_tpu_torch.render.types import GBuffer, TemporalState


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), device=device)  # a copy: JAX's buffers are read-only


def scene_arrays(arrays, device="cuda") -> SceneArrays:
    meta = SceneMeta(**{f.name: getattr(arrays.meta, f.name)
                        for f in dataclasses.fields(SceneMeta)})
    return SceneArrays(meta=meta, **{
        name: _tensor(getattr(arrays, name), device) for name in SceneArrays.tensor_fields()
    })


def temporal_state(state, device="cuda") -> TemporalState:
    if state.color is None:
        raise ValueError("a planar-layout state has no legacy fields to convert")
    return TemporalState(
        color=_tensor(state.color, device),
        moments=_tensor(state.moments, device),
        history_len=_tensor(state.history_len, device),
        taa_history=_tensor(state.taa_history, device),
        gbuffer=GBuffer(*(_tensor(getattr(state.gbuffer, f), device) for f in GBuffer._fields)),
        frame_idx=int(state.frame_idx),
    )
