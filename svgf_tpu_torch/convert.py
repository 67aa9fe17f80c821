"""Carry svgf_tpu's data across to the port.

Given svgf_tpu's `SceneArrays` or legacy-layout `TemporalState` with NumPy
leaves (`jax.tree.map(np.asarray, x)`; the scene's `SceneMeta` may be any
object with the same attributes), these return the port's records on
`device` (the card unless the caller asks for the CPU), every field with
its values and dtype unchanged, the large-scene ones (cluster bounds,
`wbvh_*`) too. Both packages then compute on identical inputs, which is
what the tests compare. For the row-sharded route, `temporal_state_band`
cuts such a state into one rank's band and `stack_bands` puts the ranks'
bands of any record back together. `params` and `params_numpy` carry a
train step's parameter dict (svgf_tpu's `init_params`, as NumPy) across
and the port's gradients back.
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


def temporal_state_band(state, rank: int, n: int, device="cuda") -> TemporalState:
    """Rank `rank`'s band of the full-image state: rows [rank*Hs, (rank+1)*Hs)
    of every image, Hs = H // n."""
    full = temporal_state(state, "cpu")
    hs = full.color.shape[0] // n
    rows = slice(rank * hs, (rank + 1) * hs)
    band = lambda x: x[rows].contiguous().to(device)
    return full._replace(
        color=band(full.color), moments=band(full.moments), history_len=band(full.history_len),
        taa_history=band(full.taa_history), gbuffer=GBuffer(*map(band, full.gbuffer)))


def stack_bands(bands):
    """The inverse of cutting into bands: the ranks' bands of a record
    (TemporalState, FrameOutputs, GBuffer, ...), in rank order, with every
    tensor concatenated along its rows onto the CPU. Fields that are not
    tensors (None, frame_idx) are taken from rank 0."""
    first = bands[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([b.cpu() for b in bands])
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(stack_bands([getattr(b, f) for b in bands]) for f in first._fields))
    return first


def params(p: dict, device="cuda") -> dict:
    """svgf_tpu's parameter dict (field name -> array, e.g. its
    `init_params`) as the port's tensors on `device`."""
    return {name: _tensor(v, device) for name, v in p.items()}


def params_numpy(p: dict) -> dict:
    """The port's parameter or gradient dict as NumPy arrays, to compare
    with svgf_tpu's."""
    return {name: t.detach().cpu().numpy() for name, t in p.items()}
