"""Incremental scene edits (svgf_tpu/core/edits.py) — the reference's
live-update path (sceneBVH::UpdateTLAS/UpdateMaterial/AddInstance/
RemoveInstance/AddShape, BVH.cpp:491-583; scene::UploadMaterial,
Scene.cpp:447-451; asset import into a live scene, AssetLoader.cpp:11-55).

Every function takes the host `Scene` plus its current flattened
`SceneArrays` and returns a new `SceneArrays` in which ONLY the touched
fields are replaced: a touched field is cloned and the clone written, so
the old `SceneArrays` is unchanged and every untouched field keeps its
tensor. The intersector kernels' packed copy of the scene is keyed by the
soup's and the scene BVH's tensors (kernels/intersect.py packed_scene):
a material edit keeps it, a transform edit repacks once.

Edits that change the topology (remove, duplicate or add an instance,
add a shape or an asset) return a full `scene.flatten()` on `device`,
as svgf_tpu does.

Departure: `update_material` also refreshes the SceneMeta fields that
follow from the materials (`has_media`, `has_opacity`, `mat_types_used`),
which decide the tracer's branches; svgf_tpu keeps its meta static there
(a new meta would retrace its jitted step), so a type its meta does not
list renders with that type's lobe pruned.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from svgf_tpu_torch.accel.bvh import _transform_aabbs, build_scene_bvh
from svgf_tpu_torch.accel.clusters import SUPER_CLUSTERS, compute_cluster_bounds_range
from svgf_tpu_torch.core.lights import build_lights
from svgf_tpu_torch.core.scene import Instance, material_flags
from svgf_tpu_torch.core.textures import texture_alpha_min
from svgf_tpu_torch.io.assets import load_asset


def _is_emissive(material) -> bool:
    return any(e > 0.0 for e in material.emission)


def _set_rows(t: torch.Tensor, rows, value) -> torch.Tensor:
    """A copy of `t` with t[rows] = value (a host array or number)."""
    out = t.clone()
    out[rows] = torch.as_tensor(np.asarray(value), dtype=t.dtype, device=t.device)
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A writable host copy of a device tensor."""
    return t.detach().cpu().numpy().copy()


def _light_arrays(scene, arrays) -> dict:
    """Rebuild the light CDF arrays (reference lights::Build,
    Tracing.cpp:93-161). The light SET must be unchanged (same SceneMeta);
    only CDF values / areas may differ (e.g. an emissive instance moved)."""
    lights = build_lights(scene)
    assert lights.instance.shape[0] == arrays.meta.n_lights, (
        "light set changed — use Scene.flatten() (static SceneMeta differs)"
    )
    f, dev = arrays.lights_cdf.dtype, arrays.device
    return dict(
        lights_cdf=torch.as_tensor(lights.cdf, dtype=f, device=dev),
        light_area=torch.as_tensor(lights.total, dtype=f, device=dev),
    )


def update_material(scene, arrays, index: int, material):
    """Edit one material (reference scene::UploadMaterial partial memcpy,
    Scene.cpp:447-451). Mutates scene.materials[index]; returns new arrays.

    If the edit toggles the emissive set, the light topology changes and a
    full `scene.flatten()` is required instead (this function asserts that
    it does not). The meta's material flags follow the new material (see
    the module's docstring)."""
    old = scene.materials[index]
    assert _is_emissive(old) == _is_emissive(material), (
        "emissive set changed — light topology is static; re-flatten"
    )
    scene.materials[index] = material
    m = material
    upd = dict(
        mat_emission=_set_rows(arrays.mat_emission, index, m.emission),
        mat_colour=_set_rows(arrays.mat_colour, index, m.colour),
        mat_roughness=_set_rows(arrays.mat_roughness, index, m.roughness),
        mat_metallic=_set_rows(arrays.mat_metallic, index, m.metallic),
        mat_anisotropy=_set_rows(arrays.mat_anisotropy, index, m.anisotropy),
        mat_opacity=_set_rows(arrays.mat_opacity, index, m.opacity),
        mat_scattering=_set_rows(arrays.mat_scattering, index, m.scattering_colour),
        mat_transmission_depth=_set_rows(arrays.mat_transmission_depth, index,
                                         m.transmission_depth),
        mat_type=_set_rows(arrays.mat_type, index, int(m.material_type)),
    )
    if _is_emissive(material):
        # emission magnitude affects nothing in the CDF (area-weighted), but
        # keep parity with the reference GUI which rebuilds lights on
        # emissive-instance edits (GUI.cpp:1171-1174)
        upd.update(_light_arrays(scene, arrays))
    tex_alpha = texture_alpha_min(scene.textures) if arrays.meta.textures_enabled else []
    meta = dataclasses.replace(arrays.meta, **material_flags(scene.materials, tex_alpha))
    return dataclasses.replace(arrays, meta=meta, **upd)


def update_instance_transform(scene, arrays, index: int, transform):
    """Move one instance (reference sceneBVH::UpdateTLAS, BVH.cpp:509-518 +
    the GUI gizmo path GUI.cpp:1151-1178): recomputes the instance matrices,
    its world-soup triangle block, the cluster bounds over that block (large
    scenes), its world AABB, the stitched scene BVH (when present), and the
    light CDF when the instance is emissive. Everything else keeps its
    tensor.
    """
    t = np.asarray(transform, np.float32)
    scene.instances[index].transform = t
    inst = scene.instances[index]
    sh = scene.shapes[inst.shape]
    meta = arrays.meta

    inv = np.linalg.inv(t.astype(np.float64)).astype(np.float32)
    upd = dict(
        inst_transform=_set_rows(arrays.inst_transform, index, t),
        inst_inv_transform=_set_rows(arrays.inst_inv_transform, index, inv),
        inst_normal_transform=_set_rows(arrays.inst_normal_transform, index, inv.T),
    )

    # world-soup block (the dense path and the scene-BVH leaves read these);
    # large scenes keep the soup in BLAS-leaf order (core.scene.flatten)
    start, count = meta.inst_world_range[index]
    pw = sh.tri_pos.astype(np.float64) @ t[:3, :3].astype(np.float64).T + t[:3, 3]
    if meta.soup_leaf_order:
        pw = pw[sh.blas.tri_order.astype(np.int64)]
    new9 = pw.reshape(count, 9).T.astype(np.float32)
    upd["world_tris9"] = _set_rows(arrays.world_tris9, (slice(None), slice(start, start + count)),
                                   new9)
    if meta.soup_leaf_order:
        # host mirror of the world soup: one device-to-host copy per scene,
        # then kept in sync across edits, so an edit recomputes only the
        # clusters over its block. It mirrors the soup tensor it names
        # (svgf_tpu checks only the shape): an edit of other arrays than
        # the last edit's result copies the soup again
        cache = getattr(scene, "_soup_host_cache", None)
        if cache is None or cache["soup"] is not arrays.world_tris9:
            cache = {"w9": _host(arrays.world_tris9), "inst": _host(arrays.world_tri_inst)}
            scene._soup_host_cache = cache
        cache["w9"][:, start : start + count] = new9
        cache["soup"] = upd["world_tris9"]
        c0, c1, cb_np, sb_np = compute_cluster_bounds_range(cache["w9"], cache["inst"],
                                                            start, count)
        upd["world_cluster_bounds"] = _set_rows(arrays.world_cluster_bounds, slice(c0, c1), cb_np)
        upd["world_sclust_bounds"] = _set_rows(
            arrays.world_sclust_bounds, slice(c0 // SUPER_CLUSTERS, c1 // SUPER_CLUSTERS), sb_np)

    lo, hi = _transform_aabbs(sh.blas.root_min[None], sh.blas.root_max[None], t.astype(np.float64))
    upd["inst_aabb_min"] = _set_rows(arrays.inst_aabb_min, index, lo[0])
    upd["inst_aabb_max"] = _set_rows(arrays.inst_aabb_max, index, hi[0])

    if meta.has_scene_bvh:
        i_lo, i_hi = _host(arrays.inst_aabb_min), _host(arrays.inst_aabb_max)
        i_lo[index], i_hi[index] = lo[0], hi[0]
        sbvh = build_scene_bvh(
            i_lo, i_hi,
            np.asarray([i.shape for i in scene.instances], np.int32),
            np.stack([np.asarray(i.transform, np.float32) for i in scene.instances]),
            [s.blas for s in scene.shapes],
            np.asarray([r[0] for r in meta.inst_world_range], np.int32),
            soup_leaf_order=meta.soup_leaf_order,
        )
        assert sbvh.n_nodes == arrays.wbvh_skip.shape[0]
        dev, f = arrays.device, arrays.wbvh_bounds6.dtype
        upd["wbvh_bounds6"] = torch.as_tensor(
            np.concatenate([sbvh.node_min.T, sbvh.node_max.T], axis=0), dtype=f, device=dev)
        upd["wbvh_skip"] = torch.as_tensor(sbvh.skip, dtype=torch.int32, device=dev)
        upd["wbvh_leaf_tri"] = torch.as_tensor(sbvh.leaf_tri, dtype=torch.int32, device=dev)

    if _is_emissive(scene.materials[inst.material]):
        upd.update(_light_arrays(scene, arrays))
    return dataclasses.replace(arrays, **upd)


def remove_instance(scene, index: int, device="cuda"):
    """Delete one instance (reference sceneBVH::RemoveInstance,
    BVH.cpp:519-534 + scene::RemoveInstance, Scene.cpp:441-445 + the GUI
    delete button, GUI.cpp:170-196).

    Removing an instance re-indexes the soup and can change the light set,
    i.e. the SceneMeta, so, like the reference (which rebuilds the TLAS and
    re-uploads the instance buffers), this returns (scene, a full
    re-flatten on `device`)."""
    scene.instances.pop(index)
    return scene, scene.flatten(device=device)


def duplicate_instance(scene, index: int, device="cuda"):
    """Duplicate one instance (GUI.cpp:198-215): same shape/material, same
    transform — the gizmo then moves the copy."""
    scene.instances.append(copy.deepcopy(scene.instances[index]))
    return scene, scene.flatten(device=device)


def add_instance(scene, instance, device="cuda"):
    """Append an instance of an existing shape (reference
    sceneBVH::AddInstance, BVH.cpp:536-547)."""
    assert 0 <= instance.shape < len(scene.shapes), "unknown shape index"
    assert 0 <= instance.material < len(scene.materials), "unknown material"
    scene.instances.append(instance)
    return scene, scene.flatten(device=device)


def add_shape(scene, shape, material: int | None = None, transform=None, device="cuda"):
    """Append a shape (+ optionally an instance of it) — reference
    sceneBVH::AddShape, BVH.cpp:549-583 (which re-uploads the whole BLAS
    buffer set; here the re-flatten rebuilds the same concatenated arrays).
    Returns (scene, arrays, shape_index)."""
    scene.shapes.append(shape)
    shape_index = len(scene.shapes) - 1
    if material is not None:
        t = np.eye(4, dtype=np.float32) if transform is None else np.asarray(transform, np.float32)
        scene.instances.append(Instance(transform=t, shape=shape_index, material=material))
    return scene, scene.flatten(device=device), shape_index


def add_asset(scene, path: str, device="cuda"):
    """Import an asset into a live scene (reference LoadAsset,
    AssetLoader.cpp:11-55) and re-flatten on `device`.

    Appending shapes/instances changes the SceneMeta and every concatenated
    buffer (the reference likewise re-uploads the whole BLAS buffer set on
    AddShape, BVH.cpp:549-583), so this returns (scene, a full re-flatten).
    A soup that grows past DENSE_MAX_TRIS takes the large-scene layout, and
    the tracer the scene-BVH intersector, from the next frame on."""
    load_asset(path, scene)
    return scene, scene.flatten(device=device)
