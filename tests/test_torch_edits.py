"""The port's scene edits (svgf_tpu_torch/core/edits.py) against svgf_tpu's.

The seven cases of tests/test_edits.py, each held against svgf_tpu's edit
of the same scene: the fields an edit touches equal svgf_tpu's at rtol
1e-5 / atol 1e-6 (and bit for bit where both compute them alike), the
untouched ones keep their tensors, and the old SceneArrays is unchanged.
On the large-scene layout (stress_scene(n=96), 18,052 world triangles,
flattened once per module by both packages with the NumPy BVH builder)
a transform edit gives svgf_tpu's cluster bounds over its range and its
scene BVH (`wbvh_*`) bit for bit. The kernels' packed scene
(kernels/intersect.py packed_scene) stays after a material edit and is
repacked after a transform edit. A 32x24 Renderer on the CPU that edits
a material between frames gives svgf_tpu's radiance (use_pallas="off"),
and a sequence resumed from a checkpoint gives the uninterrupted frames
exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from svgf_tpu.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_tpu.core import edits as j_edits
from svgf_tpu.core.camera import orbit_frame as j_orbit_frame
from svgf_tpu.core.scene import Shape as JShape
from svgf_tpu.render.pipeline import Renderer as JRenderer
from svgf_tpu.render.pipeline import render_frame as j_render_frame
from svgf_tpu.scenes import cornell_box as j_cornell
from svgf_tpu.scenes.stress import stress_scene as j_stress
from svgf_tpu_torch import config as tconfig
from svgf_tpu_torch import convert
from svgf_tpu_torch.core import edits
from svgf_tpu_torch.core.camera import orbit_frame
from svgf_tpu_torch.core.scene import Instance, MaterialType, SceneArrays, Shape
from svgf_tpu_torch.io import load_checkpoint, save_checkpoint
from svgf_tpu_torch.kernels import intersect as KI
from svgf_tpu_torch.render.pipeline import Renderer
from svgf_tpu_torch.scenes.cornell import cornell_box
from svgf_tpu_torch.scenes.stress import stress_scene

MAT_FIELDS = {"mat_emission", "mat_colour", "mat_roughness", "mat_metallic", "mat_anisotropy",
              "mat_opacity", "mat_scattering", "mat_transmission_depth", "mat_type"}


@pytest.fixture
def cornell(monkeypatch):
    """(svgf_tpu's Cornell scene and arrays, the port's), NumPy BVH builder."""
    monkeypatch.setenv("SVGF_NATIVE", "0")
    js, ts = j_cornell(), cornell_box()
    return js, js.flatten(), ts, ts.flatten(device="cpu")


def changed_fields(old, new) -> set:
    return {f for f in SceneArrays.tensor_fields() if getattr(old, f) is not getattr(new, f)}


def snapshot(arrays) -> dict:
    return {f: getattr(arrays, f).clone() for f in SceneArrays.tensor_fields()}


def assert_unchanged(arrays, snap):
    for f, t in snap.items():
        assert torch.equal(getattr(arrays, f), t), f"{f} of the old arrays changed"


def assert_fields_match(j_arrays, t_arrays, fields, exact=False):
    want = jax.tree.map(np.asarray, j_arrays)
    for f in sorted(fields):
        g, w = getattr(t_arrays, f).numpy(), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=f)


def assert_arrays_match(j_arrays, t_arrays):
    """A full flatten of each package: the meta and every field."""
    assert t_arrays.meta == convert.scene_arrays(jax.tree.map(np.asarray, j_arrays), "cpu").meta
    assert_fields_match(j_arrays, t_arrays, SceneArrays.tensor_fields(), exact=True)


def _moved(transform, delta):
    t = np.asarray(transform, np.float32).copy()
    t[:3, 3] += delta
    return t


def _emissive(scene) -> int:
    return next(i for i, inst in enumerate(scene.instances)
                if any(e > 0 for e in scene.materials[inst.material].emission))


# ---------------------------------------------------------------------------
# tests/test_edits.py's cases, against svgf_tpu
# ---------------------------------------------------------------------------


def test_update_material_buffer_identity(cornell):
    js, ja, ts, ta = cornell
    snap = snapshot(ta)
    kw = dict(colour=(0.9, 0.1, 0.1), roughness=0.4, material_type=MaterialType.PBR, metallic=0.3)
    je = j_edits.update_material(js, ja, 0, dataclasses.replace(js.materials[0], **kw))
    te = edits.update_material(ts, ta, 0, dataclasses.replace(ts.materials[0], **kw))
    assert changed_fields(ta, te) == MAT_FIELDS
    assert_unchanged(ta, snap)
    assert_fields_match(je, te, MAT_FIELDS, exact=True)
    fresh = ts.flatten(device="cpu")
    for f in MAT_FIELDS:
        assert torch.equal(getattr(te, f), getattr(fresh, f)), f
    # departure: the meta follows the new material type (svgf_tpu keeps (0,))
    assert je.meta.mat_types_used == (0,)
    assert te.meta == fresh.meta and te.meta.mat_types_used == (0, 1)


def test_update_material_rejects_emissive_toggle(cornell):
    js, ja, ts, ta = cornell
    with pytest.raises(AssertionError) as want:
        j_edits.update_material(js, ja, 0, dataclasses.replace(js.materials[0], emission=(5, 5, 5)))
    with pytest.raises(AssertionError) as got:
        edits.update_material(ts, ta, 0, dataclasses.replace(ts.materials[0], emission=(5, 5, 5)))
    assert str(got.value) == str(want.value)
    assert ts.materials[0].emission == (0.0, 0.0, 0.0)


def test_update_instance_transform_matches_flatten(cornell):
    js, ja, ts, ta = cornell
    snap = snapshot(ta)
    idx = next(i for i, inst in enumerate(ts.instances)
               if not any(e > 0 for e in ts.materials[inst.material].emission))
    t = _moved(ts.instances[idx].transform, [0.25, 0.0, -0.1])
    je = j_edits.update_instance_transform(js, ja, idx, t)
    te = edits.update_instance_transform(ts, ta, idx, t)
    changed = changed_fields(ta, te)
    assert changed == {"inst_transform", "inst_inv_transform", "inst_normal_transform",
                       "world_tris9", "inst_aabb_min", "inst_aabb_max"}
    assert_unchanged(ta, snap)
    assert_fields_match(je, te, changed, exact=True)
    fresh = ts.flatten(device="cpu")
    for k in changed | {"lights_cdf"}:
        np.testing.assert_allclose(getattr(te, k).numpy(), getattr(fresh, k).numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_update_emissive_instance_rebuilds_light_cdf(cornell):
    js, ja, ts, ta = cornell
    idx = _emissive(ts)
    t = np.asarray(ts.instances[idx].transform, np.float32).copy()
    t[:3, :3] *= 2.0   # scale the light: the CDF areas change
    je = j_edits.update_instance_transform(js, ja, idx, t)
    te = edits.update_instance_transform(ts, ta, idx, t)
    assert {"lights_cdf", "light_area"} <= changed_fields(ta, te)
    assert_fields_match(je, te, changed_fields(ta, te))
    fresh = ts.flatten(device="cpu")
    for k in ("lights_cdf", "light_area"):
        np.testing.assert_allclose(getattr(te, k).numpy(), getattr(fresh, k).numpy(), rtol=1e-5)
    assert not np.allclose(te.light_area.numpy(), ta.light_area.numpy())


def test_remove_and_readd_instance(cornell, monkeypatch):
    js, _, ts, ta = cornell
    victim = 4   # the tall block
    j_removed, t_removed = js.instances[victim], ts.instances[victim]
    js, ja1 = j_edits.remove_instance(js, victim)
    ts, ta1 = edits.remove_instance(ts, victim, device="cpu")
    assert ta1.inst_shape.shape[0] == ta.inst_shape.shape[0] - 1
    assert_arrays_match(ja1, ta1)
    js, ja2 = j_edits.add_instance(js, j_removed)
    ts, ta2 = edits.add_instance(ts, t_removed, device="cpu")
    assert_arrays_match(ja2, ta2)
    assert ta2.meta.n_world_tris == ta.meta.n_world_tris
    with pytest.raises(AssertionError, match="unknown shape"):
        edits.add_instance(ts, Instance(shape=99, material=0), device="cpu")


def test_add_shape_and_duplicate(cornell):
    js, _, ts, _ = cornell
    n_sh, n_in = len(ts.shapes), len(ts.instances)
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.asarray([[0, 1, 2]], np.int32)
    t = _moved(np.eye(4), [0.1, 0.2, 0.3])
    js, ja, jsid = j_edits.add_shape(js, JShape(positions=pos, indices=idx), material=0,
                                     transform=t)
    ts, ta, sid = edits.add_shape(ts, Shape(positions=pos, indices=idx), material=0,
                                  transform=t, device="cpu")
    assert sid == jsid == n_sh and len(ts.instances) == n_in + 1
    assert_arrays_match(ja, ta)
    js, ja2 = j_edits.duplicate_instance(js, n_in)
    ts, ta2 = edits.duplicate_instance(ts, n_in, device="cpu")
    assert len(ts.instances) == n_in + 2 and ta2.inst_shape.shape[0] == n_in + 2
    assert_arrays_match(ja2, ta2)


# ---------------------------------------------------------------------------
# the large-scene layout: ranged cluster bounds, the stitched scene BVH
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stress():
    """stress_scene(n=96) and its arrays in both packages, NumPy builder."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SVGF_NATIVE", "0")
    try:
        js = j_stress(n=96)
        ja = js.flatten()
        ts = stress_scene(n=96)
        ta = ts.flatten(device="cpu")
    finally:
        mp.undo()
    return js, ja, ts, ta


@pytest.mark.parametrize("which", ["light", "terrain"])
def test_large_scene_transform_matches_jax(stress, which):
    js, ja, ts, ta = stress
    idx = {"light": 1, "terrain": 0}[which]
    old_t = np.asarray(ts.instances[idx].transform).copy()
    snap = snapshot(ta)
    t = _moved(old_t, [0.3, -0.2, 0.15] if which == "light" else [0.05, 0.02, -0.04])
    # svgf_tpu's host mirror of the soup is checked by shape only: after
    # another test's edit of the same arrays it would hold that edit's soup
    js.__dict__.pop("_soup_host_cache", None)
    try:
        je = j_edits.update_instance_transform(js, ja, idx, t)
        te = edits.update_instance_transform(ts, ta, idx, t)
        bvh_before = KI.child_pair_bvh(ta)
        bvh_after = KI.child_pair_bvh(te)
    finally:
        js.instances[idx].transform = old_t
        ts.instances[idx].transform = old_t
    assert ta.meta.soup_leaf_order and ta.meta.has_scene_bvh
    changed = changed_fields(ta, te)
    want_changed = {"inst_transform", "inst_inv_transform", "inst_normal_transform",
                    "world_tris9", "world_cluster_bounds", "world_sclust_bounds",
                    "inst_aabb_min", "inst_aabb_max", "wbvh_bounds6", "wbvh_skip",
                    "wbvh_leaf_tri"}
    if which == "light":
        want_changed |= {"lights_cdf", "light_area"}
    assert changed == want_changed
    assert_unchanged(ta, snap)
    assert_fields_match(je, te, changed, exact=True)
    # the ranged recompute equals a full one over the edited soup
    from svgf_tpu_torch.accel.clusters import compute_cluster_bounds

    cb, sb = compute_cluster_bounds(te.world_tris9.numpy(), te.world_tri_inst.numpy())
    np.testing.assert_array_equal(te.world_cluster_bounds.numpy(), cb)
    np.testing.assert_array_equal(te.world_sclust_bounds.numpy(), sb)
    assert bvh_after.nodes.shape == bvh_before.nodes.shape
    assert not torch.equal(bvh_after.nodes, bvh_before.nodes)


def test_cluster_range_for_cols_matches_jax():
    from svgf_tpu.accel.clusters import cluster_range_for_cols as j_range
    from svgf_tpu_torch.accel.clusters import cluster_range_for_cols

    for start, count in ((0, 1), (0, 2048), (127, 2), (2047, 1), (5000, 18052), (4096, 130)):
        c0, c1 = cluster_range_for_cols(start, count)
        assert (c0, c1) == j_range(start, count)
        assert c0 % 16 == 0 and c1 % 16 == 0 and c0 * 128 <= start and (start + count) <= c1 * 128


def test_soup_mirror_follows_the_arrays(stress):
    """Two edits of the same old arrays: each result is what a single edit
    gives (the host mirror of the soup is taken again, not reused)."""
    _, _, ts, ta = stress
    old_t = np.asarray(ts.instances[1].transform).copy()
    try:
        a = edits.update_instance_transform(ts, ta, 1, _moved(old_t, [0.5, 0, 0]))
        b = edits.update_instance_transform(ts, ta, 1, _moved(old_t, [-0.5, 0, 0]))
        ts.instances[1].transform = old_t
        del ts._soup_host_cache
        b_alone = edits.update_instance_transform(ts, ta, 1, _moved(old_t, [-0.5, 0, 0]))
    finally:
        ts.instances[1].transform = old_t
    assert not torch.equal(a.world_cluster_bounds, b.world_cluster_bounds)
    for f in ("world_tris9", "world_cluster_bounds", "world_sclust_bounds", "wbvh_bounds6"):
        assert torch.equal(getattr(b, f), getattr(b_alone, f)), f


def test_packed_scene_after_edits(cornell, stress):
    """K5/K6's packed copy: kept across a material edit, repacked after a
    transform edit (dense and large-scene), the new BVH's depth with it."""
    for scene, arrays, idx in ((cornell[2], cornell[3], 4), (stress[2], stress[3], 1)):
        tris, bvh = KI.packed_scene(arrays)
        old_m, old_t = scene.materials[0], np.asarray(scene.instances[idx].transform).copy()
        try:
            m = edits.update_material(scene, arrays, 0,
                                      dataclasses.replace(old_m, colour=(0.2, 0.3, 0.4)))
            t2, b2 = KI.packed_scene(m)
            assert t2 is tris and b2 is bvh
            moved = edits.update_instance_transform(scene, m, idx, _moved(old_t, [0.1, 0.05, 0]))
        finally:
            scene.materials[0], scene.instances[idx].transform = old_m, old_t
        t3, b3 = KI.packed_scene(moved)
        assert t3 is not tris and not torch.equal(t3, tris)
        assert KI.packed_scene(moved)[0] is t3   # packed once
        if arrays.meta.has_scene_bvh:
            assert b3 is not bvh and b3.depth == KI.child_pair_bvh(moved).depth
        else:
            assert b3 is None


# ---------------------------------------------------------------------------
# Renderer: an edit between frames, and resuming from a checkpoint
# ---------------------------------------------------------------------------

W, H = 32, 24
CONFIG = RenderConfig(width=W, height=H, state_dtype="float32", use_pallas="off",
                      tracing=TracingConfig(bounces=1), svgf=SVGFConfig(spatial_filter_steps=1))


def _orbit(f):
    # off the symmetric view, as tests/test_torch_pipeline.py's orbit
    return ([0.0, 0.0, 0.0], 3.4), dict(theta=0.013 + 0.03 * f, phi=0.011)


def test_edit_during_render_matches_jax(monkeypatch):
    """A material edit between frames (tests/test_edits.py
    test_edit_during_render_no_retrace): the port keeps its packed scene
    (no repack) and its radiance equals svgf_tpu's Renderer's after the
    same edit. svgf_tpu renders eagerly."""
    monkeypatch.setenv("SVGF_NATIVE", "0")
    jr = JRenderer(j_cornell(aspect=W / H), CONFIG)
    tr = Renderer(cornell_box(aspect=W / H), tconfig.RenderConfig.from_json(CONFIG.to_json()),
                  device="cpu")
    outs = []
    for f in range(2):
        if f == 1:
            packed = KI.packed_scene(tr.arrays)
            jr.update_material(0, dataclasses.replace(jr.scene.materials[0], colour=(0.9, 0.2, 0.2)))
            tr.update_material(0, dataclasses.replace(tr.scene.materials[0], colour=(0.9, 0.2, 0.2)))
            assert KI.packed_scene(tr.arrays)[0] is packed[0]
        args, kw = _orbit(f)
        jr.update_camera(j_orbit_frame(*args, **kw))
        tr.update_camera(orbit_frame(*args, **kw))
        want, jr.state = j_render_frame(jr.arrays, jr.state, CONFIG)
        outs.append((np.asarray(want.radiance), tr.step().radiance.numpy()))
    for want, got in outs:
        np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(outs[1][1] - outs[0][1]).max() > 1e-4, "the edit had no effect"


@pytest.mark.parametrize("state_dtype", ["float16", "bfloat16"])
def test_resume_equals_uninterrupted(state_dtype, tmp_path):
    """Frames 3-4 of a Renderer resumed from frame 2's checkpoint (the same
    poses and edits) equal the uninterrupted frames exactly."""
    cfg = tconfig.RenderConfig.from_json(
        dataclasses.replace(CONFIG, state_dtype=state_dtype).to_json())
    path = str(tmp_path / "ckpt.npz")

    def edit(r, f):
        if f == 2:
            r.update_material(0, dataclasses.replace(r.scene.materials[0], colour=(0.8, 0.3, 0.2)))
        if f == 3:
            r.update_instance_transform(4, _moved(r.scene.instances[4].transform, [0.1, 0, 0.05]))

    def frames(r, fs):
        out = []
        for f in fs:
            edit(r, f)
            args, kw = _orbit(f)
            r.update_camera(orbit_frame(*args, **kw))
            out.append(r.step())
            if f == 1:
                save_checkpoint(path, r.state)
        return out

    whole = frames(Renderer(cornell_box(aspect=W / H), cfg, device="cpu"), range(4))
    resumed = Renderer(cornell_box(aspect=W / H), cfg, device="cpu")
    resumed.update_camera(orbit_frame(*_orbit(1)[0], **_orbit(1)[1]))
    resumed.state = load_checkpoint(path, device="cpu")
    assert resumed.state.frame_idx == 2 and resumed.state.color.dtype == getattr(torch, state_dtype)
    for want, got in zip(whole[2:], frames(resumed, (2, 3))):
        for f in ("final", "radiance", "temporal", "atrous"):
            w, g = getattr(want, f), getattr(got, f)
            assert w is None and g is None or torch.equal(w, g), f
        assert torch.equal(want.final, got.final)
