"""The port's intersectors against svgf_tpu's, on the CPU.

Dense scenes (the Cornell box): the port's intersect_dense, and
intersect_scene under the "auto" policy, against svgf_tpu's dense Pallas
kernel run in interpret mode, with the bars of tests/test_kernels.py:210-275;
and the wrapper's last step (`hit_from_winner`: the winner's t/u/v
recomputed in torch) on the same choice, with its gradient against JAX's.

Large scenes (stress_scene(n=96), 18,052 world triangles): the flattened
arrays equal svgf_tpu's bit for bit when both build their BVHs with the
NumPy builder; the port's scene-BVH walk equals svgf_tpu's; and
intersect_scene holds against svgf_tpu's clustered Pallas kernel in
interpret mode and a float64 brute force, with the bars of
tests/test_clustered.py. A ray through an edge shared by two triangles
may pick either one under another rounding, so winners are judged against
float64 truth where the two float32 paths differ.

K6's H100 design (csrc/intersect_clustered.cu) rests on a repack of the
scene BVH into child-pair records and on a nearest-first walk over them
finding the skip-link walk's hits; both are checked here on the stress
scene, the walk through a plain torch model of the kernel's. Both
kernels' wrappers take the kernel's Hit unless autograd needs the torch
recompute of its winner. On the nested scene (scenes/nested.py, 100
instances nested one in the next: a scene BVH 79 levels deep, whose rays'
walks hold more than the terrain's 64-entry stack) the port's walk holds
to svgf_tpu's, and the model's stack to the tree's depth, from which the
wrapper sizes the scratch past K6's stack.

The plain route's `only_instance` walk of one instance's BLAS in object
space (traverse_shape) holds to svgf_tpu's walk with its Pallas route off,
its derivative with respect to the ray origin to jax.jvp's; the brute
force to svgf_tpu's; and on the native builder's tree of the stress scene
(the port's default) the walks, the model of K6's walk and K6's premises
hold as on the NumPy tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgf_tpu.kernels.intersect_pallas import intersect_dense_pallas as j_dense_pallas
from svgf_tpu.ops.intersect import Hit as JHit
from svgf_tpu.ops.intersect import intersect_brute_force as j_brute_force
from svgf_tpu.ops.intersect import intersect_scene as j_intersect_scene
from svgf_tpu.ops.intersect import set_pallas_mode
from svgf_tpu.ops.intersect import traverse_scene_bvh as j_traverse
from svgf_tpu.ops.intersect import traverse_shape as j_traverse_shape
from svgf_tpu.render.gbuffer import camera_rays as j_camera_rays
from svgf_tpu.core.camera import Camera as JCamera
from svgf_tpu.core.camera import look_at_frame as j_look_at_frame
from svgf_tpu.core.scene import Instance as JInstance
from svgf_tpu.core.scene import Material as JMaterial
from svgf_tpu.core.scene import Scene as JScene
from svgf_tpu.accel.bvh import build_tlas as j_build_tlas
from svgf_tpu.ops import geometry as JG
from svgf_tpu.scenes import cornell_box as j_cornell
from svgf_tpu.scenes.default_scene import _plane as j_plane
from svgf_tpu.scenes.stress import heightfield_shape as j_heightfield_shape
from svgf_tpu.scenes.stress import stress_scene as j_stress
from svgf_tpu_torch import convert
from svgf_tpu_torch.core.scene import SceneArrays, SceneMeta
from svgf_tpu_torch.kernels import intersect as KI
from svgf_tpu_torch.accel.bvh import build_blas, build_tlas
from svgf_tpu_torch.ops import geometry as TG
from svgf_tpu_torch.ops.geometry import (
    MAX_LENGTH, ray_aabb_comp, ray_triangle_comp, transform_point3, transform_vector3,
)
from svgf_tpu_torch.ops.intersect import (
    Hit, _walk_scene_bvh, hit_from_winner, intersect_brute_force, intersect_dense,
    intersect_instances, intersect_scene, start_dist, traverse_scene_bvh, traverse_shape,
)
from svgf_tpu_torch.scenes import nested
from svgf_tpu_torch.scenes.stress import stress_scene


HIT_FIELDS = ("dist", "u", "v", "prim", "instance", "material")


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# dense scenes: K5's plain side and the wrapper's recompute
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cornell():
    scene = j_cornell()
    scene.cameras[0].aspect = 1.0
    ja = scene.flatten()
    return ja, convert.scene_arrays(jax.tree.map(np.asarray, ja), device="cpu")


def _cornell_rays(ja, kind, n=48, up=False):
    """Camera rays (n x n), or as many seeded random rays from inside the
    box (secondary-style rays); `up` turns those towards the ceiling."""
    ro, rd = jax.jit(lambda a: j_camera_rays(a.cam_frame[0], a.cam_proj[0], n, n))(ja)
    ro, rd = np.array(ro), np.array(rd)
    if kind == "random":
        rng = np.random.default_rng(3)
        ro = rng.uniform(-0.9, 0.9, ro.shape).astype(np.float32)
        rd = rng.standard_normal(rd.shape)
        if up:
            rd[:, 1] = np.abs(rd[:, 1])
        rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd


def _dense_winner(ta, ro, rd, t0, only_instance=None, active=None):
    """The choice the dense kernel (csrc/intersect_dense.cu) makes: over the
    real columns in ascending order, the first minimum of the
    Moller-Trumbore t below the start distance t0. Returns the column, or
    -1 for no hit and for an inactive ray."""
    n = ta.meta.n_world_tris
    v = ta.world_tris9[:, :n]
    row = lambda k: v[k][None, :]
    comp = lambda x: tuple(x[:, k : k + 1] for k in range(3))
    t, _, _, m = ray_triangle_comp(comp(ro), comp(rd), (row(0), row(1), row(2)),
                                   (row(3), row(4), row(5)), (row(6), row(7), row(8)))
    if only_instance is not None:
        m = m & (ta.world_tri_inst[:n] == only_instance)[None, :]
    t = torch.where(m, t, MAX_LENGTH)
    best, col = torch.min(t, dim=1)  # first minimum
    ok = best < t0 if active is None else (best < t0) & active
    return torch.where(ok, col, -1).to(torch.int32)


def _assert_hits_agree(got, want, tmax=None, bar=0.995):
    """tests/test_kernels.py:210-247: the hit verdict and the winner agree
    on all but a vanishing fraction of lanes; where they agree, dist to
    1e-5 and u/v to 1e-5; where both hit, dist to 1e-3."""
    miss_at = 1e29 if tmax is None else tmax
    hit, hit_got = _np(want.dist) < miss_at, _np(got.dist) < miss_at
    same = (_np(got.prim) == _np(want.prim)) & (_np(got.instance) == _np(want.instance))
    agree = (same | ~hit) & (hit == hit_got)
    assert agree.mean() > bar, f"winner differs on {(~agree).mean():.2%}"
    np.testing.assert_allclose(_np(got.dist)[agree], _np(want.dist)[agree], rtol=1e-5, atol=1e-5)
    m = hit & agree
    assert m.mean() > 0.01
    np.testing.assert_array_equal(_np(got.material)[m], _np(want.material)[m])
    for f in ("u", "v"):
        np.testing.assert_allclose(_np(getattr(got, f))[m], _np(getattr(want, f))[m], atol=1e-5)
    both = hit & hit_got
    np.testing.assert_allclose(_np(got.dist)[both], _np(want.dist)[both], atol=1e-3)


@pytest.mark.parametrize("rays", ["camera", "random"])
@pytest.mark.parametrize("option", [None, "tmax", "only_instance"])
def test_dense_matches_pallas_kernel(cornell, rays, option):
    """intersect_dense, intersect_scene("auto") on the CPU, and the wrapper's
    recompute from the dense kernel's choice, against svgf_tpu's
    intersect_dense_pallas in interpret mode (the light, instance 3, for
    only_instance)."""
    ja, ta = cornell
    ro, rd = _cornell_rays(ja, rays, up=option == "only_instance")
    rng = np.random.default_rng(1)
    active = rng.uniform(size=ro.shape[0]) < 0.9
    tmax = rng.uniform(1.5, 4.0, ro.shape[0]).astype(np.float32) if option == "tmax" else None
    only = 3 if option == "only_instance" else None
    want = j_dense_pallas(ja, jnp.asarray(ro), jnp.asarray(rd), active=jnp.asarray(active),
                          tmax=None if tmax is None else jnp.asarray(tmax),
                          only_instance=only, interpret=True)
    tro, trd, tact = _t(ro), _t(rd), _t(active)
    ttmax = None if tmax is None else _t(tmax)
    kw = dict(active=tact, tmax=ttmax, only_instance=only)
    t0 = start_dist(ttmax, ro.shape[0], "cpu")
    recomputed = hit_from_winner(ta, tro, trd, _dense_winner(ta, tro, trd, t0, only, tact), t0,
                                 tact)
    for got in (intersect_dense(ta, tro, trd, **kw), intersect_scene(ta, tro, trd, "auto", **kw),
                recomputed):
        act = tact.numpy()
        # inactive lanes report the start distance on every path
        np.testing.assert_array_equal(_np(got.dist)[~act], _np(want.dist)[~act])
        sel = lambda h: type(h)(*(_np(x)[act] for x in h))
        _assert_hits_agree(sel(got), sel(want), None if tmax is None else tmax[act])
    # the kernel's contract on miss lanes: ids 0, as svgf_tpu's kernel
    # reports them (the plain version reports the first column's prim and
    # material there); an inactive lane does not search and reports ids 0
    # too, where svgf_tpu's kernel searches it when its 512-ray sub-tile is live
    miss_at = 1e29 if tmax is None else tmax
    miss = _np(recomputed.dist) >= miss_at
    both = miss & act & (_np(want.dist) >= miss_at)  # an edge ray may hit on one side only
    assert both.any() or (rays == "camera" and option is None)  # the box fills that view
    for f in ("prim", "instance", "material"):
        np.testing.assert_array_equal(_np(getattr(recomputed, f))[miss], 0)
        np.testing.assert_array_equal(_np(getattr(want, f))[both], 0)


@pytest.mark.parametrize("rays,option", [("camera", None), ("random", None), ("random", "tmax"),
                                         ("random", "only_instance"), ("random", "active")])
def test_dense_hit_equals_the_recompute_of_its_winner(cornell, rays, option):
    """The premise of K5's in-kernel Hit: the Moller-Trumbore t, u, v of the
    sweep that picks the winner (intersect_dense) equal, bit for bit, the
    recompute of the same winner (hit_from_winner, which the wrapper keeps
    for autograd), with the same ids, on every hit lane."""
    ja, ta = cornell
    ro, rd = (_t(x) for x in _cornell_rays(ja, rays, up=option == "only_instance"))
    R = ro.shape[0]
    rng = np.random.default_rng(2)
    active = _t(rng.uniform(size=R) < 0.7) if option == "active" else None
    tmax = _t(rng.uniform(0.2, 2.5, R).astype(np.float32)) if option == "tmax" else None
    only = 3 if option == "only_instance" else None
    t0 = start_dist(tmax, R, "cpu")
    sweep = intersect_dense(ta, ro, rd, active=active, tmax=tmax, only_instance=only)
    col = _dense_winner(ta, ro, rd, t0, only, active)
    rec = hit_from_winner(ta, ro, rd, col, t0, active)
    hit = (col >= 0).numpy()
    assert hit.mean() > 0.01 and np.array_equal(_np(sweep.dist) < _np(t0), hit)
    for f in HIT_FIELDS:
        assert np.array_equal(_np(getattr(sweep, f))[hit], _np(getattr(rec, f))[hit]), f
    assert np.array_equal(_np(sweep.dist), _np(rec.dist))


def test_dense_recompute_gradient_matches_jax(cornell):
    """t/u/v stay differentiable with respect to the ray origin through the
    wrapper's recompute (tests/test_kernels.py:278-296), and the gradient
    equals JAX's through svgf_tpu's kernel wrapper."""
    ja, ta = cornell
    ro, rd = jax.jit(lambda a: j_camera_rays(a.cam_frame[0], a.cam_proj[0], 16, 16))(ja)
    ro, rd = np.array(ro), np.array(rd)

    def j_loss(o):
        h = j_dense_pallas(ja, o, jnp.asarray(rd), interpret=True)
        return jnp.sum(jnp.where(h.dist < 1e29, h.dist, 0.0) + h.u - 0.5 * h.v)

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(ro)))
    j_hit = j_dense_pallas(ja, jnp.asarray(ro), jnp.asarray(rd), interpret=True)
    o = _t(ro).requires_grad_(True)
    trd = _t(rd)
    t0 = start_dist(None, ro.shape[0], "cpu")
    h = hit_from_winner(ta, o, trd, _dense_winner(ta, o.detach(), trd, t0), t0)
    torch.sum(torch.where(h.dist < 1e29, h.dist, 0.0) + h.u - 0.5 * h.v).backward()
    g = o.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    # a pixel centre on a box edge may pick the other side's triangle under
    # another rounding, and its gradient is that triangle's: compare where
    # both chose the same triangle
    same = ((_np(h.prim) == np.asarray(j_hit.prim))
            & (_np(h.instance) == np.asarray(j_hit.instance)))
    assert same.mean() > 0.98
    np.testing.assert_allclose(g[same], want[same], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# large scenes: the layout and K6's plain side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stress():
    """stress_scene(n=96) flattened by both packages, both with the NumPy
    BVH builder (the native builder, the port's default, makes another
    tree, whose leaf order decides the soup columns)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SVGF_NATIVE", "0")
    try:
        ja = j_stress(n=96).flatten()
        ta = stress_scene(n=96).flatten(device="cpu")
    finally:
        mp.undo()
    return ja, ta


@pytest.fixture(scope="module")
def stress_rays(stress):
    ja, _ = stress
    ro, rd = jax.jit(lambda a: j_camera_rays(a.cam_frame[0], a.cam_proj[0], 16, 32))(ja)
    rng = np.random.default_rng(5)
    n = 512
    ro2 = rng.uniform((-1.8, 0.6, -1.8), (1.8, 1.4, 1.8), (n, 3)).astype(np.float32)
    rd2 = rng.standard_normal((n, 3))
    rd2 = (rd2 / np.linalg.norm(rd2, axis=-1, keepdims=True)).astype(np.float32)
    return {"camera": (np.array(ro), np.array(rd)), "scrambled": (ro2, rd2)}


def test_large_flatten_matches_jax_bitwise(stress):
    ja, ta = stress
    want = jax.tree.map(np.asarray, ja)
    assert ta.meta.soup_leaf_order and ta.meta.has_scene_bvh
    assert ta.meta.n_world_tris == 18052
    for f in dataclasses.fields(SceneMeta):
        assert getattr(ta.meta, f.name) == getattr(want.meta, f.name), f.name
    for name in SceneArrays.tensor_fields():
        w, g = getattr(want, name), getattr(ta, name)
        assert g.shape == w.shape and str(g.dtype) == f"torch.{w.dtype}", name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def _brute_f64(ta, ro, rd, only_instance=None, tmax=None):
    """float64 nearest hit over the padded world soup (tests/test_clustered.py)."""
    w9 = ta.world_tris9.numpy().astype(np.float64)
    wi = ta.world_tri_inst.numpy()
    ro = np.asarray(ro, np.float64)
    rd = np.asarray(rd, np.float64)
    v0, v1, v2 = w9[0:3].T, w9[3:6].T, w9[6:9].T
    e1, e2 = v1 - v0, v2 - v0
    h = np.cross(rd[:, None, :], e2[None])
    a = (e1[None] * h).sum(-1)
    par = np.abs(a) < 1e-12
    f = 1.0 / np.where(par, 1.0, a)
    s = ro[:, None, :] - v0[None]
    u = f * (s * h).sum(-1)
    q = np.cross(s, e1[None])
    v = f * (q * rd[:, None, :]).sum(-1)
    t = f * (e2[None] * q).sum(-1)
    valid = wi >= 0 if only_instance is None else wi == only_instance
    hit = (~par) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-8) & valid[None]
    t = np.where(hit, t, 1e30)
    if tmax is not None:
        t = np.where(t < np.asarray(tmax, np.float64)[:, None], t, 1e30)
    return t.min(axis=1)


def _assert_matches_truth(got_dist, ref_t, miss_at=1e29):
    """tests/test_clustered.py:92-96: the hit/miss sets equal; relative
    distance error below 2e-3 everywhere and below 1e-5 on 95% of hits."""
    got = _np(got_dist)
    hits = ref_t < 1e29
    assert hits.mean() > 0.1
    assert ((got < miss_at) == hits).all(), "hit/miss sets differ"
    rel = np.abs(got[hits] - ref_t[hits]) / ref_t[hits]
    assert rel.max() < 2e-3, rel.max()
    assert (rel < 1e-5).mean() > 0.95


@pytest.mark.parametrize("rays", ["camera", "scrambled"])
def test_scene_bvh_walk_matches_jax(stress, stress_rays, rays):
    """The port's traverse_scene_bvh against svgf_tpu's on the same arrays:
    the same walk in the same order, so the same winners; t to 1e-5."""
    ja, ta = stress
    ro, rd = stress_rays[rays]
    R = ro.shape[0]
    active = np.random.default_rng(6).uniform(size=R) < 0.9
    comp = lambda x: (x[:, 0], x[:, 1], x[:, 2])
    want = jax.jit(lambda a, o, d, m: j_traverse(a, comp(o), comp(d), JHit.none((R,)), m))(
        ja, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(active))
    got = traverse_scene_bvh(ta, _t(ro), _t(rd), active=_t(active))
    hit = _np(want.dist) < 1e29
    assert hit.mean() > 0.15
    for f in ("prim", "instance", "material"):
        np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(_np(got.dist), _np(want.dist), rtol=1e-5, atol=1e-5)
    # u and v are quotients by a = dot(e1, h), small on the terrain's
    # 0.017-unit triangles, so a last-bit difference between torch's and
    # XLA's CPU arithmetic grows to ~1e-5 there
    for f in ("u", "v"):
        np.testing.assert_allclose(_np(getattr(got, f)), _np(getattr(want, f)),
                                   atol=5e-5, err_msg=f)


def test_large_intersect_matches_clustered_kernel_and_truth(stress, stress_rays):
    """intersect_scene("auto") on the CPU (the plain walk) against float64
    truth and against svgf_tpu's clustered Pallas kernel in interpret mode."""
    ja, ta = stress
    ro, rd = stress_rays["camera"]
    got = intersect_scene(ta, _t(ro), _t(rd), "auto")
    _assert_matches_truth(got.dist, _brute_f64(ta, ro, rd))
    set_pallas_mode("interpret")
    try:
        want = j_intersect_scene(ja, jnp.asarray(ro), jnp.asarray(rd))
    finally:
        set_pallas_mode("auto")
    _assert_hits_agree(got, jax.tree.map(np.asarray, want), bar=0.99)


def test_large_intersect_only_instance_tmax_active(stress, stress_rays):
    """Rays straight up at the light quad (instance 1), as
    tests/test_clustered.py:99-149: only_instance, a tmax below the light,
    and every other ray inactive. An axis-aligned direction makes 0 * inf
    in the slab test, which both packages treat as NaN (a missed box)."""
    ja, ta = stress
    R = 512
    up = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (R, 1))
    o = np.stack([np.linspace(-1.2, 1.2, R), np.full(R, 0.5), np.linspace(-0.9, 0.9, R)],
                 axis=1).astype(np.float32)
    to, tup = _t(o), _t(up)

    h_only = intersect_scene(ta, to, tup, "auto", only_instance=1)
    ref = _brute_f64(ta, o, up, only_instance=1)
    _assert_matches_truth(h_only.dist, ref)
    assert (_np(h_only.instance)[ref < 1e29] == 1).all()

    tmax = np.full(R, 1.5, np.float32)
    h_tmax = intersect_scene(ta, to, tup, "auto", tmax=_t(tmax))
    ref2 = _brute_f64(ta, o, up, tmax=tmax)
    assert ((_np(h_tmax.dist) < 1.5) == (ref2 < 1e29)).all()
    np.testing.assert_array_equal(_np(h_tmax.dist)[ref2 >= 1e29], 1.5)

    act = np.arange(R) % 2 == 0
    h_act = intersect_scene(ta, to, tup, "auto", active=_t(act))
    assert (_np(h_act.dist)[~act] >= 1e29).all()
    np.testing.assert_array_equal(_np(h_act.dist)[act],
                                  _np(intersect_scene(ta, to, tup, "auto").dist)[act])

    set_pallas_mode("interpret")
    try:
        j_only = j_intersect_scene(ja, jnp.asarray(o), jnp.asarray(up), only_instance=1)
    finally:
        set_pallas_mode("auto")
    np.testing.assert_allclose(_np(h_only.dist), np.asarray(j_only.dist), rtol=1e-5)


# ---------------------------------------------------------------------------
# K6's H100 design: the child-pair repack and the nearest-first walk
# ---------------------------------------------------------------------------


def test_child_pair_repack_of_the_scene_bvh(stress):
    """Record k >= 1 of the repack is internal node inner[k - 1] of the
    skip-linked tree: its children are the nodes i + 1 and skip[i + 1]
    with their boxes; record 0 holds the root beside an empty NaN box.
    Every real soup column is reached exactly once, every record but 0
    once, and the repack's depth is the skip-link tree's (the internal
    nodes on its longest root-to-leaf path, counted from the nodes'
    [i, skip[i]) subtree ranges)."""
    _, ta = stress
    bvh = KI.child_pair_bvh(ta)
    skip, leaf, b6 = ta.wbvh_skip.long(), ta.wbvh_leaf_tri.long(), ta.wbvh_bounds6
    N, T = skip.shape[0], ta.world_tris9.shape[1]
    inner = torch.nonzero(leaf < 0).flatten()
    M = inner.numel()
    nodes = bvh.nodes
    assert nodes.shape == (M + 1, 16) and nodes.is_contiguous()
    refs = nodes.view(torch.int32)[:, [3, 7]].long()
    node_of_col = torch.full((T,), -1, dtype=torch.long)
    node_of_col[leaf[leaf >= 0]] = torch.nonzero(leaf >= 0).flatten()
    child_node = lambda r: torch.where(r >= 0, inner[torch.clamp(r - 1, 0)],
                                       node_of_col[torch.clamp(~r, 0)])
    c0, c1 = child_node(refs[1:, 0]), child_node(refs[1:, 1])
    assert torch.equal(c0, inner + 1) and torch.equal(c1, skip[inner + 1])
    assert int(child_node(refs[:1, 0])) == 0
    for k, c in ((0, torch.cat([c0.new_zeros(1), c0])), (8, c1)):
        rows = nodes[:, k:k + 8] if k == 0 else nodes[1:, k:k + 8]
        assert torch.equal(rows[:, 0:3], b6[0:3, c].T) and torch.equal(rows[:, 4:7], b6[3:6, c].T)
    assert bool(nodes[0, 8:11].isnan().all()) and bool(nodes[0, 12:15].isnan().all())

    slots = torch.cat([refs[:1, 0], refs[1:].flatten()])
    cols = torch.bincount(~slots[slots < 0], minlength=T)
    assert torch.equal(cols, (ta.world_tri_inst >= 0).long())
    assert torch.equal(torch.bincount(slots[slots >= 0], minlength=M + 1)[1:], torch.ones(M).long())

    ranges = torch.zeros(N + 1, dtype=torch.long)
    ranges.index_add_(0, inner, torch.ones_like(inner))
    ranges.index_add_(0, skip[inner], -torch.ones_like(inner))
    assert bvh.depth == int(torch.cumsum(ranges, 0)[:N].max())
    assert 0 < bvh.depth <= KI.BVH_STACK


def _nearest_first_walk(bvh, ta, ro, rd, t0, active=None):
    """A plain torch model of K6's walk over the child-pair records: both
    children of a record tested against the best so far (ray_aabb_comp),
    the nearer one hit visited next and the other pushed with its entry
    distance, a leaf's triangle tested where the walk reaches it, and a
    popped entry skipped once the best is below it; on equal t the lower
    column. Returns (best t, winning column or -1, records visited, the
    most stack entries the lane held at once)."""
    R = ro.shape[0]
    refs = bvh.nodes.view(torch.int32).long()
    roc, rdc = tuple(ro.unbind(1)), tuple(rd.unbind(1))
    inv = tuple(1.0 / d for d in rdc)
    lanes = torch.arange(R)
    best, col = t0.clone(), torch.full((R,), -1, dtype=torch.long)
    stack_ref = torch.zeros((R, bvh.depth + 1), dtype=torch.long)
    stack_t = torch.zeros((R, bvh.depth + 1))
    sp = torch.zeros((R,), dtype=torch.long)
    deepest = torch.zeros((R,), dtype=torch.long)
    node = torch.zeros((R,), dtype=torch.long)
    live = torch.ones((R,), dtype=torch.bool) if active is None else active.clone()
    visits = live.long()
    while bool(live.any()):
        rec = bvh.nodes[node]
        box = lambda k: ray_aabb_comp(roc, inv, tuple(rec[:, k:k + 3].unbind(1)),
                                      tuple(rec[:, k + 4:k + 7].unbind(1)), best)
        tn0, tn1 = box(0), box(8)
        h0, h1 = live & (tn0 < MAX_LENGTH), live & (tn1 < MAX_LENGTH)
        swap = h1 & (~h0 | (tn1 < tn0))
        ref0, ref1 = refs[node, 3], refs[node, 7]
        push = h0 & h1
        stack_ref[lanes, sp] = torch.where(push, torch.where(swap, ref0, ref1), stack_ref[lanes, sp])
        stack_t[lanes, sp] = torch.where(push, torch.where(swap, tn0, tn1), stack_t[lanes, sp])
        sp = sp + push
        deepest = torch.maximum(deepest, sp)
        nxt = torch.where(swap, ref1, ref0)
        have = h0 | h1
        while True:
            pop = live & ~have & (sp > 0)
            leaf = have & (nxt < 0)
            if not bool(pop.any() | leaf.any()):
                break
            sp = sp - pop.long()
            top = torch.clamp(sp, 0)
            take = pop & (stack_t[lanes, top] < best)
            nxt = torch.where(take, stack_ref[lanes, top], nxt)
            have = have | take
            c = torch.clamp(~nxt, 0)
            v = ta.world_tris9[:, c]
            t, _, _, m = ray_triangle_comp(roc, rdc, (v[0], v[1], v[2]), (v[3], v[4], v[5]),
                                           (v[6], v[7], v[8]))
            t = torch.where(m, t, MAX_LENGTH)
            win = leaf & ((t < best) | ((t == best) & (col >= 0) & (c < col)))
            best, col = torch.where(win, t, best), torch.where(win, c, col)
            have = have & ~leaf
        live = live & have
        node = torch.where(live, nxt, node)
        visits = visits + live
    return best, col, visits, deepest


@pytest.mark.parametrize("rays", ["camera", "scrambled", "scrambled, active + tmax"])
def test_nearest_first_walk_finds_the_skip_link_walks_hits(stress, stress_rays, rays):
    """The premise of K6's walk order: over the child-pair records, nearest
    child first, it finds the hits of the skip-link walk
    (traverse_scene_bvh's): the same hit/miss sets, and the same winner
    except where two triangles tie at exactly the same t."""
    _, ta = stress
    ro, rd = (_t(x) for x in stress_rays["camera" if rays == "camera" else "scrambled"])
    R = ro.shape[0]
    rng = np.random.default_rng(7)
    active = tmax = None
    if rays.endswith("tmax"):
        active = _t(rng.uniform(size=R) < 0.7)
        tmax = _t(rng.uniform(0.5, 3.0, R).astype(np.float32))
    t0 = start_dist(tmax, R, "cpu")
    want_t, want_col = _walk_scene_bvh(ta, ro, rd, t0, active, None)
    got_t, got_col, visits, _ = _nearest_first_walk(KI.child_pair_bvh(ta), ta, ro, rd, t0, active)
    assert bool((want_col >= 0).any())
    assert torch.equal(got_col >= 0, want_col >= 0)
    differ = got_col != want_col
    assert torch.equal(got_t[differ], want_t[differ])
    assert float(differ.float().mean()) <= 1e-2
    assert torch.equal(got_t, want_t)
    assert int(visits.max()) > 0


@pytest.mark.parametrize("which", ["dense", "clustered"])
def test_wrapper_recomputes_only_when_autograd_needs_it(monkeypatch, cornell, stress, stress_rays,
                                                        which):
    """Both kernels' wrappers on CUDA tensors: without grad the kernel's
    own Hit, from one launch that writes no winning column; with a ray
    requiring grad the same launch writing the column, and the torch
    recompute of t/u/v from it (hit_from_winner), which keeps the graph.
    The launch is modelled on the CPU by the plain choice of its winner."""
    ta = cornell[1] if which == "dense" else stress[1]
    ro, rd = (_t(x) for x in (_cornell_rays(cornell[0], "random", n=16) if which == "dense"
                              else stress_rays["camera"]))
    calls = []

    def launch(scene, ro_, rd_, t0, act, only_instance=None, with_col=False):
        assert not ro_.requires_grad and t0 is None and act is None
        t0 = start_dist(None, ro_.shape[0], "cpu")
        col = (_dense_winner(scene, ro_, rd_, t0) if which == "dense"
               else _walk_scene_bvh(scene, ro_, rd_, t0, None, None)[1].to(torch.int32))
        calls.append(with_col)
        hit = hit_from_winner(scene, ro_, rd_, col, t0)
        return (hit, col if with_col else None) + ((None,) if which == "clustered" else ())

    monkeypatch.setattr(KI, "dense_hit" if which == "dense" else "bvh_hit", launch)
    monkeypatch.setattr(KI, "on_cpu", lambda *tensors: False)
    wrapper = KI.intersect_dense_kernel if which == "dense" else KI.intersect_clustered_kernel
    h = wrapper(ta, ro, rd)
    assert calls == [False] and not h.dist.requires_grad and bool((h.dist < 1e29).any())
    g = ro.clone().requires_grad_(True)
    hg = wrapper(ta, g, rd)
    assert calls == [False, True] and hg.dist.requires_grad and hg.u.requires_grad
    for a, b in zip(h, hg):
        assert torch.equal(a, b.detach())
    with torch.no_grad():
        wrapper(ta, g, rd)
    assert calls == [False, True, False]


# ---------------------------------------------------------------------------
# a deep scene BVH: K6's stack from the tree's depth
# ---------------------------------------------------------------------------


def _j_nested_scene(n=100, scale=1.05, aspect=16.0 / 9.0):
    """scenes/nested.py nested_scene over svgf_tpu's host classes."""
    scene = JScene()
    scene.shapes.append(j_heightfield_shape(11, extent=1.0))
    scene.shapes.append(j_plane())
    scene.materials.append(JMaterial(colour=(0.65, 0.62, 0.58), roughness=0.8))
    scene.materials.append(JMaterial(emission=(30.0, 30.0, 30.0)))
    for k in range(n):
        t = np.eye(4, dtype=np.float32)
        t[0, 0] = t[2, 2] = scale ** k
        t[1, 3] = 0.01 * k
        scene.instances.append(JInstance(shape=0, material=0, transform=t, name=f"sheet{k}"))
    light_t = np.diag([0.8, 1.0, 0.8, 1.0]).astype(np.float32)
    light_t[1, 3] = -0.7
    scene.instances.append(JInstance(shape=1, material=1, transform=light_t, name="light"))
    scene.cameras.append(JCamera(frame=j_look_at_frame(eye=list(nested.EYE),
                                                       target=list(nested.TARGET)),
                                 fov=100.0, aspect=aspect))
    return scene


@pytest.fixture(scope="module")
def nested_scene():
    """The nested scene flattened by both packages, each with its NumPy
    BVH build, and 6 x 10 camera rays and 64 seeded rays from below the nest,
    up into it (each walk takes hundreds of steps here: few rays)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SVGF_NATIVE", "0")
    try:
        ja = _j_nested_scene().flatten()
        ta = nested.nested_scene().flatten(device="cpu")
    finally:
        mp.undo()
    ro, rd = jax.jit(lambda a: j_camera_rays(a.cam_frame[0], a.cam_proj[0], 6, 10))(ja)
    rng = np.random.default_rng(8)
    n = 64
    ro2 = rng.uniform((-1.0, -0.6, -1.0), (1.0, -0.2, 1.0), (n, 3)).astype(np.float32)
    rd2 = rng.standard_normal((n, 3))
    rd2[:, 1] = np.abs(rd2[:, 1]) + 0.2
    rd2 = (rd2 / np.linalg.norm(rd2, axis=-1, keepdims=True)).astype(np.float32)
    rays = np.concatenate([np.array(ro), ro2]), np.concatenate([np.array(rd), rd2])
    return ja, ta, rays


def test_nested_scene_walk_matches_jax(nested_scene):
    """The port's scene-BVH walk against svgf_tpu's on the nested scene,
    whose tree is 79 levels deep: the same arrays bit for bit, the same
    hits and winners, t to 1e-5; the camera sees many sheets."""
    ja, ta, (ro, rd) = nested_scene
    want_arrays = jax.tree.map(np.asarray, ja)
    for name in ("world_tris9", "wbvh_bounds6", "wbvh_skip", "wbvh_leaf_tri"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(), getattr(want_arrays, name),
                                      err_msg=name)
    assert ta.meta.has_scene_bvh and ta.meta.n_world_tris == 20002
    R = ro.shape[0]
    comp = lambda x: (x[:, 0], x[:, 1], x[:, 2])
    want = jax.jit(lambda a, o, d: j_traverse(a, comp(o), comp(d), JHit.none((R,)),
                                               jnp.ones((R,), bool)))(
        ja, jnp.asarray(ro), jnp.asarray(rd))
    got = traverse_scene_bvh(ta, _t(ro), _t(rd))
    hit = _np(want.dist) < 1e29
    np.testing.assert_array_equal(_np(got.dist) < 1e29, hit)
    assert hit.mean() > 0.9
    for f in ("prim", "instance", "material"):
        np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(_np(got.dist), _np(want.dist), rtol=1e-5, atol=1e-5)
    assert len(set(_np(got.instance)[:60][hit[:60]].tolist())) >= 20


def test_nearest_first_walk_stack_fits_the_depth(nested_scene):
    """K6's premise on a deep tree: nearest child first, a walk pushes at
    most one entry for each level it descends, so no lane ever holds more
    than the tree's depth, what K6's 64-entry stack and its scratch of
    spill_entries(depth) = 15 entries a ray hold here. These rays start
    inside many nested boxes and hold more than the 64 entries at once:
    the nested scene takes K6's spill on its own route. The walk finds the
    skip-link walk's winners."""
    _, ta, (ro, rd) = nested_scene
    ro, rd = _t(ro), _t(rd)
    bvh = KI.child_pair_bvh(ta)
    assert bvh.depth == 79 and KI.spill_entries(bvh.depth) == 15
    t0 = start_dist(None, ro.shape[0], "cpu")
    want_t, want_col = _walk_scene_bvh(ta, ro, rd, t0, None, None)
    got_t, got_col, visits, deepest = _nearest_first_walk(bvh, ta, ro, rd, t0)
    assert int(deepest.max()) <= bvh.depth
    assert int(deepest.max()) > KI.BVH_STACK
    assert torch.equal(got_col >= 0, want_col >= 0) and torch.equal(got_t, want_t)
    differ = got_col != want_col
    assert float(differ.float().mean()) <= 1e-2
    assert int(visits.max()) > 0


@pytest.mark.parametrize("depth,entries", [(1, 0), (21, 0), (64, 0), (65, 1), (79, 15),
                                           (269, 205)])
def test_spill_entries(depth, entries):
    """The scratch entries a ray past K6's 64-entry stack: none where the
    stack holds the tree's depth, else the depth's excess."""
    assert KI.spill_entries(depth) == entries


# ---------------------------------------------------------------------------
# any_hit (tests/test_bvh.py:114-119)
# ---------------------------------------------------------------------------


def _bvh_test_camera_rays(n, seed):
    """tests/test_bvh.py _camera_rays: from the Cornell eye into the box."""
    rng = np.random.default_rng(seed)
    ro = np.tile(np.array([[0.0, 0.0, 3.4]], np.float32), (n, 1))
    d = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n), -np.ones(n)], axis=-1)
    return ro, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("intersector", ["dense", "bvh"])
def test_any_hit_consistency(cornell, stress, stress_rays, intersector):
    """any_hit reports a hit iff closest-hit does, on the dense sweep (the
    Cornell box, the camera rays of tests/test_bvh.py) and the plain
    scene-BVH walk (the stress scene), through intersect_scene and the
    kernel wrappers' CPU side; the walk's first hit is a real hit, never
    nearer than the closest, and the dense sweep takes any_hit as
    closest-hit, as svgf_tpu's kernels do."""
    if intersector == "dense":
        ja, ta = cornell
        ro, rd = _bvh_test_camera_rays(256, seed=2)
        wrapper = KI.intersect_dense_kernel
        assert 0 < ta.meta.n_world_tris <= 16384
    else:
        ja, ta = stress
        ro, rd = stress_rays["scrambled"]
        wrapper = KI.intersect_clustered_kernel
        assert ta.meta.has_scene_bvh
    for fn in (lambda **kw: intersect_scene(ta, _t(ro), _t(rd), "off", **kw),
               lambda **kw: wrapper(ta, _t(ro), _t(rd), **kw)):
        h_any, h_close = fn(any_hit=True), fn()
        valid_any, valid_close = _np(h_any.dist) < 1e29, _np(h_close.dist) < 1e29
        np.testing.assert_array_equal(valid_any, valid_close)
        assert valid_close.mean() > 0.2
        assert (_np(h_any.dist) >= _np(h_close.dist))[valid_any].all()
        if intersector == "dense":
            for f in HIT_FIELDS:
                np.testing.assert_array_equal(_np(getattr(h_any, f)), _np(getattr(h_close, f)))
    # svgf_tpu's own any-hit verdicts (tests/test_bvh.py) are the same
    j_any = j_intersect_scene(ja, jnp.asarray(ro), jnp.asarray(rd), any_hit=True)
    np.testing.assert_array_equal(_np(j_any.dist) < 1e29, valid_close)


# ---------------------------------------------------------------------------
# the per-shape walk, the brute force, and the native builder's tree
# ---------------------------------------------------------------------------


def _j_plain(ja, ro, rd, fn=j_intersect_scene, **kw):
    """svgf_tpu's `fn` (intersect_scene) off its Pallas route, jitted; NumPy out."""
    set_pallas_mode("off")
    try:
        out = jax.jit(lambda a, o, d: fn(a, o, d, **kw))(ja, jnp.asarray(ro), jnp.asarray(rd))
    finally:
        set_pallas_mode("auto")
    return jax.tree.map(np.asarray, out)


def _light_rays(R=256):
    """Rays straight up at the light quad (instance 1), as in
    test_large_intersect_only_instance_tmax_active."""
    up = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (R, 1))
    o = np.stack([np.linspace(-1.2, 1.2, R), np.full(R, 0.5), np.linspace(-0.9, 0.9, R)],
                 axis=1).astype(np.float32)
    return o, up


def _assert_same_hits(got, want, uv_atol=5e-5):
    """The same winners and ids on every lane, dist to 1e-5; u and v to
    5e-5 (see test_scene_bvh_walk_matches_jax)."""
    for f in ("prim", "instance", "material"):
        np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(_np(got.dist), _np(want.dist), atol=1e-5, err_msg="dist")
    for f in ("u", "v"):
        np.testing.assert_allclose(_np(getattr(got, f)), _np(getattr(want, f)), atol=uv_atol,
                                   err_msg=f)


@pytest.mark.parametrize("case", ["terrain, camera", "terrain, scrambled, active + tmax",
                                  "light, up"])
def test_instance_walk_matches_jax(stress, stress_rays, case):
    """intersect_scene's plain route on a large scene with only_instance
    walks that instance's BLAS in object space (intersect_instances,
    traverse_shape), as svgf_tpu's intersect_scene with its Pallas route
    off (`:322-354`): the same winners, t in world units."""
    ja, ta = stress
    inst = 1 if case.startswith("light") else 0
    ro, rd = _light_rays() if inst else stress_rays[case.split(", ")[1]]
    kw = {"only_instance": inst}
    if case.endswith("tmax"):
        rng = np.random.default_rng(9)
        kw["active"] = rng.uniform(size=ro.shape[0]) < 0.8
        kw["tmax"] = rng.uniform(0.5, 4.0, ro.shape[0]).astype(np.float32)
    got = intersect_scene(ta, _t(ro), _t(rd), "off",
                          **{k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    want = _j_plain(ja, ro, rd, **kw)
    assert (want.dist < kw.get("tmax", 1e29)).mean() > 0.1
    _assert_same_hits(got, want)


def test_traverse_shape_matches_jax(stress, stress_rays):
    """traverse_shape itself on object-space component rays, from a
    running Hit that the walk must beat, against svgf_tpu's."""
    ja, ta = stress
    ro, rd = stress_rays["scrambled"]
    R = ro.shape[0]
    rng = np.random.default_rng(10)
    active = rng.uniform(size=R) < 0.9
    start = rng.uniform(1.0, 6.0, R).astype(np.float32)
    inv = ta.inst_inv_transform[0]
    ro_o = tuple(_np(x) for x in transform_point3(inv, tuple(_t(ro).unbind(1))))
    rd_o = tuple(_np(x) for x in transform_vector3(inv, tuple(_t(rd).unbind(1))))
    shape, mat = int(ta.inst_shape[0]), int(ta.inst_material[0])
    prim, inst = np.full(R, 7, np.int32), np.full(R, 5, np.int32)
    h0 = JHit.none((R,))._replace(dist=jnp.asarray(start), prim=jnp.asarray(prim),
                                  instance=jnp.asarray(inst))
    want = jax.jit(lambda a, o, d, m: j_traverse_shape(a, shape, o, d, h0, 0, mat, m))(
        ja, tuple(map(jnp.asarray, ro_o)), tuple(map(jnp.asarray, rd_o)), jnp.asarray(active))
    zf = torch.zeros(R)
    got = traverse_shape(ta, shape, tuple(map(_t, ro_o)), tuple(map(_t, rd_o)),
                         Hit(_t(start), zf, zf, _t(prim), _t(inst), torch.zeros_like(_t(inst))),
                         0, mat, _t(active))
    assert 0.1 < (_np(want.dist) < start).mean() < 0.9
    _assert_same_hits(got, jax.tree.map(np.asarray, want))


def test_instance_walk_gradient_matches_jax_jvp(stress, stress_rays):
    """d dist / d ro through the per-instance walk (the winner picked, its
    t/u/v recomputed in object space under autograd) against the forward-
    mode derivative of svgf_tpu's walk (jax.jvp: reverse mode does not
    pass lax.while_loop), one tangent per axis of the origin."""
    ja, ta = stress
    ro, rd = stress_rays["camera"]
    o = _t(ro).requires_grad_(True)
    hit = intersect_scene(ta, o, _t(rd), "off", only_instance=0)
    (got,) = torch.autograd.grad(hit.dist.sum(), o)
    set_pallas_mode("off")
    try:
        dist = lambda x: j_intersect_scene(ja, x, jnp.asarray(rd), only_instance=0).dist
        jvp = jax.jit(lambda x, t: jax.jvp(dist, (x,), (t,))[1])
        want = np.stack([np.asarray(jvp(jnp.asarray(ro), jnp.asarray(np.eye(3, dtype=np.float32)[k]
                                                                      * np.ones_like(ro))))
                         for k in range(3)], axis=-1)
    finally:
        set_pallas_mode("auto")
    hits = _np(hit.dist) < 1e29
    assert hits.mean() > 0.3 and np.abs(want[hits]).max() > 0.1
    np.testing.assert_allclose(_np(got), want, atol=1e-4)


def _mixed_rays(stress_rays, n=128):
    return tuple(np.concatenate([stress_rays["camera"][k][:n], stress_rays["scrambled"][k][:n]])
                 for k in range(2))


def test_brute_force_matches_jax_and_the_walks(stress, stress_rays):
    """intersect_brute_force against svgf_tpu's, and the port's walks on
    the NumPy tree (the scene walk and every instance's BLAS walk)
    against it."""
    ja, ta = stress
    ro, rd = _mixed_rays(stress_rays)
    got = intersect_brute_force(ta, _t(ro), _t(rd))
    want = _j_plain(ja, ro, rd, fn=j_brute_force)
    _assert_same_hits(got, want)
    for walk in (traverse_scene_bvh, intersect_instances):
        _assert_hits_agree(walk(ta, _t(ro), _t(rd)), got)


@pytest.fixture(scope="module")
def native_stress():
    """stress_scene(n=96) flattened by the port with its default, native
    builder (tests/test_torch_native.py holds it to svgf_tpu's)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SVGF_NATIVE", "1")
    try:
        scene = stress_scene(n=96)
        return scene, scene.flatten(device="cpu")
    finally:
        mp.undo()


def test_native_tree_walks_match_brute_force(stress, native_stress, stress_rays):
    """On the native tree, which orders the soup and the scene BVH other
    than the NumPy tree, the scene walk, the instance walks and the model
    of K6's nearest-first walk find the brute force's hits."""
    _, ta = native_stress
    assert not torch.equal(ta.world_tri_prim, stress[1].world_tri_prim)
    ro, rd = (_t(x) for x in _mixed_rays(stress_rays))
    brute = intersect_brute_force(ta, ro, rd)
    for walk in (traverse_scene_bvh, intersect_instances):
        _assert_hits_agree(walk(ta, ro, rd), brute)
    t0 = start_dist(None, ro.shape[0], "cpu")
    want_t, want_col = _walk_scene_bvh(ta, ro, rd, t0, None, None)
    got_t, got_col, _, _ = _nearest_first_walk(KI.child_pair_bvh(ta), ta, ro, rd, t0)
    assert torch.equal(got_col >= 0, want_col >= 0) and torch.equal(got_t, want_t)


def test_k6_premises_on_the_native_tree(native_stress):
    """What K6 needs of a tree, on the native one: child_pair_bvh accepts
    it (a binary tree of one-triangle leaves, children after their
    parent); its depth is the skip-link tree's, from which spill_entries
    sizes the scratch; and the soup and the stitched scene BVH follow the
    native BLAS: each instance's soup columns hold its shape's native leaf
    order, and the scene BVH's leaves reach every soup column once."""
    scene, ta = native_stress
    bvh = KI.child_pair_bvh(ta)
    skip, leaf = ta.wbvh_skip.long(), ta.wbvh_leaf_tri.long()
    inner = torch.nonzero(leaf < 0).flatten()
    ranges = torch.zeros(skip.shape[0] + 1, dtype=torch.long)
    ranges.index_add_(0, inner, torch.ones_like(inner))
    ranges.index_add_(0, skip[inner], -torch.ones_like(inner))
    assert bvh.depth == int(torch.cumsum(ranges, 0)[:-1].max())
    assert KI.spill_entries(bvh.depth) == 0 < bvh.depth <= KI.BVH_STACK
    for i, (start, count) in enumerate(ta.meta.inst_world_range):
        sh = scene.shapes[scene.instances[i].shape]
        mp = pytest.MonkeyPatch()
        mp.setenv("SVGF_NATIVE", "1")
        try:
            order = build_blas(sh.tri_pos).tri_order
        finally:
            mp.undo()
        base = int(ta.shape_tri_start[scene.instances[i].shape])
        np.testing.assert_array_equal(_np(ta.world_tri_prim[start:start + count]), order + base)
    n = ta.meta.n_world_tris
    assert torch.equal(torch.sort(leaf[leaf >= 0]).values, torch.arange(n))


# ---------------------------------------------------------------------------
# the small pieces: geometry helpers and the TLAS
# ---------------------------------------------------------------------------


def test_geometry_helpers_match_jax():
    """ray_triangle and ray_aabb on (..., 3) arrays (a ray against every
    triangle and box by broadcasting), transform_point3 and
    transform_vector3 on component tuples, against svgf_tpu's on seeded
    inputs: hit masks equal, values to float32 rounding."""
    rng = np.random.default_rng(12)
    R, T = 64, 48
    ro = rng.uniform(-1, 1, (R, 1, 3)).astype(np.float32)
    rd = rng.standard_normal((R, 1, 3)).astype(np.float32)
    v = rng.uniform(-1.5, 1.5, (3, 1, T, 3)).astype(np.float32)
    lo = rng.uniform(-1.5, 0.5, (1, T, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.1, 1.0, (1, T, 3))).astype(np.float32)
    tmax = rng.uniform(0.5, 5.0, (R, 1)).astype(np.float32)
    want = JG.ray_triangle(*map(jnp.asarray, (ro, rd, v[0], v[1], v[2])))
    got = TG.ray_triangle(*map(_t, (ro, rd, v[0], v[1], v[2])))
    assert 0.02 < _np(got[3]).mean() < 0.98
    hit = np.asarray(want[3])
    np.testing.assert_array_equal(_np(got[3]), hit)
    # t is MAX_LENGTH off the triangle; u and v are compared where they
    # are a hit's barycentrics (elsewhere a near-parallel ray's 1/a makes
    # them arbitrary)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(_np(g)[hit], np.asarray(w)[hit], rtol=1e-5, atol=1e-6)
    inv = 1.0 / rd
    want = np.asarray(JG.ray_aabb(*map(jnp.asarray, (ro, inv, lo, hi, tmax))))
    got = _np(TG.ray_aabb(*map(_t, (ro, inv, lo, hi, tmax))))
    assert 0.02 < (want < 1e29).mean() < 0.98
    np.testing.assert_array_equal(got < 1e29, want < 1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    m = rng.uniform(-2, 2, (4, 4)).astype(np.float32)
    p = tuple(rng.uniform(-3, 3, (3, R)).astype(np.float32))
    for jf, tf in ((JG.transform_point3, TG.transform_point3),
                   (JG.transform_vector3, TG.transform_vector3)):
        want = jf(jnp.asarray(m), tuple(map(jnp.asarray, p)))
        got = tf(_t(m), tuple(map(_t, p)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_build_tlas_matches_jax():
    """build_tlas over 9 seeded instance boxes and over none: svgf_tpu's
    TLAS bit for bit."""
    rng = np.random.default_rng(13)
    lo = rng.uniform(-5, 5, (9, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.1, 2.0, (9, 3))).astype(np.float32)
    for args in ((lo, hi), (lo[:0], hi[:0])):
        got, want = build_tlas(*args), j_build_tlas(*args)
        for f in ("node_min", "node_max", "skip", "leaf_instance"):
            g, w = getattr(got, f), getattr(want, f)
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), f
    assert (build_tlas(lo, hi).leaf_instance >= 0).sum() == 9
