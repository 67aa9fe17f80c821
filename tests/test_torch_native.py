"""The port's native build components against svgf_tpu's, on the CPU.

svgf_tpu_torch/accel/native.py compiles its own copy of svgf_tpu's
native/bvh_builder.cpp (svgf_tpu_torch/csrc_host/bvh_builder.cpp) with
native/Makefile's flags. On one machine its BLAS and its tangents are
bit-equal to svgf_tpu's native ones, so a scene flattened natively by both
packages is equal field by field; it is the default of a flatten and of
an asset import. SVGF_NATIVE=0 still gives the NumPy tree, and a build
that fails raises instead of falling back.

svgf_tpu's library is built as tests/test_native.py builds it (make -C
native); the tests skip only where there is no g++.
"""

import dataclasses
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest

from svgf_tpu.accel import native as j_native
from svgf_tpu.accel.bvh import build_blas as j_build_blas
from svgf_tpu.scenes.stress import stress_scene as j_stress
from svgf_tpu_torch.accel import bvh as t_bvh
from svgf_tpu_torch.accel import native
from svgf_tpu_torch.core import edits
from svgf_tpu_torch.core.scene import SceneArrays, SceneMeta, _lengyel_tangents
from svgf_tpu_torch.scenes.cornell import cornell_box
from svgf_tpu_torch.scenes.stress import stress_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLAS_FIELDS = ("node_min", "node_max", "skip", "tri_first", "tri_count", "tri_order")


@pytest.fixture(scope="module", autouse=True)
def built_lib():
    """svgf_tpu's library (tests/test_native.py's fixture), and the port's."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler")
    for _ in range(2):   # a second probe, should another worker's make be mid-link
        if j_native.available():
            break
        r = subprocess.run(["make", "-C", os.path.join(REPO, "native")], capture_output=True)
        assert r.returncode == 0, r.stdout + r.stderr
        j_native._TRIED = False  # re-probe
    assert j_native.available()
    assert native.available()


def random_tris(n, seed=0):
    """tests/test_native.py random_tris."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, size=(n, 1, 3))
    return (base + rng.uniform(-0.15, 0.15, size=(n, 3, 3))).astype(np.float32)


def assert_native_blas_equal(tris):
    got = native.build_blas_native(tris)
    want = j_native.build_blas_native(tris)
    for name, g, w in zip(("node_min", "node_max", "skip", "leaf_tri"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    return got


def test_native_blas_bit_equal_and_well_formed():
    """svgf_tpu's native BLAS bit for bit on random_tris(333), with
    tests/test_native.py's structure checks."""
    tris = random_tris(333)
    node_min, node_max, skip, leaf_tri = assert_native_blas_equal(tris)
    n = 2 * 333 - 1
    assert node_min.shape == (n, 3)
    leaves = leaf_tri[leaf_tri >= 0]
    assert sorted(leaves.tolist()) == list(range(333))    # every triangle in one leaf
    assert (skip > np.arange(n)).all() and (skip <= n).all()   # skip links strictly forward
    for i in np.flatnonzero(leaf_tri >= 0):               # leaf bounds hold their triangle
        t = leaf_tri[i]
        assert (tris[t].min(0) >= node_min[i] - 1e-5).all()
        assert (tris[t].max(0) <= node_max[i] + 1e-5).all()


@pytest.mark.parametrize("shape", [0, 1])
def test_native_blas_bit_equal_on_stress_shapes(shape):
    """Each shape of stress_scene(n=96) (the terrain's 18,050 triangles and
    the light's quad): the native arrays, and the BLAS both packages' build_blas
    make of them, bit for bit."""
    sh = stress_scene(n=96).shapes[shape]
    tris = np.asarray(sh.positions, np.float32)[np.asarray(sh.indices)]
    assert_native_blas_equal(tris)
    mp = pytest.MonkeyPatch()
    mp.setenv("SVGF_NATIVE", "1")
    try:
        got, want = t_bvh.build_blas(tris), j_build_blas(tris)
    finally:
        mp.undo()
    for f in BLAS_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f


def test_numpy_builder_under_svgf_native_0(monkeypatch):
    """SVGF_NATIVE=0 gives the NumPy tree (svgf_tpu's NumPy tree, bit for
    bit), which is not the native tree on a heightfield (stress_scene(n=24)'s
    terrain, 1,058 triangles), whose grid of centroids puts many on a bin
    plane that float and float64 binning place on different sides."""
    sh = stress_scene(n=24).shapes[0]
    tris = np.asarray(sh.positions, np.float32)[np.asarray(sh.indices)]
    monkeypatch.setenv("SVGF_NATIVE", "1")
    native_tree = t_bvh.build_blas(tris)
    monkeypatch.setenv("SVGF_NATIVE", "0")
    got, want = t_bvh.build_blas(tris), j_build_blas(tris)
    for f in BLAS_FIELDS:
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
    assert got.tri_order.tobytes() != native_tree.tri_order.tobytes()


def test_native_tangents():
    """The port's native tangents equal svgf_tpu's bit for bit, and
    Lengyel's NumPy tangents within 2e-5 (tests/test_native.py's bar)."""
    rng = np.random.default_rng(5)
    V, F = 64, 100
    pos = rng.uniform(-1, 1, (V, 3)).astype(np.float32)
    nrm = rng.normal(size=(V, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    uv = rng.uniform(0, 1, (V, 2)).astype(np.float32)
    idx = rng.integers(0, V, (F, 3)).astype(np.int32)
    got = native.tangents_native(pos, nrm, uv, idx)
    assert got.tobytes() == j_native.tangents_native(pos, nrm, uv, idx).tobytes()
    np.testing.assert_allclose(got, _lengyel_tangents(pos, nrm, uv, idx.astype(np.int64)),
                               atol=2e-5)


def test_native_flatten_matches_jax(monkeypatch):
    """stress_scene(n=96) flattened by both packages with SVGF_NATIVE=1:
    equal field by field (the native BLAS orders the soup, the stitched
    scene BVH and the cluster bounds), and the native tangents."""
    monkeypatch.setenv("SVGF_NATIVE", "1")
    want = jax.tree.map(np.asarray, j_stress(n=96).flatten())
    got = stress_scene(n=96).flatten(device="cpu")
    assert got.meta.soup_leaf_order and got.meta.has_scene_bvh
    for f in dataclasses.fields(SceneMeta):
        assert getattr(got.meta, f.name) == getattr(want.meta, f.name), f.name
    for name in SceneArrays.tensor_fields():
        w, g = getattr(want, name), getattr(got, name)
        assert g.shape == w.shape and str(g.dtype) == f"torch.{w.dtype}", name
        assert g.numpy().tobytes() == w.tobytes(), name


def test_failed_build_raises(monkeypatch, tmp_path):
    """A build that fails raises with the compiler's complaint and names
    SVGF_NATIVE=0; build_blas does not fall back to NumPy."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.NativeBuildError, match="SVGF_NATIVE=0"):
        native.build()
    native.library.cache_clear()
    try:
        assert not native.available()
        monkeypatch.setenv("SVGF_NATIVE", "1")
        with pytest.raises(native.NativeBuildError, match="no-such-compiler"):
            t_bvh.build_blas(random_tris(5))
        monkeypatch.setenv("SVGF_NATIVE", "0")
        assert t_bvh.build_blas(random_tris(5)).n_nodes == 9
    finally:
        native.library.cache_clear()
    assert list(tmp_path.iterdir()) == []


def test_native_is_the_default_of_asset_imports(monkeypatch, tmp_path):
    """With SVGF_NATIVE unset, an imported mesh (an OBJ of
    stress_scene(n=24)'s terrain through core/edits.py add_asset, which
    loads it and re-flattens) gets the native tree and native tangents,
    and the flattened arrays hold that tree."""
    monkeypatch.delenv("SVGF_NATIVE", raising=False)
    hf = stress_scene(n=24).shapes[0]
    path = tmp_path / "terrain.obj"
    with open(path, "w") as f:
        f.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in hf.positions)   # exact f32
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in hf.indices)
    scene, arrays = edits.add_asset(cornell_box(), str(path), device="cpu")
    sh = scene.shapes[-1]
    node_min, node_max, skip, leaf_tri = native.build_blas_native(sh.tri_pos)
    assert sh.blas.node_min.tobytes() == node_min.tobytes()
    assert sh.blas.tri_order.tobytes() == leaf_tri[leaf_tri >= 0].tobytes()
    P, F = np.asarray(sh.positions, np.float32), np.asarray(sh.indices, np.int32)
    want_tan = native.tangents_native(P, sh.normals, sh.uvs, F)
    assert np.asarray(sh.tangents, np.float32).tobytes() == want_tan.tobytes()
    start = int(arrays.shape_node_start[len(scene.shapes) - 1])
    got = arrays.bvh_node_min[start:start + node_min.shape[0]].numpy()
    assert got.tobytes() == node_min.tobytes()
    monkeypatch.setenv("SVGF_NATIVE", "0")
    assert t_bvh.build_blas(sh.tri_pos).tri_order.tobytes() != sh.blas.tri_order.tobytes()
