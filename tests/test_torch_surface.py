"""The port's public surface against svgf_tpu's.

* Name parity, one case per svgf_tpu module outside kernels/: every public
  name a module defines (functions, classes, top-level constants; not
  imported names) resolves on the port's module at the same path, and
  every public member of each such class on the port's class.
* Package parity: the `__all__` of svgf_tpu and of its core, accel,
  scenes, io and parallel packages resolve on the port's packages.
* The kernel map: each svgf_tpu function that reaches `pl.pallas_call`
  against the port's wrapper of its CUDA kernel and chip_smoke.py's row.
* The exceptions, each with its reason: a name that the port in fact has
  fails its case, so the table cannot go stale.
* Behaviour on the CPU against svgf_tpu: `Hit.none`, `Hit.valid`, the
  `SceneArrays` counts and `project_to_pixel`.

svgf_tpu's names are read from its sources with `ast`; only the behaviour
cases run svgf_tpu's code.
"""

import ast
import importlib
import importlib.util
import inspect
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgf_tpu.core.camera import look_at_frame as j_look_at_frame
from svgf_tpu.core.camera import orbit_frame as j_orbit_frame
from svgf_tpu.core.camera import perspective as j_perspective
from svgf_tpu.core.scene import Environment as JEnvironment
from svgf_tpu.core.scene import Material as JMaterial
from svgf_tpu.core.scene import MaterialType as JMaterialType
from svgf_tpu.ops.intersect import Hit as JHit
from svgf_tpu.ops.intersect import intersect_dense as j_intersect_dense
from svgf_tpu.render.gbuffer import camera_rays as j_camera_rays
from svgf_tpu.render.gbuffer import project_to_pixel as j_project_to_pixel
from svgf_tpu.scenes import cornell_box as j_cornell
from svgf_tpu_torch import convert
from svgf_tpu_torch.core.camera import look_at_frame
from svgf_tpu_torch.core.scene import Environment, Material, MaterialType
from svgf_tpu_torch.ops.intersect import Hit, intersect_dense
from svgf_tpu_torch.render.gbuffer import project_to_pixel
from svgf_tpu_torch.scenes import cornell_box
from svgf_tpu_torch.scenes.materials import dress_cornell

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W = 36, 64   # 16:9: the Cornell camera sees past the box's open front


def _module_path(name: str) -> pathlib.Path:
    path = ROOT.joinpath(*name.split("."))
    return path / "__init__.py" if path.is_dir() else path.with_suffix(".py")


def _jax_modules() -> list[str]:
    """Every svgf_tpu module outside kernels/, as a dotted name."""
    out = []
    for p in sorted((ROOT / "svgf_tpu").rglob("*.py")):
        parts = p.relative_to(ROOT).with_suffix("").parts
        parts = parts[:-1] if parts[-1] == "__init__" else parts
        if parts[:2] != ("svgf_tpu", "kernels"):
            out.append(".".join(parts))
    return out


def _class_members(node: ast.ClassDef) -> set[str]:
    names = set()
    for b in node.body:
        if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(b.name)
        elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
            names.add(b.target.id)
        elif isinstance(b, ast.Assign):
            names.update(t.id for t in b.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _defined(module: str) -> dict:
    """The public names `module` defines at its top level: {name: the public
    members of the class, or None for a function or constant}."""
    names = {}
    for node in ast.parse(_module_path(module).read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names[node.name] = None
        elif isinstance(node, ast.ClassDef):
            names[node.name] = _class_members(node)
        elif isinstance(node, ast.Assign):
            names.update((t.id, None) for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names[node.target.id] = None
    return {k: v for k, v in names.items() if not k.startswith("_")}


def _all(module: str) -> list[str]:
    """`module`'s `__all__`, read from its source."""
    for node in ast.parse(_module_path(module).read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{module} has no __all__")


def _port(name: str) -> str:
    return "svgf_tpu_torch" + name[len("svgf_tpu"):]


def _has_member(cls, name: str) -> bool:
    """A class attribute, or a field (dataclass, NamedTuple) declared on the class or a base."""
    return hasattr(cls, name) or any(name in inspect.get_annotations(k) for k in cls.__mro__)


def _resolve(path: str):
    """The object at a dotted path of the port, through submodules and then
    attributes (a field declared without a default resolves to its class);
    None when the path does not resolve."""
    parts = path.split(".")
    obj = importlib.import_module(parts[0])
    for i, attr in enumerate(parts[1:], 2):
        if inspect.ismodule(obj) and not hasattr(obj, attr):
            name = ".".join(parts[:i])
            if not hasattr(obj, "__path__") or importlib.util.find_spec(name) is None:
                return None
            obj = importlib.import_module(name)
        elif inspect.isclass(obj) and _has_member(obj, attr):
            obj = getattr(obj, attr, obj)
        elif hasattr(obj, attr) and not inspect.isclass(obj):
            obj = getattr(obj, attr)
        else:
            return None
    return obj


# svgf_tpu's names the port does not have at the same path, by decision
# (ROADMAP.md Q1 "Not ported, by decision"): name -> (reason, the port's
# counterpart at another path, or None)
EXCEPTIONS = {
    "svgf_tpu.ops.gather": (
        "MXU one-hot gathers: a TPU's fast gather; the port indexes directly", None),
    "svgf_tpu.ops.intersect.set_pallas_mode": (
        "module state; the port passes the policy as intersect_scene's `mode`", None),
    "svgf_tpu.accel.clusters.MAX_CLUSTERS": (
        "the clustered Pallas kernel's ceiling; K6's per-thread walk has none", None),
    "svgf_tpu.render.types.PlanarState": (
        "the 128-lane padded planar layout exists for Mosaic; the port keeps one HWC layout", None),
    "svgf_tpu.render.types.TemporalState.planar": (
        "converts to the planar layout, which the port does not have", None),
    "svgf_tpu.render.types.TemporalState.initial_planar": (
        "the planar layout's initial state, which the port does not have", None),
    "svgf_tpu.kernels.pack_prev_planes": (
        "packs fp16 pairs into f32 planes (Mosaic has no f16 VMEM type); the port stores fp16",
        None),
    "svgf_tpu.kernels.resolve_pallas": (
        "the kernel policy also takes the tensors' device",
        "svgf_tpu_torch.kernels.resolve_kernels"),
    "svgf_tpu.parallel.sharded.make_row_mesh": (
        "a row mesh is the torch.distributed process group's, built beside init_distributed",
        "svgf_tpu_torch.parallel.distributed.make_row_mesh"),
}


@pytest.mark.parametrize("module", _jax_modules())
def test_module_names_resolve(module):
    """Every public name `module` defines, and every public member of each
    of its classes, resolves on the port's module at the same path."""
    if module in EXCEPTIONS:
        assert importlib.util.find_spec(_port(module)) is None, module
        return
    port = importlib.import_module(_port(module))
    missing = []
    for name, members in _defined(module).items():
        if f"{module}.{name}" in EXCEPTIONS:
            continue
        if not hasattr(port, name):
            missing.append(name)
            continue
        for m in members or ():
            if f"{module}.{name}.{m}" not in EXCEPTIONS and not _has_member(getattr(port, name), m):
                missing.append(f"{name}.{m}")
    assert missing == [], f"{_port(module)} lacks {missing}"


def test_every_module_is_walked():
    """The walk finds the packages and the modules (not only one of them)."""
    mods = _jax_modules()
    assert len(mods) >= 40 and "svgf_tpu" in mods and "svgf_tpu.core.scene" in mods
    assert not any(m.startswith("svgf_tpu.kernels") for m in mods)


@pytest.mark.parametrize("package,exact", [
    ("svgf_tpu", True), ("svgf_tpu.core", True), ("svgf_tpu.accel", True),
    ("svgf_tpu.scenes", True), ("svgf_tpu.io", True),
    # the port's parallel package also exports its meshes' types and helpers
    ("svgf_tpu.parallel", False),
])
def test_package_all_resolves(package, exact):
    names = _all(package)
    port = importlib.import_module(_port(package))
    assert [n for n in names if not hasattr(port, n)] == [], package
    if exact:
        assert sorted(port.__all__) == sorted(names), package
    else:
        assert set(port.__all__) >= set(names), package


# Each svgf_tpu function that reaches `pl.pallas_call` (ROADMAP.md Q2):
# K, chip_smoke.py's row, its file under svgf_tpu/kernels/, the function,
# the function that holds the pallas_call site, the port's wrapper (in
# svgf_tpu_torch/kernels/)
KERNEL_MAP = (
    ("K1", "temporal", "planar.py", "temporal_planar", "temporal_planar",
     "filter.temporal_filter"),
    ("K2", "moments", "planar.py", "moments_planar", "moments_planar", "filter.filter_moments"),
    ("K3", "atrous", "planar.py", "atrous_chain_planar_v2", "atrous_chain_planar_v2",
     "filter.wavelet_filter"),
    ("K4", "taa", "planar.py", "taa_planar", "taa_planar", "filter.taa"),
    ("K5", "intersect_dense", "intersect_pallas.py", "intersect_dense_pallas", "_intersect_rays",
     "intersect.intersect_dense_kernel"),
    ("K6", "intersect_clustered", "intersect_pallas.py", "intersect_clustered_pallas",
     "_intersect_rays_clustered", "intersect.intersect_clustered_kernel"),
    ("K7", "temporal_band", "temporal_pallas.py", "temporal_filter_pallas",
     "temporal_filter_pallas", "filter.temporal_filter_band"),
    ("K8", "moments_band", "moments_pallas.py", "filter_moments_pallas", "filter_moments_pallas",
     "filter.filter_moments_band"),
    # one HWC layout in the port: K3's chain is this function
    ("K9a", "atrous_chain", "atrous_pallas.py", "atrous_chain_pallas", "atrous_chain_pallas",
     "filter.wavelet_filter"),
    ("K9b", "atrous_iteration", "atrous_pallas.py", "atrous_iteration_pallas",
     "atrous_iteration_pallas", "filter.atrous_iteration"),
    ("K10", "taa_band", "taa_pallas.py", "taa_pallas", "taa_pallas", "filter.taa_band"),
)


def _functions(file: str) -> dict:
    tree = ast.parse((ROOT / "svgf_tpu" / "kernels" / file).read_text())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _calls_pallas(fn: ast.FunctionDef) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "pallas_call" for n in ast.walk(fn))


@pytest.mark.parametrize("k,row,file,function,site,wrapper", KERNEL_MAP,
                         ids=[m[0] for m in KERNEL_MAP])
def test_kernel_map(k, row, file, function, site, wrapper):
    """The TPU function and its pallas_call site exist, the port's wrapper
    is a callable, and chip_smoke.py's row names the function's file:line
    and a CUDA source that exists."""
    import chip_smoke

    fns = _functions(file)
    assert function in fns and _calls_pallas(fns[site]), (k, function, site)
    mod, name = wrapper.split(".")
    assert callable(getattr(importlib.import_module(f"svgf_tpu_torch.kernels.{mod}"), name)), k
    rows = {r[0]: r for r in chip_smoke.KERNELS}
    _, source, replaces = rows[row]
    assert replaces == f"svgf_tpu/kernels/{file}:{fns[function].lineno}", (k, replaces)
    assert (ROOT / source).is_file(), source


def test_kernel_map_covers_every_site():
    """Every pallas_call site of svgf_tpu/kernels/ is one row's, every
    chip_smoke.py row is one K's, and each name of svgf_tpu.kernels'
    `__all__` is a mapped function or an exception."""
    import chip_smoke

    files = sorted(p.name for p in (ROOT / "svgf_tpu" / "kernels").glob("*.py"))
    sites = {(f, name) for f in files for name, fn in _functions(f).items() if _calls_pallas(fn)}
    assert sites == {(m[2], m[4]) for m in KERNEL_MAP}
    assert sorted(r[0] for r in chip_smoke.KERNELS) == sorted(m[1] for m in KERNEL_MAP)
    mapped = {m[3] for m in KERNEL_MAP}
    assert [n for n in _all("svgf_tpu.kernels")
            if n not in mapped and f"svgf_tpu.kernels.{n}" not in EXCEPTIONS] == []


@pytest.mark.parametrize("name", sorted(EXCEPTIONS))
def test_exception_stands(name):
    """The port does not have the name at svgf_tpu's path (or, for a name
    it keeps elsewhere, does not define it there), and the counterpart it
    names is defined where it says."""
    reason, counterpart = EXCEPTIONS[name]
    assert len(reason) > 20, name
    found = _resolve(_port(name))
    if counterpart is None:
        assert found is None, f"the port has {_port(name)}: drop its exception"
        return
    module, attr = counterpart.rsplit(".", 1)
    assert getattr(importlib.import_module(module), attr).__module__ == module, counterpart
    assert found is None or found.__module__ != _port(name).rsplit(".", 1)[0], (
        f"the port defines {_port(name)}: drop its exception")


@pytest.mark.parametrize("module", ["svgf_tpu_torch.core.scene", "svgf_tpu_torch.accel"])
def test_first_import(module):
    """The package namespaces import without a cycle from a fresh interpreter."""
    proc = subprocess.run([sys.executable, "-c", f"import {module}"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# behaviour against svgf_tpu
# ---------------------------------------------------------------------------


def test_hit_none_matches_jax():
    """Field for field, in value and dtype; the card is the default device."""
    want = JHit.none((257,))
    got = Hit.none((257,), device="cpu")
    for f in Hit._fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert not got.valid.any()
    assert inspect.signature(Hit.none).parameters["device"].default == "cuda"


def test_hit_valid_matches_jax_on_cornell():
    """The primary hits of the 16:9 Cornell view (some rays leave through
    the open front) from a slightly orbited camera: `valid` equal wherever
    the winner's instance agrees, which a ray through an edge shared by two
    instances may not (tests/test_torch_trace.py's rule)."""
    scene = j_cornell(aspect=W / H)
    scene.cameras[0] = scene.cameras[0].advance(
        j_orbit_frame([0, 0, 0], 3.4, theta=0.021, phi=0.013))
    ja = scene.flatten()
    ta = convert.scene_arrays(jax.tree.map(np.asarray, ja), device="cpu")
    ro, rd = jax.jit(lambda a: j_camera_rays(a.cam_frame[0], a.cam_proj[0], H, W))(ja)
    want = jax.jit(j_intersect_dense)(ja, ro, rd)
    got = intersect_dense(ta, torch.from_numpy(np.array(ro)), torch.from_numpy(np.array(rd)))
    same = got.instance.numpy() == np.asarray(want.instance)
    assert same.mean() >= 0.999, same.mean()
    valid = np.asarray(want.valid)
    assert 0.3 < valid.mean() < 0.99, valid.mean()
    np.testing.assert_array_equal(got.valid.numpy()[same], valid[same])


def _materials_scene(cornell, material, material_type, environment):
    return dress_cornell(cornell(aspect=W / H), material, material_type, environment)


@pytest.mark.parametrize("scene", ["cornell", "materials"])
def test_scene_array_counts_match_jax(scene, monkeypatch):
    """The four counts on Cornell and on the materials scene (two lights, an
    environment), both packages flattening with the NumPy builder."""
    monkeypatch.setenv("SVGF_NATIVE", "0")
    if scene == "cornell":
        ja, ta = j_cornell(aspect=W / H).flatten(), cornell_box(aspect=W / H).flatten(device="cpu")
    else:
        ja = _materials_scene(j_cornell, JMaterial, JMaterialType, JEnvironment).flatten()
        ta = _materials_scene(cornell_box, Material, MaterialType, Environment).flatten(
            device="cpu")
    counts = ("n_triangles", "n_instances", "n_lights", "n_environments")
    assert {c: getattr(ta, c) for c in counts} == {c: getattr(ja, c) for c in counts}
    assert ta.n_lights == ta.meta.n_lights and ta.n_instances == ta.meta.n_instances
    assert ta.n_environments == (1 if scene == "materials" else 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_project_to_pixel_matches_jax(seed):
    """Seeded camera frames and points in and around their view, at 64x36.
    The first argument is the camera frame, as in svgf_tpu (the port once
    took its inverse there). Tolerance: 4 ulp of an NDC coordinate in
    [1, 2) in pixels, 4 * 2**-22 * w/2 (3.05e-5 in x, 1.72e-5 in y). The
    G-buffer's motion bar, atol 1e-5 (tests/test_torch_trace.py), holds
    on motion, a difference of two projections; one projection in float32
    is off the float64 truth by up to 2.2e-5 px in either package here."""
    rng = np.random.default_rng(seed)
    eye = rng.uniform(-3.0, 3.0, 3)
    target = rng.uniform(-0.5, 0.5, 3)
    frame = np.asarray(j_look_at_frame(eye, target), np.float32)
    np.testing.assert_array_equal(look_at_frame(eye, target).astype(np.float32), frame)
    proj = np.asarray(j_perspective(rng.uniform(30.0, 70.0), W / H), np.float32)
    # camera-space points 0.5-6 in front, spread 1.2x the view, to world space
    z = rng.uniform(0.5, 6.0, 4096)
    cam = np.stack([rng.uniform(-1.2, 1.2, z.size) * z / proj[0, 0],
                    rng.uniform(-1.2, 1.2, z.size) * z / proj[1, 1], -z, np.ones_like(z)], -1)
    pos = (cam @ frame.T.astype(np.float64))[:, :3].astype(np.float32)
    want = jax.jit(j_project_to_pixel, static_argnums=(3, 4))(
        jnp.asarray(frame), jnp.asarray(proj), jnp.asarray(pos), H, W)
    got = project_to_pixel(torch.from_numpy(frame), torch.from_numpy(proj), torch.from_numpy(pos),
                           H, W)
    for g, w, size in zip(got, want, (W, H)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=4 * 2.0**-22 * size / 2)
    assert float(np.abs(np.asarray(want[0]) - W / 2).max()) > W / 2   # some points off-screen
