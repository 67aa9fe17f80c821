"""The port runs without JAX and without svgf_tpu: the machine with the
card has no JAX, and the port keeps its own copies of what it needs."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_RENDER_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.modules["svgf_tpu"] = None     # and so does any import of the JAX package
# the package namespaces first, in a fresh interpreter, then svgf_tpu's
# quick start (README.md) with only the package name changed, on the CPU
from svgf_tpu_torch import RenderConfig, SVGFConfig, TracingConfig, SamplingMode, DebugOutput
from svgf_tpu_torch.core import *
from svgf_tpu_torch.accel import *
from svgf_tpu_torch.scenes import cornell_box, default_scene
from svgf_tpu_torch.render.pipeline import Renderer

r = Renderer(cornell_box(aspect=16/9), RenderConfig(width=32, height=24), device="cpu")
out = r.step()            # FrameOutputs: radiance, temporal, atrous, final, gbuffer
assert out.final.shape == (24, 32, 3) and bool(out.final.isfinite().all())
assert Scene is type(cornell_box()) and BLAS.__module__ == "svgf_tpu_torch.accel.bvh"
import numpy as np
from svgf_tpu_torch.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_tpu_torch.render.pipeline import Renderer
from svgf_tpu_torch.scenes.cornell import cornell_box
cfg = RenderConfig(width=16, height=16, svgf=SVGFConfig(spatial_filter_steps=2),
                   tracing=TracingConfig(bounces=2))
r = Renderer(cornell_box(), cfg, device="cpu")
out = r.step()
final = out.final.numpy()
assert final.shape == (16, 16, 3) and np.isfinite(final).all()
assert final.min() >= 0.0 and final.max() <= 1.0
# the io modules and the scene edits need no JAX either
import dataclasses, os, tempfile
import torch
from svgf_tpu_torch.io import load_asset, load_checkpoint, save_checkpoint
with tempfile.TemporaryDirectory() as d:
    obj = os.path.join(d, "tri.obj")
    with open(obj, "w") as f:
        f.write("v 0 0 0\\nv 0.5 0 0\\nv 0 0.5 0\\nf 1 2 3\\n")
    n_shapes = len(r.scene.shapes)
    load_asset(obj, r.scene, material=0)
    assert len(r.scene.shapes) == n_shapes + 1 and r.scene.shapes[-1].n_triangles == 1
    ckpt = os.path.join(d, "state.npz")
    save_checkpoint(ckpt, r.state)
    back = load_checkpoint(ckpt, device="cpu")
    assert back.frame_idx == 1 and torch.equal(back.color, r.state.color)
r.update_material(0, dataclasses.replace(r.scene.materials[0], colour=(0.9, 0.2, 0.2)))
assert r.arrays.mat_colour[0, 1].item() == np.float32(0.2)
assert np.isfinite(r.step().final.numpy()).all()
# the tiled mesh, the train steps and the parity checker need no JAX either
from svgf_tpu_torch.parallel import init_params, make_tile_mesh, make_tiled_train_step
from svgf_tpu_torch.parallel.checks import assert_sharded_parity
from svgf_tpu_torch.render.types import TemporalState
tcfg = dataclasses.replace(cfg, use_pallas="off", state_dtype="float32")
train = make_tiled_train_step(tcfg, make_tile_mesh(1, 1))
params = init_params(r.arrays, ("mat_colour", "cam_frame"))
loss, grads, _ = train(params, r.arrays, TemporalState.initial(16, 16, torch.float32, "cpu"),
                       torch.zeros(16, 16, 3))
assert grads["mat_colour"].abs().max() > 0
assert_sharded_parity("without jax", loss, grads, loss, grads)
# the native builder, the per-shape walk, the brute force and the orbit
# script need no JAX either
from svgf_tpu_torch.accel import native
from svgf_tpu_torch.ops.intersect import intersect_brute_force, intersect_scene
from svgf_tpu_torch.scenes.stress import stress_scene
from svgf_tpu_torch.scripts import render_orbit
# the measuring and gradient tools need no JAX either, nor svgf_tpu's scripts or bench.py
from svgf_tpu_torch.scripts import (grad_bisect, grad_bisect2, grad_fd_explore,
                                    measure_balance, profile_trace_parts)
assert measure_balance.main(["2", "8", "8"], device="cpu")["scene"] == "cornell"
os.environ["SVGF_NATIVE"] = "1"
assert native.available()
big = stress_scene(n=96).flatten(device="cpu")
ro = torch.tensor([[0.0, 0.5, 0.0], [0.3, 0.5, 0.2]])
rd = torch.tensor([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
assert torch.equal(intersect_scene(big, ro, rd, "off", only_instance=1).instance,
                   intersect_brute_force(big, ro, rd).instance)
with tempfile.TemporaryDirectory() as d:
    run = render_orbit.main(["--device", "cpu", "--width", "16", "--height", "16", "--frames", "2",
                             "--bounces", "1", "--steps", "1", "--out", d])
    assert len(run.pngs) == 2 and os.path.exists(os.path.join(d, "ckpt.npz"))
assert not any(m in ("jax", "svgf_tpu", "bench", "scripts")
               or m.startswith(("jax.", "jaxlib", "svgf_tpu.", "scripts."))
               for m in sys.modules if sys.modules[m] is not None)
print("rendered without jax")
"""


def test_renders_a_frame_without_jax():
    proc = subprocess.run([sys.executable, "-c", _RENDER_WITHOUT_JAX], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "rendered without jax" in proc.stdout


# an import statement of jax, of svgf_tpu (svgf_tpu_torch is the port), of
# the repository's bench.py or of its scripts/ (the port keeps its own copies)
_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|svgf_tpu|bench|scripts)(?![\w])",
                        re.MULTILINE)


def test_no_file_imports_jax():
    files = sorted((ROOT / "svgf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if "import jax" in f.read_text() or "from jax" in f.read_text()]
    assert offenders == []


def test_no_file_imports_svgf_tpu():
    files = sorted((ROOT / "svgf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}" for f in files
                 for m in _FORBIDDEN.finditer(f.read_text())]
    assert offenders == []
    # the pattern sees the imports it is meant to see, and not the port's own
    for line, bad in (("from svgf_tpu.config import X", True), ("import svgf_tpu", True),
                      ("    import svgf_tpu.accel.bvh as b", True), ("import jax.numpy", True),
                      ("from svgf_tpu_torch.ops import x", False), ("import svgf_tpu_torch", False),
                      ("# see svgf_tpu.accel", False),
                      ("from bench import make_bench_inputs", True), ("import bench", True),
                      ("    from bench import timed  # noqa", True),
                      ("from scripts.measure_balance import main", True),
                      ("import scripts.profile_trace", True), ("from scripts import x", True),
                      ("from svgf_tpu_torch.scripts import timing", False),
                      ("from svgf_tpu_torch.scripts.profile_filter import x", False),
                      ("import benchmark_tools", False), ("# see bench.py:70", False)):
        assert bool(_FORBIDDEN.search(line)) is bad, line
