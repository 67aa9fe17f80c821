"""The port runs without JAX: the machine with the card has none."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_RENDER_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
import numpy as np
from svgf_tpu_torch.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_tpu_torch.render.pipeline import Renderer
from svgf_tpu_torch.scenes.cornell import cornell_box
cfg = RenderConfig(width=16, height=16, svgf=SVGFConfig(spatial_filter_steps=2),
                   tracing=TracingConfig(bounces=2))
out = Renderer(cornell_box(), cfg).step()
final = out.final.numpy()
assert final.shape == (16, 16, 3) and np.isfinite(final).all()
assert final.min() >= 0.0 and final.max() <= 1.0
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib")) for m in sys.modules
               if sys.modules[m] is not None)
print("rendered without jax")
"""


def test_renders_a_frame_without_jax():
    proc = subprocess.run([sys.executable, "-c", _RENDER_WITHOUT_JAX], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "rendered without jax" in proc.stdout


def test_no_file_imports_jax():
    files = sorted((ROOT / "svgf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if "import jax" in f.read_text() or "from jax" in f.read_text()]
    assert offenders == []
