"""What the benchmark may import and read: nothing of JAX or the JAX
package anywhere under portbench/ (top-level module names compared whole),
nothing of the program in the reference, and none of the JAX-era
benchmark files."""

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)
JAX_SIDE = {"jax", "jaxlib", "flax", "svgf_tpu"}


def imported(path: Path) -> set:
    """Top-level names of every module `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_side_imports(path):
    assert not imported(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "svgf_tpu_torch" not in imported(path)
    assert imported(path) <= {"__future__", "math", "typing", "numpy", "torch", "portbench"}
    assert all(m.startswith("portbench.reference") for m in _portbench_modules(path))


def _portbench_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("portbench"):
            yield node.module


def test_top_level_names_compared_whole():
    # the port's own name begins with the JAX package's, and is allowed
    assert "svgf_tpu_torch".split(".")[0] not in JAX_SIDE


@pytest.mark.parametrize("path", [p for p in FILES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(PB)))
def test_reads_none_of_the_jax_era_benchmark(path):
    text = path.read_text()
    for name in ("bench" + ".py", "scripts" + "/", "BENCH" + "_r0", "BASELINE" + ".json",
                 "chip" + "_smoke"):
        assert name not in text, name
