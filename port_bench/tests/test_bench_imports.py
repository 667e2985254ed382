"""Nothing under port_bench imports JAX, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from port_bench import checks

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(HERE.rglob("*.py"))


def _imported(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value))
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not _imported(path) & set(checks.FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imported(path) <= {"__future__", "numpy", "torch"}


def test_forbidden_names_are_compared_whole():
    held = ["pytorchwavenetvocoder_tpu_torch", "pytorchwavenetvocoder_tpu_torch.ops",
            "jaxtyping", "flaxen", "numpy"]
    assert checks.forbidden_modules(held) == []
    assert checks.forbidden_modules(held + ["jax.numpy"]) == ["jax"]
    assert checks.forbidden_modules(
        ["pytorchwavenetvocoder_tpu.models"]) == ["pytorchwavenetvocoder_tpu"]
