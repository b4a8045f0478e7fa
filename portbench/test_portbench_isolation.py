"""Nothing of the benchmark imports jax or the JAX package ``repro``,
checked by whole top-level module name; the reference imports nothing
of the program either."""
import ast
from pathlib import Path

import pytest

from portbench import isolation

ROOT = Path(__file__).resolve().parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_top_level_names_are_compared_whole():
    assert isolation.loaded(["repro_torch", "repro_torch.models.model", "torch"]) == []
    assert isolation.loaded(["repro.models.model", "repro_torch"]) == ["repro"]
    assert isolation.loaded(["jax.numpy", "jaxlib.xla_client", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]
    assert isolation.loaded(["jaxtyping", "flaxen", "reprox"]) == []


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")), ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = isolation.top_level(_imports(path))
    assert not tops & set(isolation.FORBIDDEN), f"{path.name} imports {tops}"


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = isolation.top_level(_imports(path))
    assert "repro_torch" not in tops
    assert tops <= {"__future__", "importlib", "types", "typing", "math", "torch", "portbench"}
