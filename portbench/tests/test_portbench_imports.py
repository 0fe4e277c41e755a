"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program either.  Top-level module names
are compared whole: ``repro_torch`` is the program, ``repro`` the JAX
package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(ROOT.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "numpy", "struct", "zlib"}


def test_the_scan_sees_a_planted_import(tmp_path):
    planted = tmp_path / "planted.py"
    planted.write_text("import jax.numpy as jnp\nfrom repro.core import engine\n"
                       "import repro_torch\nfrom . import sibling\n")
    assert top_level_imports(planted) == {"jax", "repro", "repro_torch"}
