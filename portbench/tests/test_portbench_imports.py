"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either: top-level names of every
import, compared whole (``libiqo_tpu_torch`` begins with ``libiqo_tpu``)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "libiqo_tpu"}
PROGRAM = {"libiqo_tpu_torch"}
MODULES = sorted(PKG.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_walk_sees_every_module():
    assert len(MODULES) > 20
    assert PKG / "run.py" in MODULES and PKG / "reference" / "yuv420.py" in MODULES
    assert "libiqo_tpu_torch" in top_level_imports(PKG / "run.py")


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | PROGRAM | {"torch"})


def test_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import libiqo_tpu_torch.yuv\nfrom libiqo_tpu.api import x\nimport jaxlib\n")
    assert top_level_imports(f) & FORBIDDEN == {"libiqo_tpu", "jaxlib"}
