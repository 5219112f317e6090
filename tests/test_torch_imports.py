"""The PyTorch port imports no JAX and nothing of the JAX package: every
module under aid_tpu_torch/, and chip_smoke.py, is scanned by AST."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "aid_tpu")
SOURCES = sorted((ROOT / "aid_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_sources_exist():
    assert len(SOURCES) > 10 and all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_aid_tpu_import(path):
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("name,bad", [("jax.numpy", True), ("aid_tpu.ops", True),
                                      ("aid_tpu_torch.ops", False), ("torch", False),
                                      ("flax.linen", True)])
def test_scan_classifies_names(name, bad):
    assert _forbidden(name) is bad
