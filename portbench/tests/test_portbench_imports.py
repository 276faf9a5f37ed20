"""What the benchmark's modules import, by whole top-level module name (the
part before the first dot): the port's name begins with the JAX package's,
so a prefix would match both."""

import ast
import subprocess
import sys

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "audiotoken_tpu"}
PROGRAM = "audiotoken_tpu_torch"


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in harness.ROOT.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((harness.ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_does_not_import_the_program(path):
    assert PROGRAM not in _top_level_imports(path)


def test_only_the_models_import_the_program():
    users = {p.relative_to(harness.ROOT).parts[0] for p in SOURCES
             if PROGRAM in _top_level_imports(p) and p.parent.name != "tests"}
    assert users == {"models"}


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "audiotoken_tpu_torch_fake", sys)
    for name in FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_references_load_without_the_program():
    code = ("import sys; sys.path.insert(0, %r); from portbench import harness\n"
            "for n in ('encodec_24khz', 'semantic_m_w2vbert2'): harness.load_module('reference', n)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'audiotoken_tpu_torch', "
            "'audiotoken_tpu', 'jax'}))") % str(harness.ROOT.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
