"""The port imports neither JAX nor the JAX package, and imports no package
that the H100 machine lacks at a module's top level.

A static check over the sources: this environment imports JAX into every
interpreter (the suite's conftest does), so ``sys.modules`` cannot tell.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "audiotoken_tpu"}
#: absent on the card: imported only inside the function that needs them
NOT_AT_TOP = {"transformers", "safetensors", "joblib", "sklearn", "optax", "huggingface_hub",
              "matplotlib"}
SOURCES = (sorted((ROOT / "audiotoken_tpu_torch").rglob("*.py"))
           + sorted((ROOT / "scripts").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "examples").glob("*_torch.py")))


def _imported_modules(path: Path):
    """Module names imported by ``import``/``from`` statements, and string
    arguments of ``__import__``/``importlib.import_module`` calls."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("__import__", "import_module"):
                yield from (a.value for a in node.args
                            if isinstance(a, ast.Constant) and isinstance(a.value, str))


def _top_level_modules(path: Path):
    """Modules imported by statements that run when the module is imported:
    those outside every function body (a class body, ``if`` and ``try``
    blocks at module level run too)."""
    def walk(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                yield node.module
            else:
                yield from walk(ast.iter_child_nodes(node))

    yield from walk(ast.parse(path.read_text(), filename=str(path)).body)


def test_sources_found():
    assert len(SOURCES) > 10


@pytest.mark.parametrize("module", [
    "decoders.py", "nn/gpt.py", "nn/bark_fine.py", "ops/decode_attention.py",
    "ops/decode_step.py", "ops/flash_attention.py", "nn/seanet.py", "nn/rvq.py",
])
def test_decode_modules_are_checked(module):
    assert ROOT / "audiotoken_tpu_torch" / module in SOURCES


@pytest.mark.parametrize("path", [
    "audiotoken_tpu_torch/nn/hubert.py", "audiotoken_tpu_torch/ops/attn_ablation.py",
    "audiotoken_tpu_torch/ops/attention.py", "audiotoken_tpu_torch/runtime/profiling.py",
    "audiotoken_tpu_torch/encoders.py", "scripts/profile_attn_micro_torch.py",
    "scripts/profile_decode_torch.py", "audiotoken_tpu_torch/io/dataset.py",
    "audiotoken_tpu_torch/io/sink.py", "audiotoken_tpu_torch/io/_native.py",
    "audiotoken_tpu_torch/runtime/executor.py", "audiotoken_tpu_torch/parallel/hosts.py",
    "audiotoken_tpu_torch/cli.py", "audiotoken_tpu_torch/utils.py",
    "audiotoken_tpu_torch/metrics.py", "audiotoken_tpu_torch/convert/encodec.py",
    "audiotoken_tpu_torch/convert/safetensors.py", "audiotoken_tpu_torch/convert/manifest.py",
    "audiotoken_tpu_torch/convert/quantizers.py", "audiotoken_tpu_torch/convert/checkpoints.py",
    "audiotoken_tpu_torch/train/vq_train.py",
    "audiotoken_tpu_torch/train/gpt_train.py", "audiotoken_tpu_torch/train/cluster_diagnostics.py",
    "scripts/convert_real_torch.py", "scripts/precision_ladder_torch.py",
    "scripts/bisect_precision_torch.py", "audiotoken_tpu_torch/parallel/mesh.py",
    "audiotoken_tpu_torch/parallel/collectives.py", "audiotoken_tpu_torch/parallel/shard.py",
    "audiotoken_tpu_torch/parallel/launch.py", "audiotoken_tpu_torch/parallel/dryrun.py",
    "scripts/profile_mesh_torch.py", "scripts/fullsize_dryrun_torch.py",
    "scripts/profile_ar_step_torch.py", "scripts/profile_fine_stages_torch.py",
    "scripts/profile_conformer_stages_torch.py", "examples/usage_torch.py",
])
def test_new_modules_are_checked(path):
    """The semantic_s, profiling and corpus modules, and the scripts that
    chip_smoke.py imports or that run on the card."""
    assert ROOT / path in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_top_level_import_the_card_lacks(path):
    bad = [m for m in _top_level_modules(path) if m.split(".")[0] in NOT_AT_TOP]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at top level"


def test_top_level_checker_skips_function_bodies(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import os\ntry:\n    import joblib\nexcept ImportError:\n    pass\n"
        "def f():\n    import transformers\n    from safetensors.numpy import load_file\n"
        "class C:\n    import optax\n    def g(self):\n        import matplotlib\n"
    )
    assert sorted(_top_level_modules(src)) == ["joblib", "optax", "os"]


def test_checker_sees_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import jax.numpy as jnp\nfrom audiotoken_tpu.api import AudioToken\n"
        "import importlib\nimportlib.import_module('jaxlib')\n"
        "from audiotoken_tpu_torch import api\n"
    )
    mods = [m.split(".")[0] for m in _imported_modules(src)]
    assert [m for m in mods if m in FORBIDDEN] == ["jax", "audiotoken_tpu", "jaxlib"]
