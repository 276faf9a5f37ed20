"""The benchmark's files, found by name: ``<kind>/<name>.json`` for data
(configurations, mixes, prepared cells) and ``<kind>/<name>.py`` for code
(paths, generators, references, models, counts, metric readers)."""

import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


class CellError(RuntimeError):
    """A run that cannot give a result (no card, a missing file, JAX)."""


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.exists():
        raise CellError(f"no {kind} file {path.relative_to(ROOT.parent)}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, fallback: bool = False):
    """``<kind>/<name>.py`` as a module; with ``fallback``, else
    ``<kind>/<name before the first dot>.py``; None where neither exists."""
    cands = [name] + ([name.split(".")[0]] if fallback and "." in name else [])
    for cand in cands:
        path = ROOT / kind / f"{cand}.py"
        if path.exists():
            mod_name = f"portbench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', cand)}"
            if mod_name in sys.modules:
                return sys.modules[mod_name]
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod
            spec.loader.exec_module(mod)
            return mod
    return None
