"""What a run may not load: the JAX package the program was ported from, and
JAX itself. Module names are compared by their top-level name (the part
before the first dot) as a whole word, so ``vrdd_tpu_torch`` is not
``vrdd_tpu``."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "vrdd_tpu")
#: what the plain reference may not import besides: the program under test
PROGRAM = "vrdd_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """Top-level names of loaded modules that no run may hold."""
    names = sys.modules if modules is None else modules
    return sorted({top(n) for n in names if top(n) in FORBIDDEN})


def imported_names(path: Path) -> set:
    """Every module a Python source imports, anywhere in it."""
    found = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module or "")
    return found


def reference_violations(reference_dir: Path) -> list:
    """``(file, module)`` for each import under the reference directory of
    the program or of a forbidden package."""
    bad = []
    for src in sorted(reference_dir.rglob("*.py")):
        for name in sorted(imported_names(src)):
            if top(name) in FORBIDDEN + (PROGRAM,):
                bad.append((str(src), name))
    return bad
