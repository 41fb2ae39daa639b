"""What no run may load, and what the reference may not import: JAX and
the JAX package (``lancedb_tpu``), compared by whole top-level names, so
``lancedb_tpu_torch`` passes; the reference also imports nothing of the port."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lancedb_tpu"})
PORT = "lancedb_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if top(n) in FORBIDDEN})


def reference_imports(folder: Path) -> list[str]:
    """``file: module`` for each import under ``folder`` of JAX, the JAX
    package or the port."""
    bad = []
    for path in sorted(Path(folder).rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                mods = [node.module]
            else:
                continue
            bad += [f"{path.name}: {m}" for m in mods if top(m) in FORBIDDEN | {PORT}]
    return bad
