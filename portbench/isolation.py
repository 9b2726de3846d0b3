"""The check that the benchmark's process holds neither JAX nor the JAX
package, and that the plain reference imports nothing of the program.
Module names are compared by their whole top-level name (the part before
the first dot): `articulation3d_tpu_torch` is not `articulation3d_tpu`."""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "articulation3d_tpu")
PROGRAM = "articulation3d_tpu_torch"
REFERENCE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reference")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among loaded modules (default:
    `sys.modules`)."""
    names = list(sys.modules) if names is None else names
    return sorted({top_level(n) for n in names} & set(FORBIDDEN))


def imported_names(path: str) -> List[str]:
    """Absolute module names a Python file imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def reference_violations(directory: str = REFERENCE_DIR) -> List[str]:
    """"file: module" for each import of the program or a forbidden module
    under the reference's directory."""
    bad = []
    for root, _, files in os.walk(directory):
        for fn in sorted(files):
            if fn.endswith(".py"):
                path = os.path.join(root, fn)
                for name in imported_names(path):
                    if top_level(name) in FORBIDDEN + (PROGRAM,):
                        bad.append(f"{os.path.relpath(path, directory)}: {name}")
    return bad
