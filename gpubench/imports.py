"""The check that the benchmark's process holds none of the JAX side.

Module names are compared by their top-level name (the part before the
first dot) whole: ``mpgadget_tpu_torch`` is the port and is allowed,
``mpgadget_tpu`` is the JAX package and is not.
"""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mpgadget_tpu"})
PROGRAM = "mpgadget_tpu_torch"


def top_names(modules=None):
    return {name.split(".", 1)[0]
            for name in (sys.modules if modules is None else modules)}


def forbidden_loaded(modules=None):
    """The forbidden top-level names among the loaded modules."""
    return sorted(top_names(modules) & FORBIDDEN)


def reference_imports(package_dir):
    """Top-level names that the reference's sources import, read from
    their syntax trees (the reference may import neither the program nor
    the JAX side)."""
    import ast
    import pathlib
    names = set()
    for path in sorted(pathlib.Path(package_dir).glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names.update(a.name.split(".", 1)[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add(node.module.split(".", 1)[0])
    return names
