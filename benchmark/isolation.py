"""The benchmark's isolation: nothing it runs loads JAX or the JAX package
``tti``, and the reference takes nothing of the program.

Module names are compared by their whole top-level name (the part before
the first dot): ``tti_torch`` is not ``tti``.

    python3 benchmark/isolation.py    # exits 1 and names what it found
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "tti"}
# What the reference may import besides itself: no program, tests or tools.
REFERENCE_MAY_IMPORT = {"__future__", "json", "math", "struct", "typing", "dataclasses",
                        "numpy", "torch", "benchmark"}


def imports_of(path: str) -> list[str]:
    """The modules a source file imports, as written (absolute names)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.append(node.module)
    return out


def sources() -> list[str]:
    return sorted(os.path.join(d, f) for d, _, files in os.walk(HERE) for f in files
                  if f.endswith(".py"))


def source_faults() -> list[str]:
    """Every import in the benchmark's sources of a forbidden module, and
    every import in the reference's sources outside what it may import or
    inside the benchmark but outside the reference."""
    faults = []
    ref_dir = os.path.join(HERE, "reference") + os.sep
    for path in sources():
        rel = os.path.relpath(path, ROOT)
        for name in imports_of(path):
            top = name.split(".")[0]
            if top in FORBIDDEN:
                faults.append(f"{rel} imports {name}")
            if path.startswith(ref_dir) and (
                    top not in REFERENCE_MAY_IMPORT
                    or (top == "benchmark" and not name.startswith("benchmark.reference"))):
                faults.append(f"{rel} (the reference) imports {name}")
    return faults


# The modules one run loads: the harness, the program it builds and the
# reference, imported in a fresh interpreter.
_PROBE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.harness, benchmark.system, benchmark.calibrate, benchmark.isolation
import benchmark.metrics, benchmark.trace
import tti_torch.parallel.runtime, tti_torch.calib.io, tti_torch.core.config
import tti_torch.model.checkpoint
import pkgutil, importlib
for pkg in ("benchmark.metrics", "benchmark.rooflines", "benchmark.scenes"):
    mod = importlib.import_module(pkg)
    for info in pkgutil.iter_modules(mod.__path__):
        importlib.import_module(pkg + "." + info.name)
print("\\n".join(sorted(sys.modules)))
"""


def runtime_faults() -> list[str]:
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT)], capture_output=True,
                         text=True, check=True, env={**os.environ, "USE_FLAX": "0"}).stdout
    return sorted(m for m in out.split() if m.split(".")[0] in FORBIDDEN)


def main() -> int:
    faults = source_faults() + [f"loaded: {m}" for m in runtime_faults()]
    for f in faults:
        print(f, file=sys.stderr)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
