"""Nothing of the benchmark imports JAX or the JAX package, and the
yardstick (the reference, each backend's reference and work counts, the
check, work, trace, traffic and metrics) imports nothing of the program
(an AST scan, module names compared whole by their top-level part)."""

import ast
import glob
import os
import re

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.relpath(p, HERE) for p in glob.glob(os.path.join(HERE, "**", "*.py"),
                                                           recursive=True))
FORBIDDEN = {"jax", "jaxlib", "flax", "cell_image_analysis_tpu"}
# a backend's reference and work counts; its system.py imports the port
BACKEND_YARDSTICK = re.compile(r"backends/[^/]+/(reference|counts)\.py")


def _imports(path):
    tree = ast.parse(open(os.path.join(HERE, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", FILES)
def test_no_jax(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", [f for f in FILES if f.startswith("reference")
                                  or f in ("check.py", "work.py", "trace.py",
                                           "backends/__init__.py")
                                  or f.startswith("traffic") or f.startswith("metrics")
                                  or BACKEND_YARDSTICK.fullmatch(f)])
def test_the_yardstick_imports_nothing_of_the_program(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert "cell_image_analysis_tpu_torch" not in tops
