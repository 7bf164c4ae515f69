"""The import guard: walks the AST of every module of portbench/ and
compares each import's top-level name whole. Nothing imports jax,
jaxlib, flax or vistracker_tpu (the JAX package; the port's name,
vistracker_tpu_torch, begins with it, hence whole names), and the
yardstick (the reference, the traffic generators, the counters, the
weights and the metric readers) imports nothing of the port either."""
from __future__ import annotations

import ast
import os

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "vistracker_tpu"}
YARDSTICK = ("reference", "traffic", "metrics", "counters.py", "weights.py")


def modules():
    for root, _, files in os.walk(harness.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def top_names(path: str) -> set:
    """Top-level names of the absolute imports of a module, whole."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


PATHS = sorted(modules())


@pytest.mark.parametrize("path", PATHS,
                         ids=[os.path.relpath(p, harness.BENCH)
                              for p in PATHS])
def test_no_jax_anywhere(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in PATHS if os.path.relpath(
    p, harness.BENCH).split(os.sep)[0] in YARDSTICK])
def test_yardstick_imports_nothing_of_the_port(path):
    assert "vistracker_tpu_torch" not in top_names(path)


def test_guard_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import vistracker_tpu_torch.ops\nfrom jax import numpy\n"
                 "import jaxtyping\n")
    assert top_names(str(f)) == {"vistracker_tpu_torch", "jax", "jaxtyping"}
    assert top_names(str(f)) & FORBIDDEN == {"jax"}


def test_forbidden_modules_reads_sys_modules():
    import sys
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
