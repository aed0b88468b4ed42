"""No file of the benchmark imports JAX or the JAX package, and the
yardstick (the generator and the plain reference) imports nothing of the
program: each import's top-level name is compared whole, since the
program's name, paffy_tpu_torch, begins with the JAX package's."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "paffy_tpu"}
YARDSTICK = ("synth.py", "reference.py", "devtrace.py")


def files():
    for d, _, names in os.walk(BENCH):
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.join(d, n)


def top_level_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", list(files()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    mods = set(top_level_imports(os.path.join(BENCH, name)))
    assert not mods & (FORBIDDEN | {"paffy_tpu_torch", "chip_smoke", "torch"})


def test_prefix_is_not_a_match():
    # paffy_tpu_torch is allowed where paffy_tpu is not: whole names
    assert "paffy_tpu_torch".split(".")[0] not in FORBIDDEN
