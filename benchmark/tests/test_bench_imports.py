"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "starkpack_winterfell_tpu"}
PROGRAM = "starkpack_winterfell_tpu_torch"


def sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported_tops(path):
    """Top-level names of the absolute imports of a file."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(sources(BENCH)), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources(os.path.join(BENCH, "reference"))),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in imported_tops(path)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.verifier, benchmark.reference.airs; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    tops = set(eval(out))
    assert PROGRAM not in tops and not tops & FORBIDDEN


def test_the_top_level_check_compares_names_whole():
    from benchmark.harness import FORBIDDEN as HARNESS_FORBIDDEN

    assert PROGRAM.split(".")[0] not in HARNESS_FORBIDDEN
    assert "starkpack_winterfell_tpu" in HARNESS_FORBIDDEN


def test_a_process_holding_jax_is_refused(monkeypatch):
    import types

    from benchmark.harness import forbidden_modules

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, PROGRAM + ".anything", types.ModuleType("x"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert forbidden_modules() == ["jax"]
