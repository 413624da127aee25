"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the port (top-level names compared
whole: the port's name begins with the JAX package's)."""

import ast
import os

import pytest

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "xna_basecaller_tpu"}
PORT = "xna_basecaller_tpu_torch"


def modules():
    for dirpath, _, files in os.walk(spec.HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path: str) -> set[str]:
    """The top-level names of every module ``path`` imports."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def reference_closure() -> set[str]:
    """The files of ``portbench`` that the reference imports, itself
    included, followed through ``portbench.*`` imports."""
    todo = [p for p in modules()
            if os.sep + "reference" + os.sep in p]
    seen = set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.startswith("portbench"):
                parts = node.module.split(".")[1:]
                base = os.path.join(spec.HERE, *parts)
                cands = [base + ".py"] + [os.path.join(base, a.name + ".py")
                                          for a in node.names]
                todo += [c for c in cands if os.path.exists(c)]
    return seen


@pytest.mark.parametrize("path", list(modules()),
                         ids=lambda p: os.path.relpath(p, spec.ROOT))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


def test_the_walk_sees_the_port_and_would_see_jax():
    kinds = os.path.join(spec.HERE, "kinds", "basecall.py")
    assert PORT in imported(kinds)
    assert PORT.split("_torch")[0] != PORT    # compared whole, not prefix


def test_the_reference_imports_nothing_of_the_port():
    files = reference_closure()
    assert os.path.join(spec.HERE, "weights.py") in files
    for path in files:
        assert PORT not in imported(path), path
