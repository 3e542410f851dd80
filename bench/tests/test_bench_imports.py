"""What runs on the card imports neither JAX nor the JAX package
(``repro``), compared by whole top-level names (``repro_torch`` begins
with ``repro``), and the reference imports nothing of the program."""
import ast

import pytest

from bench.tests.smoke import BENCH

FOREIGN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_or_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FOREIGN, f"{path} imports {tops & FOREIGN}"


def test_the_check_is_by_whole_names():
    assert {"repro_torch"} & FOREIGN == set()
    assert {m.split(".")[0] for m in ["repro.models", "jax.numpy"]} \
        <= FOREIGN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "math", "torch"}, tops
