"""Nothing under h100bench/ imports JAX or the JAX package, and the
reference imports nothing of the port: module names compared by their
top-level name, whole (the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast

from h100bench.tests import tiny

JAX = {"jax", "jaxlib", "flax", "multi_modal_early_exit_tpu"}
PORT = "multi_modal_early_exit_tpu_torch"


def imported(path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(tiny.HERE.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not imported(path) & JAX, path


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((tiny.HERE / "reference").rglob("*.py"))
    assert files
    for path in files:
        tops = imported(path)
        assert PORT not in tops and not tops & JAX, path
        assert tops <= {"h100bench", "torch", "math", "contextlib", "typing", "statistics",
                        "__future__", "numpy"}, (path, tops)


def test_the_port_is_not_the_jax_package():
    assert PORT.split(".")[0] not in JAX and PORT.startswith("multi_modal_early_exit_tpu")
