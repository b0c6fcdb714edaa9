"""PyTorch port, the seams between layers, read from the sources with ``ast``:
the generic cascade names no backbone's modules, one function of
``models/ee/`` tells the backbone families apart, and the measurement
utility imports no kernel module. This file imports neither JAX nor the
port."""

import ast
import pathlib

import pytest

PORT = pathlib.Path(__file__).resolve().parents[1] / "multi_modal_early_exit_tpu_torch"


def imported_modules(path: pathlib.Path):
    """Every module an import anywhere in ``path`` names (``from a import
    b`` gives ``a`` and ``a.b``)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def functions_naming(path: pathlib.Path, name: str):
    """The enclosing top-level definition (or ``<module>``) of each
    reference to ``name``: a name, an attribute or an imported name, not
    text in a docstring."""
    for top in ast.parse(path.read_text()).body:
        where = top.name if isinstance(top, (ast.FunctionDef, ast.ClassDef)) else "<module>"
        for node in ast.walk(top):
            if ((isinstance(node, ast.Name) and node.id == name)
                    or (isinstance(node, ast.Attribute) and node.attr == name)
                    or (isinstance(node, ast.alias) and name in (node.name, node.asname))):
                yield f"{path.name}::{where}"


def seam_cascade():
    imports = set(imported_modules(PORT / "models/ee/cascade.py"))
    return sorted(m for m in imports if m.startswith((
        "multi_modal_early_exit_tpu_torch.models.layoutlmv3.modeling",
        "multi_modal_early_exit_tpu_torch.models.moonlight")))


def seam_backbone_choice():
    found = {f for path in sorted((PORT / "models/ee").glob("*.py"))
             for f in functions_naming(path, "MoonlightConfig")}
    return [] if found == {"model.py::backbone_stages"} else sorted(found)


def seam_profiling():
    return sorted(m for m in imported_modules(PORT / "utils/profiling.py")
                  if m.startswith("multi_modal_early_exit_tpu_torch.ops"))


@pytest.mark.parametrize("seam", [seam_cascade, seam_backbone_choice, seam_profiling],
                         ids=["cascade-imports-no-backbone", "one-function-picks-the-backbone",
                              "profiling-imports-no-ops"])
def test_seam(seam):
    """Each seam lists what crosses it where it should not: nothing."""
    assert seam() == []
