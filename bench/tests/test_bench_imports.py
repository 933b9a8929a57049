"""No file of the benchmark imports JAX or the JAX package, and its
reference imports nothing of the port: whole top-level names compared, as
``repro_torch`` begins with ``repro``."""
import ast

import pytest
from conftest import ROOT

FILES = sorted((ROOT / "bench").rglob("*.py"))
REFERENCE = [p for p in FILES if "reference" in p.relative_to(ROOT).parts]
NOWHERE = {"jax", "jaxlib", "flax", "repro"}


def imported_roots(source: str) -> set:
    """The top-level name of every absolute import in ``source``."""
    roots = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not imported_roots(path.read_text()) & NOWHERE


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_the_reference_imports_nothing_of_the_port(path):
    roots = imported_roots(path.read_text())
    assert not roots & (NOWHERE | {"repro_torch", "bench"}), roots


def test_names_compare_whole():
    src = "import repro_torch.service\nfrom repro_torch import x\n"
    assert imported_roots(src) == {"repro_torch"}
    assert not imported_roots(src) & NOWHERE
    assert imported_roots("import repro.core as c\nfrom jax import numpy\n") \
        == {"repro", "jax"}


def test_the_walk_covers_the_harness_and_the_reference():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"bench/run.py", "bench/harness.py", "bench/check.py",
            "bench/reference/pdes.py", "bench/metrics/b1_roofline.py"} \
        <= names
    assert "bench/reference/pdes.py" in {p.relative_to(ROOT).as_posix()
                                         for p in REFERENCE}
