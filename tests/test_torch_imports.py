"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and not the port's examples import ``jax`` or the JAX
package ``repro``."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(source: str) -> set[str]:
    """Top-level package of every absolute import in ``source``."""
    roots = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = _imported_roots(path.read_text()) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_walk_covers_the_port_and_both_import_forms():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"src/repro_torch/kernels/pdes_multistep.py",
            "src/repro_torch/service/api.py",
            "src/repro_torch/core/distributed.py",
            "src/repro_torch/core/mesh.py",
            "src/repro_torch/distributed/delta_sync.py",
            "src/repro_torch/configs/base.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/models/flash.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/serve/engine.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/models/hybrid.py",
            "src/repro_torch/models/encdec.py",
            "examples/serve_lm_torch.py",
            "examples/quickstart_torch.py",
            "examples/pdes_scaling_study_torch.py",
            "examples/paper_figures_torch.py",
            "chip_smoke.py"} <= names
    probe = ("import jax.numpy as jnp\n"
             "def f():\n    from repro.core import horizon\n"
             "from . import sibling\nfrom repro_torch import bridge\n")
    assert _imported_roots(probe) == {"jax", "repro", "repro_torch"}
