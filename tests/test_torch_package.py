"""The port stands alone: no module of realise_tpu_torch, and not
chip_smoke.py, imports JAX, Orbax or the JAX package."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "orbax", "realise_tpu"}
FILES = sorted((ROOT / "realise_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_found():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom realise_tpu.config import config_for\n"
                     "from realise_tpu_torch.config import config_for\n"
                     "def f():\n    import jax.numpy as jnp\n")
    assert set(_imported_roots(probe)) & FORBIDDEN == {"realise_tpu", "jax"}
