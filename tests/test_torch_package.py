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


@pytest.mark.parametrize("module", [
    "ops/kernels/bert_block_train.py", "training/optim.py",
    "training/trainer.py", "data/dataset.py", "text/glyphs.py",
    "cli/common.py", "cli/train.py", "cli/test.py", "eval/metric_core.py",
    "eval/remove_de.py", "eval/sig_test.py", "cli/serve.py", "data/native.py",
    "models/torch_import.py", "training/checkpoint.py", "serving.py",
    "parallel/__init__.py", "parallel/distributed.py", "parallel/mesh.py",
    "parallel/tensor.py"])
def test_scan_covers_the_training_modules(module):
    assert ROOT / "realise_tpu_torch" / module in FILES


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


def test_train_build_hash_covers_the_hopper_gemm_header():
    """The train kernels' library is rebuilt when any header it includes
    changes: its source list (which the build hash reads) holds the Hopper
    GEMM header and, through it, the shared one."""
    from realise_tpu_torch.ops.kernels import _build

    names = [p.name for p in _build.sources("bert_block_train")]
    assert names[0] == "bert_block_train.cu"
    assert {"gemm_sm90.cuh", "bert_block_common.cuh"} <= set(names)
    assert len(names) == len(set(names)) == 3


def test_serving_build_hash_covers_the_hopper_gemm_header():
    """The serving kernels' FFN products run on the Hopper GEMM too: the
    serving library's source list (which its build hash reads) holds that
    header and the shared one, each once."""
    from realise_tpu_torch.ops.kernels import _build

    names = [p.name for p in _build.sources("bert_block")]
    assert names[0] == "bert_block.cu"
    assert sorted(names[1:]) == ["bert_block_common.cuh", "gemm_sm90.cuh"]


def test_build_hash_follows_an_included_header(tmp_path, monkeypatch):
    """Editing a header that a source includes only through another header
    changes that source's build hash (and so rebuilds its library)."""
    from realise_tpu_torch.ops.kernels import _build

    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int x;\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build._paths("k")[3]
    (tmp_path / "b.cuh").write_text("int y;\n")
    assert _build._paths("k")[3] != before
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]


def test_featurizer_builds_from_the_ports_own_source():
    """The native featurizer's library is built from the port's copy of
    featurizer.cpp with the host compiler's flags, into the port's build
    directory: nothing of the JAX package's csrc/ or its make build."""
    from realise_tpu_torch.ops.kernels import _build

    src, lib, _, digest = _build._paths("realise_featurizer")
    assert src == ROOT / "realise_tpu_torch" / "csrc" / "featurizer.cpp"
    assert lib == ROOT / "build" / "realise_tpu_torch" / "librealise_featurizer.so"
    assert [p.name for p in _build.sources("realise_featurizer")] == ["featurizer.cpp"]
    cmd = _build._command("realise_featurizer", src, lib)
    assert cmd[1:] == [*_build.CXX_FLAGS, "-o", str(lib), str(src)]
    assert digest != _build._paths("bert_block")[3]
