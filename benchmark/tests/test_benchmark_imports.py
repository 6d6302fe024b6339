"""No module under benchmark/ imports JAX, the JAX package or chip_smoke,
by top-level name compared whole (``realise_tpu_torch`` starts with
``realise_tpu`` and is the port); the reference imports nothing of the port;
the load generator only the standard library."""

import ast
import os
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "realise_tpu", "chip_smoke",
             "tools"}
BENCH = os.path.join(ROOT, "benchmark")


def imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(imports(p)) & FORBIDDEN) for p in sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_the_top_level_name_is_compared_whole():
    assert "realise_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    from benchmark.harness import forbidden_loaded

    assert "realise_tpu" not in forbidden_loaded() or "realise_tpu" in {
        m.split(".", 1)[0] for m in sys.modules}


def test_reference_imports_nothing_of_the_port():
    for p in sources("reference"):
        assert "realise_tpu_torch" not in set(imports(p)), p


def test_loadgen_is_standard_library():
    found = set(imports(os.path.join(BENCH, "loadgen.py")))
    assert found <= set(sys.stdlib_module_names)
