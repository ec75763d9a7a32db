"""No run may load JAX or the JAX package: the check at the end of every
run compares whole top-level names, and the benchmark's sources import
neither, nor read the JAX package's recorded benchmarks. The reference
imports nothing of the program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from vobench import registry
from vobench.run import forbidden_modules

SOURCES = sorted(p for p in registry.ROOT.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("loaded, found", [
    (["vo_tpu_torch", "vo_tpu_torch.models.pipeline", "vobench.run", "torch"], []),
    (["vo_tpu_torch", "vo_tpu"], ["vo_tpu"]),
    (["vo_tpu.models.pipeline"], ["vo_tpu.models.pipeline"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client"]),
    (["jaxtyping", "vo_tpu_tools", "flaxen"], []),
])
def test_the_check_compares_whole_top_level_names(loaded, found):
    assert forbidden_modules(loaded) == found


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return {n.split(".", 1)[0] for n in names}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "vo_tpu"}


@pytest.mark.parametrize("name", ["reference.py", "scene.py", "evaluate.py", "roofline.py"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert "vo_tpu_torch" not in _imports(registry.ROOT / name)


def test_no_source_reads_the_jax_packages_records():
    for path in SOURCES + sorted(registry.ROOT.rglob("*.json")):
        text = path.read_text()
        for record in ("BASELINE.json", "BENCH_r", "MULTICHIP_r", "headline_expected"):
            assert record not in text, (path, record)
