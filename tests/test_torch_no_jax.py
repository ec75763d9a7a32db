"""The PyTorch port stands alone: it never imports jax or vo_tpu, shares the
reference's config, and chip_smoke.py refuses to run without a GPU."""

import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

SLICE_MODULES = [
    "vo_tpu_torch",
    "vo_tpu_torch.geom",
    "vo_tpu_torch.geom.points",
    "vo_tpu_torch.geom.lie",
    "vo_tpu_torch.geom.camera",
    "vo_tpu_torch.ops.image",
    "vo_tpu_torch.ops.harris",
    "vo_tpu_torch.ops.kernels",
    "vo_tpu_torch.ops._build",
    "vo_tpu_torch.ops.klt",
    "vo_tpu_torch.ops.ransac",
    "vo_tpu_torch.ops.epipolar",
    "vo_tpu_torch.ops.triangulate",
    "vo_tpu_torch.ops.linalg",
    "vo_tpu_torch.ops.pnp",
    "vo_tpu_torch.models.feature_table",
    "vo_tpu_torch.models.ba",
    "vo_tpu_torch.models.pipeline",
    "vo_tpu_torch.data.synthetic",
    "vo_tpu_torch.data.evaluate",
    "vo_tpu_torch.utils.config",
    "chip_smoke",
]


def _run(code: str, cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_slice_imports_leave_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'vo_tpu' or m.startswith('vo_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = _run(code, ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


def test_port_sources_never_import_jax_or_vo_tpu():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|vo_tpu)(\.|\s|$)", re.MULTILINE)
    files = sorted((ROOT / "vo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_config_is_the_reference_config():
    from vo_tpu.utils.config import VOConfig as JaxConfig

    from vo_tpu_torch.utils.config import VOConfig

    assert dataclasses.asdict(VOConfig()) == dataclasses.asdict(JaxConfig())
    assert dataclasses.asdict(VOConfig(capacity=384)) == dataclasses.asdict(
        JaxConfig(capacity=384))


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env=env,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("tracker", ["harris", "sift"])
def test_unported_trackers_raise(tracker):
    import torch

    from vo_tpu_torch.models.pipeline import bootstrap
    from vo_tpu_torch.utils.config import VOConfig

    img = torch.zeros((64, 64))
    with pytest.raises(NotImplementedError, match="item 11"):
        bootstrap(img, img, torch.eye(3), VOConfig(tracker=tracker), torch.Generator())
