"""The PyTorch port stands alone: it never imports, opens or executes
anything of jax or vo_tpu; its own copies of the reference's numpy modules
(config, city generators, evaluator, the lighting model, the render digest,
the loaders' parsing) are held equal to the reference here; and
chip_smoke.py refuses to run without a GPU."""

import ast
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
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
    "vo_tpu_torch.ops.descriptors",
    "vo_tpu_torch.ops.sift",
    "vo_tpu_torch.models.feature_table",
    "vo_tpu_torch.models.ba",
    "vo_tpu_torch.models.pipeline",
    "vo_tpu_torch.models.pose_graph",
    "vo_tpu_torch.models.keyframe_db",
    "vo_tpu_torch.models.backend",
    "vo_tpu_torch.data",
    "vo_tpu_torch.data.city",
    "vo_tpu_torch.data.synthetic",
    "vo_tpu_torch.data.evaluate",
    "vo_tpu_torch.data.png",
    "vo_tpu_torch.data.native_loader",
    "vo_tpu_torch.data.loaders",
    "vo_tpu_torch.utils.config",
    "vo_tpu_torch.utils.checkpoint",
    "vo_tpu_torch.utils.viz",
    "vo_tpu_torch.parallel",
    "vo_tpu_torch.parallel.multiseq",
    "vo_tpu_torch.parallel.mesh",
    "vo_tpu_torch.parallel.dist_gn",
    "vo_tpu_torch.parallel.dist_ba",
    "vo_tpu_torch.parallel.dist_pg",
    "vo_tpu_torch.parallel.window_blocks",
    "vo_tpu_torch.parallel.multihost",
    "bench_torch",
    "chip_smoke",
    "run_multiseq_torch",
    "run_vo_torch",
]

PORT_FILES = sorted((ROOT / "vo_tpu_torch").rglob("*.py")) + [
    ROOT / "bench_torch.py", ROOT / "chip_smoke.py", ROOT / "run_multiseq_torch.py",
    ROOT / "run_vo_torch.py",
] + sorted((ROOT / "tools").glob("*_torch.py")) + [
    ROOT / "tools" / "check_kernels_cuda.py",
    # The rank bodies of the distributed tests: the spawned ranks import it.
    ROOT / "tests" / "torch_dist_ranks.py",
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
    offenders = [str(f) for f in PORT_FILES if pattern.search(f.read_text())]
    assert not offenders, offenders


def _string_constants(tree):
    """Every string constant of a module that is not a docstring."""
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                docstrings.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docstrings]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_never_load_reference_files(path):
    """No loading of the reference's files by path either: no
    spec_from_file_location, runpy or exec, and no string that names a path
    into vo_tpu/ (docstrings may cite the reference; the `replaces` records
    of chip_smoke.py cite `file:line` of the TPU kernels and load nothing)."""
    text = path.read_text()
    tree = ast.parse(text)
    assert "spec_from_file_location" not in text
    assert "SourceFileLoader" not in text
    calls = {n.func.id for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert not calls & {"exec", "execfile", "__import__"}, calls
    imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
    assert not imported & {"runpy", "imp", "jax", "vo_tpu"}, imported
    citation = re.compile(r"^vo_tpu/ops/pallas_kernels\.py:\d+$")
    paths = [s for s in _string_constants(tree)
             if (re.search(r"(^|[/\\\s\"'])vo_tpu(/|$)", s) or s == "vo_tpu")
             and not citation.match(s)]
    assert not paths, paths


def test_config_is_the_reference_config():
    from vo_tpu.utils.config import VOConfig as JaxConfig

    from vo_tpu_torch.utils.config import VOConfig

    assert dataclasses.asdict(VOConfig()) == dataclasses.asdict(JaxConfig())
    assert dataclasses.asdict(VOConfig(capacity=384)) == dataclasses.asdict(
        JaxConfig(capacity=384))


def test_config_tree_has_the_reference_fields():
    """Class by class: the same fields in the same order with the same
    defaults and annotations, so a field added to the reference shows here."""
    from vo_tpu.utils import config as jcfg

    from vo_tpu_torch.utils import config as tcfg

    names = [n for n in dir(jcfg) if n.endswith("Config")]
    assert len(names) == 10 and names == [n for n in dir(tcfg) if n.endswith("Config")]
    for name in names:
        jf, tf = (dataclasses.fields(getattr(m, name)) for m in (jcfg, tcfg))
        assert [(f.name, f.type) for f in jf] == [(f.name, f.type) for f in tf], name
    assert tcfg.VOConfig(tracker="sift").desc_dim == jcfg.VOConfig(tracker="sift").desc_dim
    assert tcfg.VOConfig().replace(capacity=7) == tcfg.VOConfig(capacity=7)
    assert hash(tcfg.VOConfig()) == hash(tcfg.VOConfig())


def test_backend_config_has_the_reference_fields():
    """BackendConfig field by field: names, order, annotations, defaults."""
    from vo_tpu.models.backend import BackendConfig as JaxBackendConfig

    from vo_tpu_torch.models.backend import BackendConfig

    jf, tf = dataclasses.fields(JaxBackendConfig), dataclasses.fields(BackendConfig)
    assert [(f.name, f.type, f.default) for f in tf] == [(f.name, f.type, f.default) for f in jf]
    assert BackendConfig().min_similarity == 0.85 and BackendConfig().topk == 4


def test_loop_path_equals_the_reference():
    """The closed circuit's exact path, sampled as the reference samples it."""
    from vo_tpu.data import synthetic as jsyn

    from vo_tpu_torch.data import synthetic as tsyn

    np.testing.assert_array_equal(
        tsyn.make_path(tsyn.LOOP_SPEC.path, 1169)[::97],
        jsyn.make_path(jsyn.LOOP_SPEC.path, 1169)[::97])


def test_viz_text_equals_the_reference():
    import types

    from vo_tpu.utils import viz as jviz

    from vo_tpu_torch.utils import viz as tviz

    out = types.SimpleNamespace(num_tracked=np.int32(412), num_triangulated=np.int64(230),
                                num_candidates=9, num_pnp_inliers=np.int32(201),
                                num_new_landmarks=3)
    assert tviz.hud_text(out) == jviz.hud_text(out)
    a, b = tviz.FpsMeter(window=3), jviz.FpsMeter(window=3)
    for now in (0.0, 0.1, 0.3, 0.35, 0.6):
        assert a.tick(now) == b.tick(now)
    assert a.text() == b.text() and a.text().startswith("FPS:")


def _lane_specs():
    import run_multiseq as jrunner

    from vo_tpu_torch.data import synthetic as tsyn

    return jrunner._full_specs(600), tsyn.multiseq_specs(600)


LANES = ["city_lr", "city_rl", "scurve", "stopgo", "tight", "longrun"]


def test_lane_specs_are_the_reference_lanes():
    from vo_tpu.data import synthetic as jsyn

    from vo_tpu_torch.data import synthetic as tsyn

    jspecs, tspecs = _lane_specs()
    assert list(jspecs) == list(tspecs) == LANES
    for name in LANES:
        assert dataclasses.asdict(tspecs[name]) == dataclasses.asdict(jspecs[name]), name
    assert dataclasses.asdict(tsyn.DEFAULT_SPEC) == dataclasses.asdict(jsyn.DEFAULT_SPEC)
    assert dataclasses.asdict(tsyn.LOOP_SPEC) == dataclasses.asdict(jsyn.LOOP_SPEC)
    assert tsyn.LOOP_SPEC.num_frames == 1169
    assert tsyn.ADAPTIVE_LANES == {"stopgo", "tight"}
    want = dataclasses.replace(jspecs["city_lr"], seed=6,
                               dist=(-0.28, 0.08, 0.0005, -0.0005, 0.0))
    assert dataclasses.asdict(tsyn.distorted_spec(600)) == dataclasses.asdict(want)
    np.testing.assert_array_equal(tspecs["tight"].K(), jspecs["tight"].K())


@pytest.mark.parametrize("lane", LANES)
def test_city_generators_equal_the_reference(lane):
    """build_city, make_path, make_texture and render_frame of the port's
    copy give the reference's arrays for every lane's spec."""
    from vo_tpu.data import synthetic as jsyn

    from vo_tpu_torch.data import synthetic as tsyn

    jspecs, tspecs = _lane_specs()
    js, ts = jspecs[lane], tspecs[lane]
    jposes, tposes = jsyn.make_path(js.path, 120), tsyn.make_path(ts.path, 120)
    np.testing.assert_array_equal(tposes, jposes)
    jrects, trects = jsyn.build_city(js.path, js.seed), tsyn.build_city(ts.path, ts.seed)
    assert trects.count == jrects.count
    for f in ("p0", "e1", "e2", "uv_off", "tile_m", "gain"):
        np.testing.assert_array_equal(getattr(trects, f), getattr(jrects, f))
    jtex, ttex = jsyn.make_texture(js.seed + 1), tsyn.make_texture(ts.seed + 1)
    assert len(jtex) == len(ttex)
    for a, b in zip(ttex, jtex):
        np.testing.assert_array_equal(a, b)
    # One small frame mid-path, with and without the distorted lens.
    K = np.array([[52.0, 0, 40], [0, 52.0, 30], [0, 0, 1]], np.float32)
    for dist in ((0.0,) * 5, tsyn.DISTORTED_DIST):
        np.testing.assert_array_equal(
            tsyn.render_frame(trects, ttex, tposes[60], K, 80, 60, dist=dist),
            jsyn.render_frame(jrects, jtex, jposes[60], K, 80, 60, dist=dist))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluator_equals_the_reference(seed):
    from vo_tpu.data import evaluate as jev

    from vo_tpu_torch.data import evaluate as tev
    from vo_tpu_torch.data.synthetic import make_path, multiseq_specs

    rng = np.random.default_rng(seed)
    gt = make_path(list(multiseq_specs(80).values())[seed].path, 80)
    est = gt.copy()
    est[:, :3, 3] = 0.4 * est[:, :3, 3] + np.cumsum(rng.normal(0, 0.01, (80, 3)), axis=0)
    for with_scale in (True, False):
        a = tev.ate_rmse(tev.positions_from_poses(est), tev.positions_from_poses(gt), with_scale)
        b = jev.ate_rmse(jev.positions_from_poses(est), jev.positions_from_poses(gt), with_scale)
        assert abs(a - b) <= 1e-6 and a > 0
    for delta in (1, 5):
        np.testing.assert_allclose(tev.rpe(est, gt, delta), jev.rpe(est, gt, delta),
                                   rtol=0, atol=1e-6)
    for x, y in zip(tev.align_umeyama(est[:, :3, 3], gt[:, :3, 3]),
                    jev.align_umeyama(est[:, :3, 3], gt[:, :3, 3])):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)


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
    """Every tracker of the reference is ported: "harris" and "sift" run
    (on a blank frame they find nothing and say so), and only a tracker the
    reference does not have raises."""
    import torch

    from vo_tpu_torch.models.pipeline import bootstrap
    from vo_tpu_torch.utils.config import VOConfig

    img = torch.zeros((64, 64))
    state, out = bootstrap(img, img, torch.eye(3), VOConfig(capacity=32, tracker=tracker),
                           torch.Generator())
    assert not bool(out.pose_ok) and int(out.num_tracked) == 0
    assert state.table.desc.shape == (32, VOConfig(tracker=tracker).desc_dim)
    with pytest.raises(ValueError, match="unknown tracker"):
        bootstrap(img, img, torch.eye(3), VOConfig(tracker=tracker + "2"), torch.Generator())


def _function_ast(module, qualname: str) -> str:
    """The AST of a function or method without its docstring."""
    import inspect
    import textwrap

    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part)
    node = ast.parse(textwrap.dedent(inspect.getsource(obj))).body[0]
    body = node.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        node.body = body[1:]
    return ast.dump(node)


@pytest.mark.parametrize("name", ["synthetic._lighting_curves", "synthetic._apply_lighting",
                                  "synthetic._spec_digest", "loaders.Sequence._load_kitti",
                                  "loaders.Sequence._load_malaga",
                                  "loaders.Sequence.__post_init__"])
def test_data_copies_are_the_reference_code(name):
    """The lighting model, the render digest and the loaders' parsing are
    the reference's code statement for statement (docstrings aside), so a
    change there shows here."""
    import importlib

    mod, qual = name.split(".", 1)
    jmod = importlib.import_module(f"vo_tpu.data.{mod}")
    tmod = importlib.import_module(f"vo_tpu_torch.data.{mod}")
    assert _function_ast(tmod, qual) == _function_ast(jmod, qual)
    if mod == "synthetic":
        assert tmod._FORMAT_VERSION == jmod._FORMAT_VERSION
