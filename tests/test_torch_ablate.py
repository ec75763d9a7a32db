"""The port's ablation and gate tools against the JAX package's on the CPU:
the same variants by the same names and values (the JAX tools run with
their rollouts and loaders stubbed, recording every configuration they
build), the same stop-and-go city, the same drift-gate decision; then a
`--device cpu` run of each ablation at a few steps on a small city, and its
exit code when a variant fails."""

import dataclasses
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import ablate_keyframes  # noqa: E402
import ablate_keyframes_torch  # noqa: E402
import ablate_step_cost  # noqa: E402
import ablate_step_cost_torch  # noqa: E402
import bench  # noqa: E402
import bench_torch  # noqa: E402
import check_headline  # noqa: E402
import check_headline_torch  # noqa: E402
import probe_ablate  # noqa: E402
import probe_ablate_torch  # noqa: E402
import repro_headline  # noqa: E402
import repro_headline_torch  # noqa: E402
import vo_tpu.data  # noqa: E402
import vo_tpu.data.synthetic as jsyn  # noqa: E402
import vo_tpu.models.pipeline as jpipe  # noqa: E402
from vo_tpu_torch.data import synthetic as tsyn  # noqa: E402
from vo_tpu_torch.utils.config import VOConfig  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(width=160, height=120, focal=104.0)
SMALL_CAPACITY = 192
CPU = torch.device("cpu")


class FakeSequence:
    """What the JAX tools read of a `vo_tpu.data.Sequence`: n blank 8x8
    frames, K and GT poses."""

    def __init__(self, *a, n=8, **k):
        self.K = np.eye(3, dtype=np.float32)
        self._n = n
        self.gt_poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        self.gt_poses[:, 0, 3] = np.arange(n)

    def __len__(self):
        return self._n

    def get_frame(self, i):
        return np.zeros((8, 8), np.float32)


def _asdict(cfgs: dict) -> dict:
    return {name: dataclasses.asdict(cfg) for name, cfg in cfgs.items()}


def _recording_bootstrap(seen: list, state=None):
    def bootstrap(img0, img1, K, cfg, key):
        seen.append(cfg)
        return state, None
    return bootstrap


def test_probe_variants_are_the_jax_tools(monkeypatch, capsys):
    """probe_ablate.py's six configurations, in order, by name and value."""
    seen = []
    monkeypatch.setattr(vo_tpu.data, "Sequence", FakeSequence)
    monkeypatch.setattr(jpipe, "bootstrap", _recording_bootstrap(seen))
    monkeypatch.setattr(jpipe, "vo_rollout", lambda *a: (None, types.SimpleNamespace(
        pose=jnp.zeros((2, 4, 4)))))
    monkeypatch.setattr(sys, "argv", ["probe_ablate.py", "--steps", "2", "--repeats", "1"])
    assert probe_ablate.main() == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if '"variant"' in ln]
    jax_cfgs = dict(zip([r["variant"] for r in rows], seen))
    port = probe_ablate_torch.variants(VOConfig(capacity=bench_torch.KITTI_CAPACITY))
    assert list(port) == list(jax_cfgs) and len(port) == 6
    assert _asdict(port) == _asdict(jax_cfgs)


def test_step_cost_variants_are_the_jax_tools(monkeypatch, capsys):
    """ablate_step_cost.py's nine configurations, in order, by name and value."""
    seen = []
    monkeypatch.setattr(ablate_step_cost, "Sequence", FakeSequence)
    monkeypatch.setattr(ablate_step_cost, "run",
                        lambda cfg, imgs, K: (seen.append(cfg), (10.0, 100.0))[1])
    ablate_step_cost.main()
    names = [ln[:22].strip() for ln in capsys.readouterr().out.splitlines()
             if "ms/frame" in ln]
    port = ablate_step_cost_torch.variants(VOConfig(capacity=ablate_step_cost_torch.CAPACITY))
    assert list(port) == names and len(port) == 9
    assert _asdict(port) == _asdict(dict(zip(names, seen)))


def test_repro_variants_are_the_jax_tools(monkeypatch, capsys):
    """repro_headline.py --also-detect's four configurations."""
    seen = []
    monkeypatch.setattr(vo_tpu.data, "Sequence", FakeSequence)
    monkeypatch.setattr(repro_headline, "run",
                        lambda cfg, imgs, K, gt: (seen.append(cfg), {"fps": 1.0})[1])
    for also in (False, True):
        seen.clear()
        monkeypatch.setattr(sys, "argv", ["repro_headline.py"] + ["--also-detect"] * also)
        repro_headline.main()
        line = json.loads(capsys.readouterr().out.splitlines()[-1])
        names = [k for k in line if k != "device"]
        port = repro_headline_torch.variants(VOConfig(capacity=repro_headline_torch.CAPACITY),
                                             also)
        assert list(port) == names and len(port) == 2 + 2 * also
        assert _asdict(port) == _asdict(dict(zip(names, seen)))


@pytest.mark.parametrize("overrides", [[], ["--min-baseline-ratio", "0.06",
                                            "--min-covisibility", "0.5", "--max-gap", "7"]])
def test_keyframe_trials_and_city_are_the_jax_tools(overrides, monkeypatch, capsys, tmp_path):
    """ablate_keyframes.py's stop-and-go spec and three policies (with and
    without the adaptive overrides), for both scenarios; the stop-and-go
    path's poses equal the JAX package's to 1e-6."""
    from typing import NamedTuple

    class State(NamedTuple):
        last_kf_idx: object
        pose: object

    class Out(NamedTuple):
        pose: object
        pose_ok: object

    specs, seen = [], []
    monkeypatch.setattr(jsyn, "generate", lambda out, spec: specs.append(spec))
    monkeypatch.setattr(vo_tpu.data, "Sequence", FakeSequence)
    monkeypatch.setattr(vo_tpu.data, "ate_rmse", lambda *a: 0.0)
    monkeypatch.setattr(jpipe, "bootstrap", _recording_bootstrap(
        seen, State(jnp.int32(2), jnp.eye(4))))
    monkeypatch.setattr(jpipe, "vo_step", lambda s, im, K, c: (
        s, Out(jnp.eye(4), jnp.bool_(True))))
    monkeypatch.setattr(sys, "argv", ["ablate_keyframes.py", "--platform", "cpu", "--frames",
                                      "40", "--data-root", str(tmp_path)] + overrides)
    ablate_keyframes.main()
    names = [ln.split(":")[0].strip() for ln in capsys.readouterr().out.splitlines()
             if "ATE" in ln]
    kw = dict(zip(("min_baseline_ratio", "min_covisibility", "max_gap"),
                  (float(overrides[1]), float(overrides[3]), int(overrides[5])))) \
        if overrides else {}
    port = ablate_keyframes_torch.trials(**kw)
    assert names == list(port) * 2  # stopgo, then headline
    assert _asdict(dict(zip(names, seen[:3]))) == _asdict(port)
    assert _asdict(dict(zip(names, seen[3:]))) == _asdict(port)
    assert len(specs) == 1
    ours = ablate_keyframes_torch.stopgo_spec(40)
    assert dataclasses.asdict(ours) == dataclasses.asdict(specs[0])
    full, jfull = ablate_keyframes_torch.stopgo_spec(400), dataclasses.replace(
        specs[0], num_frames=400)
    np.testing.assert_allclose(tsyn.make_path(full.path, 400),
                               jsyn.make_path(jfull.path, 400), rtol=0, atol=1e-6)


@pytest.mark.parametrize("drift_pct,want", [(0.0, 0), (4.9, 0), (5.1, 1), (-5.1, 1)])
def test_drift_gate_decides_as_the_jax_tool(drift_pct, want, monkeypatch, tmp_path):
    """Both gates over the same stubbed headline: the same exit code at each
    drift; the port reads only its own expected file."""
    expected = {"ate_rmse_m": 1.4494, "tol_pct": 5.0, "frames": 597}
    ate = round(expected["ate_rmse_m"] * (1.0 + drift_pct / 100.0), 6)
    result = {"ate_rmse_m": ate, "frames": 597, "rpe_trans_m": 0.1, "value": 5.0}
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    for p in (jpath, tpath):
        p.write_text(json.dumps(expected))
    monkeypatch.setattr(check_headline, "EXPECTED_PATH", str(jpath))
    monkeypatch.setattr(check_headline_torch, "EXPECTED_PATH", tpath)
    monkeypatch.setattr(bench, "bench_synthetic_full", lambda: result)
    monkeypatch.setattr(bench_torch, "bench_synthetic_full",
                        lambda dev, root: types.SimpleNamespace(result=result))
    monkeypatch.setattr(sys, "argv", ["check_headline.py"])
    assert check_headline.main() == want
    assert check_headline_torch.main(["--device", "cpu"]) == want
    ok, drift = check_headline_torch.gate(result, expected, 5.0)
    assert ok == (want == 0) and drift == pytest.approx(abs(drift_pct), rel=1e-4)


def test_drift_gate_update_writes_only_the_ports_file(monkeypatch, tmp_path):
    """--update re-baselines the port's file with the card's name; the JAX
    package's expected file is another file and stays as it was."""
    assert check_headline_torch.EXPECTED_PATH.name == "headline_expected_torch.json"
    assert Path(check_headline.EXPECTED_PATH).resolve() != check_headline_torch.EXPECTED_PATH
    jpath = tmp_path / "jax.json"
    jpath.write_text("untouched")
    tpath = tmp_path / "torch.json"
    monkeypatch.setattr(check_headline, "EXPECTED_PATH", str(jpath))
    monkeypatch.setattr(check_headline_torch, "EXPECTED_PATH", tpath)
    result = {"ate_rmse_m": 1.25, "frames": 597, "rpe_trans_m": 0.1}
    monkeypatch.setattr(bench_torch, "bench_synthetic_full",
                        lambda dev, root: types.SimpleNamespace(result=result))
    assert check_headline_torch.main(["--device", "cpu", "--update"]) == 0
    assert json.loads(tpath.read_text()) == {"ate_rmse_m": 1.25, "tol_pct": 5.0,
                                             "frames": 597, "device": "cpu"}
    assert jpath.read_text() == "untouched"
    # The shipped file is the card's figure, gated at 5%.
    shipped = json.loads((ROOT / "tools" / "headline_expected_torch.json").read_text())
    assert shipped["frames"] == 597 and shipped["tol_pct"] == 5.0
    assert shipped["device"].startswith("NVIDIA")


@pytest.fixture(scope="module")
def small_city(tmp_path_factory):
    """A 12-frame city at 160x120 under <tmp>/synthetic."""
    root = tmp_path_factory.mktemp("city")
    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, num_frames=12, **SMALL)
    tsyn.generate(str(root / "synthetic"), spec, verbose=False, device="cpu")
    return root


def _last_json(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def _small(monkeypatch, tool):
    """The tool at capacity 192 (and the probe at 200x64) for speed."""
    for mod, name in ((ablate_step_cost_torch, "CAPACITY"), (repro_headline_torch, "CAPACITY"),
                      (ablate_keyframes_torch, "CAPACITY"), (bench_torch, "KITTI_CAPACITY")):
        monkeypatch.setattr(mod, name, SMALL_CAPACITY)
    monkeypatch.setattr(probe_ablate_torch, "KITTI_W", 200)
    monkeypatch.setattr(probe_ablate_torch, "KITTI_H", 64)
    monkeypatch.setattr(probe_ablate_torch, "KITTI_FOCAL", 110.0)
    monkeypatch.setattr(tsyn, "DEFAULT_SPEC", dataclasses.replace(tsyn.DEFAULT_SPEC, **SMALL))


def _argv(tool, root) -> list:
    return {
        "probe": ["--steps", "3", "--repeats", "1", "--kitti-root", str(root)],
        "step_cost": ["--steps", "3", "--repeats", "1", "--data-root", str(root)],
        "repro": ["--frames", "7", "--also-detect", "--data-root", str(root)],
        "keyframes": ["--scenario", "stopgo", "--frames", "12", "--data-root",
                      str(root / "stopgo")],
    }[tool] + ["--device", "cpu"]


TOOLS = {"probe": probe_ablate_torch, "step_cost": ablate_step_cost_torch,
         "repro": repro_headline_torch, "keyframes": ablate_keyframes_torch}


def _rows(tool, line) -> list:
    if tool == "repro":
        return [dict(variant=k, **v) for k, v in line.items() if isinstance(v, dict)]
    if tool == "keyframes":
        return line["stopgo"]["rows"]
    return line["rows"]


def _variant_table(tool):
    """The tool's variant names and configurations."""
    if tool == "keyframes":
        return ablate_keyframes_torch.trials()
    mod = TOOLS[tool]
    if tool == "repro":
        return mod.variants(VOConfig(capacity=SMALL_CAPACITY), True)
    return mod.variants(VOConfig(capacity=SMALL_CAPACITY))


@pytest.mark.parametrize("tool", list(TOOLS))
def test_ablation_runs_every_variant_on_the_cpu(tool, small_city, monkeypatch, capsys):
    """Every variant's row, by name, with finite figures; the CPU launches
    no kernel; the JSON line names the device."""
    _small(monkeypatch, tool)
    assert TOOLS[tool].main(_argv(tool, small_city)) == 0
    line = _last_json(capsys.readouterr().out)
    assert line["device"] == "cpu"
    rows = _rows(tool, line)
    assert [r["variant"] for r in rows] == list(_variant_table(tool))
    for r in rows:
        assert "error" not in r, r
        nums = [v for k, v in r.items() if isinstance(v, (int, float)) and v is not None]
        assert np.isfinite(nums).all(), r
        assert r["finite"] == r["steps"] and r["k1"] == 0 and r["k2"] == 0, r
    if tool == "repro":  # the CPU runs the plain versions in every variant
        assert all(r["bit_equal_to_default"] and r["lk"] == 0 for r in rows)
        assert len({r["poses_sha256"] for r in rows}) == 1
    if tool == "keyframes":
        assert {r["variant"]: r["pushes"] for r in rows}["no-ba"] == 0


@pytest.mark.parametrize("tool", list(TOOLS))
def test_ablation_exits_1_when_a_variant_fails(tool, small_city, monkeypatch, capsys):
    """A variant that raises is reported with its error; the next still runs;
    the tool exits 1."""
    _small(monkeypatch, tool)
    table = _variant_table(tool)
    first = next(iter(table))
    broken = {"broken": dataclasses.replace(table[first], tracker="nope"),
              first: table[first]}
    name = "trials" if tool == "keyframes" else "variants"
    monkeypatch.setattr(TOOLS[tool], name, lambda *a, **k: broken)
    argv = _argv(tool, small_city)
    if tool == "step_cost":
        argv[1] = "2"
    assert TOOLS[tool].main(argv) == 1
    out = capsys.readouterr()
    rows = _rows(tool, _last_json(out.out))
    assert [r["variant"] for r in rows] == ["broken", first]
    assert "unknown tracker" in rows[0]["error"] and "error" not in rows[1]
    assert "Traceback" in out.err


@pytest.mark.parametrize("reverse,again", [(False, False), (False, True), (True, True)])
def test_step_cost_order(reverse, again, monkeypatch):
    """`default` first, then the others in the JAX tool's order or reversed,
    then with `--again` `default` once more; no variant is left out."""
    seen = {}
    monkeypatch.setattr(ablate_step_cost_torch.common_torch, "run_variants",
                        lambda table, measure: seen.update(table) or [])
    ablate_step_cost_torch.ablate(torch.zeros(4, 8, 8), None, CPU, 1, 1, reverse, again)
    table = ablate_step_cost_torch.variants(VOConfig(capacity=ablate_step_cost_torch.CAPACITY))
    rest = list(table)[1:]
    want = ["default"] + (rest[::-1] if reverse else rest) + (["default again"] if again else [])
    assert list(seen) == want
    assert all(seen[n] == table[n.removesuffix(" again")] for n in seen)


def test_keyframes_stop_counts_pushes_while_standing(monkeypatch, tmp_path):
    """The stop-and-go city rolled from frame 64 into its first stop (the
    camera stands from frame 71 on): 17 standing steps of 21; no-ba pushes
    nothing, adaptive at most once (the baseline it had gathered before the
    stop) and every3 more (a keyframe every third frame, moving or not)."""
    _small(monkeypatch, "keyframes")
    rows = ablate_keyframes_torch.stopgo(str(tmp_path), 88, CPU, ablate_keyframes_torch.trials(),
                                         first=64)
    by = {r["variant"]: r for r in rows}
    assert list(by) == ["every3", "adaptive", "no-ba"]
    for r in rows:
        assert "error" not in r, r
        assert (r["steps"], r["stopped_steps"], r["finite"]) == (21, 17, 21), r
        assert np.isfinite(r["ate_m"]), r
    assert by["no-ba"]["pushes"] == 0
    assert by["adaptive"]["pushes_stopped"] <= 1 < by["every3"]["pushes_stopped"]
