"""The metric arithmetic and the registry, on hand-made inputs."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from vobench import check, harness, registry, roofline, run, trace
from vobench.run import Reading


def _slice(device, steps=2, lanes=1, host=()):
    return trace.Slice(sorted(device, key=lambda d: d[2]), list(host), steps, lanes)


def test_union_busy_and_step_ms_on_overlapping_streams():
    # Two streams: 0-10 and 5-12 overlap (busy 0-12), a copy 20-25, a
    # kernel 30-40 that a second stream's 32-35 sits inside. Span 0-40.
    dev = [("a", "kernel", 0.0, 10.0), ("b", "kernel", 5.0, 12.0),
           ("copy", "gpu_memcpy", 20.0, 25.0), ("c", "kernel", 30.0, 40.0),
           ("d", "kernel", 32.0, 35.0)]
    s = _slice(dev, steps=2, host=[("cudaGraphLaunch", 11.0, 21.0), ("outer", 0.0, 40.0)])
    assert trace.busy(s.device) == [(0.0, 12.0), (20.0, 25.0), (30.0, 40.0)]
    assert trace.busy_s(s) == pytest.approx(27e-6)
    assert trace.span_s(s) == pytest.approx(40e-6)
    ctx = Reading(s, 1, 480, 640, 1024, 4, None)
    assert registry.metric("step_device_ms")(ctx) == pytest.approx(1e3 * 27e-6 / 2)
    # The summed kernel time would have read 35 us busy: the union is 27.
    assert sum(d[3] - d[2] for d in dev) == pytest.approx(35.0)
    gaps = trace.idle_gaps(s)
    assert gaps[0] == ["cudaGraphLaunch", pytest.approx(8e-6)]  # 12-20, inside 11-21
    assert gaps[1] == ["outer", pytest.approx(5e-6)]  # 25-30
    top = trace.top_device_ops(s)
    assert top[0] == ["a", pytest.approx(10e-6)] and len(top) == 5


def test_roofline_shares_from_launch_shapes():
    k1 = roofline.K1_SYMBOL
    k2 = roofline.K2_SYMBOL
    t1 = roofline.k1_bound_s(1, 480, 640) * 1e6  # us
    dev = [(f"void {k1}<7, 8>(...)", "kernel", 100.0 * i, 100.0 * i + 4 * t1)
           for i in range(3)]
    step = roofline.k2_step_bound_s(1, 480, 640, 1024, 4) * 1e6
    dev += [(f"void {k2}(...)", "kernel", 1000.0 + 10 * i, 1000.0 + 10 * i + step / 2)
            for i in range(8)]  # two steps of four levels, each at half the bound
    ctx = Reading(_slice(dev), 1, 480, 640, 1024, 4, None)
    assert registry.metric("k1_roofline_pct")(ctx) == pytest.approx(25.0)
    assert registry.metric("k2_roofline_pct")(ctx) == pytest.approx(100.0 * 2 * step / (8 * step / 2))
    assert registry.metric("k1b_roofline_pct")(ctx) is None  # one lane: K1, not K1b
    batch = Reading(_slice(dev, lanes=6), 6, 480, 640, 512, 4, None)
    t1b = roofline.k1_bound_s(6, 480, 640) * 1e6
    assert registry.metric("k1b_roofline_pct")(batch) == pytest.approx(100 * t1b / (4 * t1))
    assert registry.metric("k1_roofline_pct")(batch) is None
    # Launches that are not whole steps, or none at all: nothing to read.
    odd = Reading(_slice(dev[:-1]), 1, 480, 640, 1024, 4, None)
    assert registry.metric("k2_roofline_pct")(odd) is None
    assert registry.metric("k1_roofline_pct")(Reading(None, 1, 480, 640, 1024, 4, None)) is None
    assert registry.metric("syncs_per_frame")(
        Reading(None, 1, 480, 640, 1024, 4, {"frames": 10, "syncs_per_step": 0.0})) == 0.0


def test_a_pass_runs_in_chunks_of_15_and_1():
    mix = registry.traffic("offline")
    chunks = harness.schedule(mix["first_frame"], 600, mix["chunk_frames"])
    assert chunks[:3] == [(3, 15), (18, 1), (19, 15)]
    assert sum(n for _, n in chunks) == 597 and chunks[-1] == (3 + 37 * 16, 5)
    # Every 16th frame is a chunk of its own: the probes of the front end.
    assert [lo for lo, n in chunks if n == 1] == list(range(18, 600, 16))


def _pass(frames, pose, complete):
    n = len(frames)
    return check.PassAnswers(np.asarray(frames), pose, np.ones((n, 1), bool), complete, [])


def test_ate_pools_whole_passes_each_aligned_alone():
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, 0, 3] = 0.3 * np.arange(20)
    gt[:, 2, 3] = 0.01 * np.arange(20) ** 2

    class S:
        n_lanes = 1
        boot_frames = (0, 2)

    S.gt = gt[None]

    def est(scale, offset, noise):
        e = gt[list(range(3, 20))].copy()
        e[:, :3, 3] = scale * e[:, :3, 3] + offset
        e[:, 0, 3] += noise
        return e[:, None]

    rng = np.random.default_rng(1)
    noise_a, noise_b = rng.normal(0, 0.1, 17), rng.normal(0, 0.2, 17)
    boot = harness.Boot(None, gt[2][None].copy())
    # Each whole pass in its own scale and offset: aligned alone, both read
    # their noise; the cut pass is far off and must not count.
    answers = [_pass(range(3, 20), est(1.0, 0.0, noise_a), True),
               _pass(range(3, 20), est(1.0, 0.0, noise_b), True),
               _pass(range(3, 10), est(1.0, 50.0, 0.0)[:7], False)]

    got = run.pooled_ate(S, boot, answers)
    sq = [check.ate_sq_errors(check.trajectory(boot.poses[0], p, 0, (0, 2))[0],
                              gt[[0, 2] + list(range(3, 20))]) for p in answers[:2]]
    assert got == pytest.approx(float(np.sqrt(np.concatenate(sq).mean())))
    assert run.pooled_ate(S, boot, answers[2:]) is None


def test_end_to_end_takes_every_frame_of_the_window():
    cell = registry.cell("city640.offline")
    got = run.end_to_end(cell, 3000, 50.0, {"seg_err_med_m": 0.0071}, 9.5)
    assert got == {"fps": {"value": 60.0, "unit": "frames/s"},
                   "rpe_mm": {"value": pytest.approx(7.1), "unit": "mm"},
                   "setup_s": {"value": 9.5, "unit": "s"}}


def test_a_pose_that_is_not_finite_fails_every_frame_of_its_pass():
    gt = np.tile(np.eye(4), (70, 1, 1))
    gt[:, 0, 3] = 0.3 * np.arange(70)
    est = gt.copy()
    est[40, 0, 3] = np.nan
    errs = check.segment_errors(est, gt)
    assert errs.shape == (70,) and np.isinf(errs).all()
    assert np.median(check.segment_errors(gt, gt)) == pytest.approx(0.0, abs=1e-9)
    ok, checks = check.judge({n: 0.0 for n in check.NAMES} | {"nonfinite_poses": 1.0},
                             {n: 0.0 for n in check.NAMES} | {"seg_err_med_m": 1.0})
    assert ok is False and checks["nonfinite_poses"] == {"value": 1.0, "limit": 0.0}


def test_registry_finds_a_new_config_mix_metric_and_cell_from_files(tmp_path):
    root = tmp_path / "vobench"
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = registry.config("city640")
    cfg["name"] = "city320"
    (root / "configs" / "city320.json").write_text(json.dumps(cfg))
    (root / "traffic" / "offline32.json").write_text(json.dumps(
        dict(registry.traffic("offline"), name="offline32", chunk_frames=[31, 1])))
    (root / "metrics" / "frames_traced.py").write_text(
        "def read(ctx):\n    return None if ctx.slice is None else float(ctx.slice.steps)\n")
    (root / "limits" / "city320.offline32.json").write_text(json.dumps(registry.limits(
        "city640.offline")))
    bench = json.loads(registry.BENCHMARK.read_text())
    bench["workloads"].append({"name": "city320.offline32", "config": "city320",
                               "traffic": "offline32", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "count", "better": "higher",
                               "source": "device_trace", "layer": "step",
                               "moves": "fps", "workloads": ["city320.offline32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.cell("city320.offline32", tmp_path / "BENCHMARK.json", root)
    assert cell.config["name"] == "city320" and cell.traffic["chunk_frames"] == [31, 1]
    assert sorted(m["name"] for m in cell.end_to_end) == ["fps", "rpe_mm", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["frames_traced"]
    reader = registry.metric("frames_traced", root)
    assert reader(Reading(trace.Slice([], [], 7, 1), 1, 1, 1, 1, 1, None)) == 7.0
    with pytest.raises(KeyError):
        registry.cell("city320.offline", tmp_path / "BENCHMARK.json", root)


def test_frame_cache_writes_once_and_reads_back(tmp_path):
    from vobench.tests.conftest import tiny_cell

    cfg = tiny_cell("city640", "offline", frames=4, width=48, height=36).config
    cfg["lanes"].append(dict(cfg["lanes"][0], name="city2", seed=1))
    calls = []

    def render():
        calls.append(1)
        return torch.arange(4 * 2 * 36 * 48, dtype=torch.int64).reshape(4, 2, 36, 48).to(
            torch.uint8)

    first = harness.cached_frames(cfg, render, tmp_path)
    again = harness.cached_frames(cfg, render, tmp_path)
    assert calls == [1] and torch.equal(first, again)
    assert [p.name.split("-")[0] for p in tmp_path.iterdir()] == ["city640"]
    other = dict(cfg, lanes=cfg["lanes"][:1])
    harness.cached_frames(other, lambda: render()[:, :1], tmp_path)
    assert calls == [1, 1] and len(list(tmp_path.iterdir())) == 2
