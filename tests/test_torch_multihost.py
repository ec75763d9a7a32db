"""The multi-process half of the port's distributed layer on the CPU: the
worker of vo_tpu_torch.parallel.multihost in each of its modes over a real
two-rank Gloo cluster (spawned processes, like tests/test_multihost.py does
for the JAX package), the cluster launcher, and run_multiseq_torch.py's
--multihost and --seqpar-shards. These import no jax."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from vo_tpu_torch.parallel import multihost

ROOT = Path(__file__).resolve().parent.parent
# Several pytest-xdist workers share the cores: one thread a rank.
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
CLUSTER_TIMEOUT_S = 240  # a hung rank fails its test, not the suite
SMALL = ["--device", "cpu", "--scale", "0.25"]  # the city at 160x120


@pytest.mark.parametrize("mode", ["rollout", "dist-ba", "seqpar-ba"])
def test_two_rank_worker_matches_the_single_device_solver(mode):
    """2 ranks on Gloo: the rollout (2 lanes a rank, the whole 160x120
    frame) sums its lanes across ranks and gives finite poses; the sharded
    BA modes match the single-device solver at the JAX package's tolerances
    and improve the window."""
    extra = {"rollout": ["--lanes-per-device", "2", "--steps", "4", "--crop", "120x160",
                         "--capacity", "128"],
             "dist-ba": ["--dist-ba"], "seqpar-ba": ["--seqpar-ba"]}[mode]
    rep = multihost.run_cluster(2, extra + SMALL, timeout=CLUSTER_TIMEOUT_S, env=ENV)
    assert rep["world_size"] == 2 and rep["backend"] == "gloo" and rep["device"] == "cpu"
    assert rep["seconds"] > 0
    if mode == "rollout":
        assert rep["metric"] == "multihost_vo" and rep["lanes_global"] == 4
        assert rep["gsum_ok"] and rep["finite"] and rep["agg_fps"] > 0
        assert rep["frame"] == [120, 160] and rep["pose_ok"] >= 8
        # No kernel on the CPU: every launch count is zero on both ranks.
        assert all(c == [0, 0] for c in rep["launches"].values())
    else:
        assert rep["metric"] == {"dist-ba": "multihost_dist_ba",
                                 "seqpar-ba": "multihost_seqpar_ba"}[mode]
        assert all(rep["match"].values()) and rep["improved"] and rep["all_ranks_ok"]
        if mode == "seqpar-ba":
            assert rep["window_effective"] == 8
        else:
            assert rep["landmarks"] == 128


def test_worker_refuses_what_is_not_ported():
    """Every dataset is ported now: what the worker still refuses is a card
    it does not have (exit 2) and a dataset it does not know (argparse)."""
    for argv, word, code in ((["--device", "cuda"], "CUDA", 2),
                             (["--dataset", "tum", "--device", "cpu"], "invalid choice", 2)):
        env = {**ENV, "CUDA_VISIBLE_DEVICES": ""}
        proc = subprocess.run(
            multihost.worker_cmd("localhost:1", 1, 0, argv), cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == code and word in proc.stderr


def test_worker_reads_a_parking_layout(tmp_path):
    """Two ranks, each rolling 2 lanes over a parking layout on disk (the
    small city written by `generate`), cropped to 96x128: the reference's
    `--dataset` / `--data-root` path of the worker."""
    import dataclasses

    from vo_tpu_torch.data import synthetic as tsyn

    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, num_frames=8, width=160, height=120,
                               focal=104.0)
    tsyn.generate(str(tmp_path / "parking"), spec, verbose=False, device="cpu")
    rep = multihost.run_cluster(2, ["--dataset", "parking", "--data-root", str(tmp_path),
                                    "--crop", "96x128", "--lanes-per-device", "2",
                                    "--steps", "6", "--capacity", "128", "--device", "cpu"],
                                timeout=CLUSTER_TIMEOUT_S, env=ENV)
    assert rep["metric"] == "multihost_vo" and rep["world_size"] == 2
    assert rep["frame"] == [96, 128] and rep["lanes_global"] == 4
    assert rep["gsum_ok"] and rep["finite"] and rep["agg_fps"] > 0
    assert multihost.frame_plan(8, 6) == [3, 4, 5, 6, 7, 6]


def test_launch_kills_the_cluster_when_a_rank_fails():
    """One rank exits 3 at once, its peer would wait a minute: the launcher
    raises with the rank's output and leaves nothing running."""
    cmds = [[sys.executable, "-c", "import sys; print('bye'); sys.exit(3)"],
            [sys.executable, "-c", "import time; time.sleep(60)"]]
    with pytest.raises(RuntimeError, match="rank 0 exited 3"):
        multihost.launch(cmds, timeout=30)
    cmds = [[sys.executable, "-c", "import time; time.sleep(60)"]]
    with pytest.raises(RuntimeError, match="outlived"):
        multihost.launch(cmds, timeout=2)


def _script(*argv):
    proc = subprocess.run([sys.executable, "run_multiseq_torch.py", *argv], cwd=ROOT, env=ENV,
                          capture_output=True, text=True, timeout=2 * CLUSTER_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def test_run_multiseq_torch_multihost_prints_its_table():
    lines = _script("--multihost", "1,2", "--mh-steps", "3", "--mh-repeats", "2",
                    "--mh-crop", "120x160", *SMALL)
    assert [r["world_size"] for r in lines[:2]] == [1, 2]
    table = lines[-1]
    assert table["metric"] == "multihost_weak_scaling"
    assert [r["processes"] for r in table["rows"]] == [1, 2]
    assert [r["lanes"] for r in table["rows"]] == [1, 2]
    assert table["rows"][0]["weak_scaling_eff"] == 1.0
    assert all(r["backend"] == "gloo" and r["agg_fps"] > 0 for r in table["rows"])


def test_run_multiseq_torch_seqpar_shards():
    """Two ranks refine the composed 8-keyframe window of a real rollout;
    the back-end must beat the rollout without it (the JAX package's gate)."""
    (rep,) = _script("--seqpar-shards", "2", "--seqpar-steps", "40", "--capacity", "128",
                     *SMALL)
    assert rep["metric"] == "seqpar_window_rollout" and rep["passed"]
    assert rep["world_size"] == 2 and rep["backend"] == "gloo" and rep["window_effective"] == 8
    assert rep["refinements"] >= 2 and rep["finite"]
    assert rep["ate_seqpar_m"] < rep["ate_no_refine_m"]
