"""The `run_vo_torch.py` entry point on the CPU at a small size: every
tracker, chunked stepping, checkpoint and resume, the pose-graph back-end,
the flags that are not ported, and the refusal to run without a GPU."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import run_vo_torch
from vo_tpu_torch.data import synthetic as tsyn

torch.set_num_threads(1)

SMALL = dict(width=160, height=120, focal=104.0)
RESULT_KEYS = {"fps_steady", "frames", "ate_rmse_m", "rpe_trans_m", "rpe_rot_rad"}
PG_KEYS = {"pg_nodes", "pg_loops", "pg_culled", "pg_seconds", "ate_rmse_m_pre_pg"}


@pytest.fixture
def small_city(monkeypatch):
    """Both synthetic specs cut to 160x120 (focal 104)."""
    monkeypatch.setattr(tsyn, "DEFAULT_SPEC", dataclasses.replace(tsyn.DEFAULT_SPEC, **SMALL))
    monkeypatch.setattr(tsyn, "LOOP_SPEC", dataclasses.replace(tsyn.LOOP_SPEC, **SMALL))


def drive(capsys, *argv, frames=24, capacity=128):
    """main() on the CPU; returns (exit code, the final JSON object, stdout)."""
    rc = run_vo_torch.main(["--device", "cpu", "--max-frames", str(frames), "--capacity",
                            str(capacity), "--quiet", *argv])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None), out


@pytest.mark.parametrize("tracker", ["klt", "harris", "sift"])
def test_every_tracker_runs(small_city, capsys, tracker):
    rc, result, out = drive(capsys, "--tracker", tracker)
    assert rc == 0
    assert RESULT_KEYS <= result.keys(), result
    assert result["frames"] == 23  # frame 0, the bootstrap frame, 21 steps
    assert np.isfinite([result[k] for k in RESULT_KEYS]).all()
    assert "diverged_at_frame" not in result
    assert "[vo_tpu_torch] bootstrap(0,2)" in out and "steady-state" in out


def test_loop_sequence_is_a_prefix_of_the_circuit(small_city):
    """`loop_sequence(device, n)` renders the first n frames of LOOP_SPEC: the
    ground truth is the head of the full circuit's, and a shorter rendering is
    the head of a longer one, frame for frame."""
    cpu = torch.device("cpu")
    seq = tsyn.loop_sequence(cpu, 6)
    assert seq.frames.shape == (6, 120, 160) and seq.frames.dtype == torch.float32
    assert seq.spec == dataclasses.replace(tsyn.LOOP_SPEC, num_frames=6)
    full = tsyn.make_path(tsyn.LOOP_SPEC.path, tsyn.LOOP_SPEC.num_frames)
    np.testing.assert_array_equal(seq.gt_poses, full[:6])
    short = tsyn.render_sequence(tsyn.LOOP_SPEC, cpu, 4)
    assert torch.equal(short.frames, seq.frames[:4])


def test_per_frame_log_lines(small_city, capsys):
    rc = run_vo_torch.main(["--device", "cpu", "--max-frames", "8", "--capacity", "128",
                            "--debug-validate"])
    out = capsys.readouterr().out
    assert rc == 0
    frames = [ln for ln in out.splitlines() if ln.startswith("[vo_tpu_torch] frame")]
    assert len(frames) == 5 and "FPS:" in frames[-1] and "pnp_inl" in frames[-1]


def test_chunked_rollout_equals_per_frame_stepping(small_city, capsys, tmp_path):
    """--chunk 4 (vo_rollout) gives the poses of --chunk 1 bit for bit."""
    paths = []
    for chunk in ("1", "4"):
        paths.append(str(tmp_path / f"c{chunk}.npz"))
        rc, _, _ = drive(capsys, "--chunk", chunk, "--save-npz", paths[-1], frames=19)
        assert rc == 0
    a, b = np.load(paths[0]), np.load(paths[1])
    np.testing.assert_array_equal(a["frame_ids"], b["frame_ids"])
    np.testing.assert_array_equal(a["poses"], b["poses"])
    stats = json.loads(str(b["stats"]))
    assert len(stats) == 16 and {"frame", "ok", "tracked", "tri", "frozen"} <= stats[0].keys()


@pytest.mark.parametrize("extra", [(), ("--pose-graph", "--pg-every", "4",
                                        "--pg-min-frame-gap", "8")])
def test_checkpoint_then_resume_equals_the_straight_run(small_city, capsys, tmp_path, extra):
    """A run that stops early with a checkpoint and a second that resumes
    it to the end give the straight run's poses bit for bit, with and
    without the pose-graph back-end in the checkpoint."""
    capacity = 256 if extra else 128  # the back-end keeps 256 observations a keyframe
    ckpt = str(tmp_path / "ck.npz")
    straight, first, second = (str(tmp_path / f"{n}.npz") for n in ("s", "a", "b"))
    rc, want, _ = drive(capsys, "--chunk", "4", "--save-npz", straight, *extra,
                        capacity=capacity)
    assert rc == 0
    # Chunks end at frames 6, 10, 14, ...; a checkpoint falls where
    # (frame - 2) % 8 < 4 at a chunk's end: frame 10, the last of an 11-frame
    # run, so the resumed run's chunks (and keyframes) fall where the
    # straight run's do.
    rc, _, _ = drive(capsys, "--chunk", "4", "--checkpoint", ckpt, "--checkpoint-every", "8",
                     "--save-npz", first, *extra, frames=11, capacity=capacity)
    assert rc == 0
    rc, got, out = drive(capsys, "--chunk", "4", "--resume", ckpt, "--save-npz", second,
                         *extra, capacity=capacity)
    assert rc == 0 and "resumed from" in out and "at frame 10" in out
    a, b = np.load(straight), np.load(second)
    np.testing.assert_array_equal(a["frame_ids"], b["frame_ids"])
    key = "poses_raw" if extra else "poses"
    np.testing.assert_array_equal(a[key], b[key])
    assert got["ate_rmse_m"] == want["ate_rmse_m"]
    if extra:
        assert "pose-graph back-end resumed: 2 nodes" in out  # frames 6 and 10
        assert got["pg_nodes"] == want["pg_nodes"]
        np.testing.assert_array_equal(a["poses"], b["poses"])


def test_pose_graph_registers_nodes(small_city, capsys):
    rc, result, out = drive(capsys, "--spec", "loop", "--pose-graph", "--pg-every", "4",
                            "--chunk", "4", frames=30, capacity=256)
    assert rc == 0
    assert PG_KEYS <= result.keys(), result
    assert result["pg_nodes"] == 6 and result["pg_culled"] == 0  # frames 6, 10, ..., 26
    assert "pose graph: 6 nodes" in out and "ATE RMSE before pose graph" in out
    assert result["ate_rmse_m"] <= 1.05 * result["ate_rmse_m_pre_pg"] + 1e-6


def test_pose_graph_culls_at_capacity(small_city, capsys):
    rc, result, _ = drive(capsys, "--pose-graph", "--pg-every", "2", "--pg-nodes", "4",
                          frames=20, capacity=256)
    assert rc == 0 and result["pg_nodes"] == 4 and result["pg_culled"] >= 3


@pytest.mark.parametrize("argv,word", [
    (["--dataset", "kitti"], "disk loaders"),
    (["--dataset", "parking"], "disk loaders"),
    (["--viz-dir", "x"], "--viz-dir"),
    (["--trajectory-pdf", "x.pdf"], "--trajectory-pdf"),
    (["--map-pdf", "x.pdf"], "--map-pdf"),
    (["--landmarks-pdf", "x.pdf"], "--landmarks-pdf"),
])
def test_unported_flags_exit_2_and_say_why(capsys, argv, word):
    rc = run_vo_torch.main(["--device", "cpu", *argv])
    cap = capsys.readouterr()
    assert rc == 2 and cap.out == ""
    assert word in cap.err and "ROADMAP" in cap.err and "not ported" in cap.err


def test_without_a_gpu_it_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    rc = run_vo_torch.main(["--max-frames", "8"])
    cap = capsys.readouterr()
    assert rc == 2 and cap.out == "" and "--device cpu" in cap.err


def test_too_few_frames_exit_2(small_city, capsys):
    rc = run_vo_torch.main(["--device", "cpu", "--max-frames", "2"])
    assert rc == 2 and "need more than 2 frames" in capsys.readouterr().err


def test_flags_follow_run_vo():
    """Every flag of run_vo.py that the port keeps has the same default."""
    import run_vo

    ours, theirs = vars(run_vo_torch.parse_args([])), vars(run_vo.parse_args([]))
    renamed = {"platform", "no_pallas"}  # --device, --no-kernels
    disk_only = {"data_root", "kitti_sequence", "increment", "no_prefetch"}
    assert set(theirs) - set(ours) == renamed | disk_only
    assert set(ours) - set(theirs) == {"device", "no_kernels", "spec"}
    for name in set(ours) & set(theirs) - {"dataset"}:
        assert ours[name] == theirs[name], name
    assert ours["device"] == "cuda" and ours["dataset"] == "synthetic"


def test_eval_loop_tool(small_city, capsys, tmp_path, monkeypatch):
    """tools/eval_loop_torch.py: a BA-only run, a BA + pose-graph run, both
    re-scored from their saved files."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "eval_loop_torch.py"
    spec = importlib.util.spec_from_file_location("eval_loop_torch", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rc = tool.main(["--device", "cpu", "--chunk", "4", "--pg-every", "4", "--max-frames", "24",
                    "--capacity", "256", "--out-dir", str(tmp_path)])
    assert rc == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"run"')]
    assert [r["run"] for r in rows] == ["loop_ba", "loop_pg"]
    assert "ate_pre_pg_m" in rows[1] and "loops" in rows[1]
    assert abs(rows[0]["ate_rmse_m"] - rows[1]["ate_pre_pg_m"]) < 1e-6  # the same front-end run


@pytest.mark.slow
def test_run_vo_pose_graph_closes_loop_on_mini_circuit(monkeypatch, capsys, tmp_path):
    """The mini closed circuit of tests/test_loop_closure_e2e.py through the
    port at 640x480: the revisit is found and verified, and the Sim(3)
    correction does not hurt."""
    mini = dataclasses.replace(
        tsyn.DEFAULT_SPEC,
        num_frames=312,
        path=tsyn.PathSpec(segments=(
            ("straight", 14.0), ("turn", 90.0, 6.0), ("straight", 10.0), ("turn", 90.0, 6.0),
            ("straight", 14.0), ("turn", 90.0, 6.0), ("straight", 10.0), ("turn", 90.0, 6.0),
            ("straight", 8.0))),
    )
    monkeypatch.setattr(tsyn, "LOOP_SPEC", mini)
    torch.set_num_threads(4)
    try:
        npz = str(tmp_path / "mini_pg.npz")
        rc = run_vo_torch.main(["--device", "cpu", "--spec", "loop", "--chunk", "8", "--quiet",
                                "--pose-graph", "--pg-every", "4", "--pg-min-frame-gap", "120",
                                "--save-npz", npz])
    finally:
        torch.set_num_threads(1)
    out = capsys.readouterr().out
    assert rc == 0
    result = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    assert result["pg_nodes"] >= 20
    assert result["pg_loops"] >= 1, out
    assert result["ate_rmse_m"] <= result["ate_rmse_m_pre_pg"] * 1.05
    assert result["ate_rmse_m"] < 2.0
    loops = json.loads(str(np.load(npz, allow_pickle=True)["loops"]))
    assert any(lp["frame"] - lp["matched_frame"] > 100 for lp in loops), loops
