"""`bench_torch.py`, the twin of bench.py, on the CPU at a small size: the
warm-up and the timed rollout make the same draws and leave the bootstrapped
state as it was, the JSON line has bench.py's keys, the reference-sized probe
runs over a KITTI layout written here, and one `vo_step` at KITTI's frame size
(370x1226, KITTI's focal length, capacity 512) agrees with the JAX package's
from the same state with the same RANSAC draws."""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench_torch
from test_torch_pipeline import _replay, render_dots
from vo_tpu.models import pipeline as jpipe
from vo_tpu.utils.config import VOConfig as JaxConfig
from vo_tpu_torch.data import png
from vo_tpu_torch.data import synthetic as tsyn
from vo_tpu_torch.models import pipeline as tpipe
from vo_tpu_torch.utils.config import VOConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SMALL = dict(width=160, height=120, focal=104.0)
SMALL_FRAMES, SMALL_CAPACITY = 12, 256
# KITTI 05's intrinsics (the JAX harness's flagship step, __graft_entry__.py).
KITTI_K = np.array([[707.0912, 0.0, 601.8873], [0.0, 707.0912, 183.1104], [0.0, 0.0, 1.0]],
                   np.float32)
KITTI_H, KITTI_W, KITTI_CAPACITY = 370, 1226, 512


GRAPH_KEYS = {"executor", "graphs", "warm_fps", "capture_s"}


def _bench_py_keys() -> set:
    """The keys of the JSON line bench.py prints (the dict literal passed to
    json.dumps in its main), read from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    line = next(n for n in ast.walk(main) if isinstance(n, ast.Dict))
    return {k.value for k in line.keys}


@pytest.fixture
def small_city(tmp_path):
    """A 12-frame city at 160x120 under <tmp>/synthetic, where
    `Sequence("synthetic")` finds it."""
    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, num_frames=SMALL_FRAMES, **SMALL)
    tsyn.generate(str(tmp_path / "synthetic"), spec, verbose=False, device="cpu")
    return tmp_path


def _leaves(state) -> list:
    return [*state.table, *state.window, *state.pyramid,
            *(getattr(state, f) for f in ("pose", "prev_pose", "frame_idx", "next_uid",
                                          "last_kf_idx", "kf_adaptive", "last_speed"))]


def test_warm_up_and_timed_rollout_are_the_same_run(small_city, monkeypatch):
    """The timed rollout's outputs equal the warm-up's bit for bit, and every
    tensor of the bootstrapped state is as it was after both."""
    seen = {}
    real = bench_torch.warm_and_timed

    def watched(state, stack, K, cfg):
        before = [t.clone() for t in _leaves(state)]
        runs = real(state, stack, K, cfg)
        seen["unchanged"] = all(torch.equal(a, b) for a, b in zip(before, _leaves(state)))
        return runs

    monkeypatch.setattr(bench_torch, "warm_and_timed", watched)
    run = bench_torch.bench_synthetic_full(CPU, str(small_city), capacity=SMALL_CAPACITY)
    assert seen["unchanged"]
    warm, timed = run.rollouts.warm, run.rollouts.timed
    for name in timed._fields:
        assert torch.equal(getattr(warm, name), getattr(timed, name)), name
    steps = SMALL_FRAMES - 3
    assert run.result["frames"] == steps and timed.pose.shape == (steps, 4, 4)
    assert torch.isfinite(timed.pose).all() and not bool(timed.frozen.any())
    assert np.isfinite(list(run.result.values())).all()


def _write_kitti(root: Path, frames: np.ndarray, K: np.ndarray) -> None:
    """A KITTI odometry layout: kitti/05/image_0/%06d.png and calib.txt."""
    seq = root / "kitti" / "05"
    (seq / "image_0").mkdir(parents=True)
    for i, img in enumerate(frames):
        png.write_png(str(seq / "image_0" / f"{i:06d}.png"), img.astype(np.uint8))
    P = np.hstack([K.astype(np.float64), np.zeros((3, 1))])
    (seq / "calib.txt").write_text("P0: " + " ".join(f"{v:.12e}" for v in P.reshape(-1)) + "\n")


def test_main_prints_bench_py_keys(small_city, capsys, monkeypatch):
    """The JSON line has bench.py's keys; without the KITTI layout the probe's
    figures are null and `kitti_probe` names the missing path; with a 6-frame
    layout (written here) the probe runs its ping-ponged steps (12 here, past
    the turn back at frame 5 and the one forward at frame 1) twice with the
    same draws, and fills them. The city runs at capacity 256 here."""
    monkeypatch.setattr(bench_torch, "SYNTHETIC_CAPACITY", SMALL_CAPACITY)
    rc = bench_torch.main(["--device", "cpu", "--data-root", str(small_city),
                           "--kitti-root", str(small_city / "absent")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    # Besides bench.py's keys: what the timed rollout ran, the eager
    # warm-up's frames/s and the capture's seconds.
    assert set(line) == _bench_py_keys() | {"kitti_probe"} | GRAPH_KEYS
    assert line["executor"] == "eager" and line["capture_s"] == 0.0 and line["warm_fps"] > 0
    assert line["kitti05_sized_fps"] is None and line["vs_baseline"] is None
    assert "absent" in line["kitti_probe"] and line["device"] == "cpu"
    assert line["metric"] == "vo_full_sequence_600_frames" and line["unit"] == "frames/s"
    assert line["frames"] == SMALL_FRAMES - 3 and line["capacity"] == SMALL_CAPACITY

    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, num_frames=6, **SMALL)
    _write_kitti(small_city / "kitti_root", tsyn.render_sequence(spec, CPU).frames.numpy(),
                 spec.K())
    probes = []
    real = bench_torch.bench_kitti_probe

    def recorded(*a, **kw):
        probes.append(real(*a, **kw))
        return probes[-1]

    monkeypatch.setattr(bench_torch, "bench_kitti_probe", recorded)
    monkeypatch.setattr(bench_torch, "KITTI_STEPS", 12)
    rc = bench_torch.main(["--device", "cpu", "--data-root", str(small_city),
                           "--kitti-root", str(small_city / "kitti_root")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and set(line) == _bench_py_keys() | GRAPH_KEYS
    (fps, runs), = probes
    assert line["kitti05_sized_fps"] == round(fps, 3) > 0
    assert line["vs_baseline"] == round(fps / bench_torch.BASELINE_FPS, 3)
    assert runs.timed.pose.shape == (12, 4, 4)
    assert torch.isfinite(runs.timed.pose).all() and not bool(runs.timed.frozen.any())
    assert torch.equal(runs.warm.pose, runs.timed.pose)


def test_main_refuses_to_run_without_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert bench_torch.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# One step at KITTI's frame size against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kitti_sized_run():
    """The random-dot world of test_torch_pipeline.py at 370x1226 under
    KITTI's intrinsics; the JAX pipeline's bootstrap (frames 0, 2) and its
    steps on frames 3 and 4 (frame 4 pushes a keyframe and runs BA). Every
    pyramid level past the first has an odd side (185x613, 93x307, 47x154)."""
    rng = np.random.default_rng(2023)
    pts = rng.uniform([-25, -15, 2], [25, 15, 60], (6000, 3)).astype(np.float32)
    imgs = []
    for i in range(5):
        yaw = 0.015 * i
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                        [-np.sin(yaw), 0, np.cos(yaw)]]
        pose[:3, 3] = [0.1 * i, 0.0, 0.55 * i]
        imgs.append(render_dots(KITTI_K, np.linalg.inv(pose), pts, KITTI_H, KITTI_W, rng))
    cfg = JaxConfig(capacity=KITTI_CAPACITY)
    K = jnp.asarray(KITTI_K)
    state, _ = jpipe.bootstrap(jnp.asarray(imgs[0]), jnp.asarray(imgs[2]), K, cfg,
                               jax.random.PRNGKey(1))
    states, outs = {2: state}, {}
    for i in (3, 4):
        state, outs[i] = jpipe.vo_step(state, jnp.asarray(imgs[i]), K, cfg)
        states[i] = state
    return np.stack(imgs), states, outs


@pytest.mark.parametrize("frame", [3, 4])
def test_one_step_at_kitti_size_from_a_jax_state(kitti_sized_run, frame):
    """One vo_step from the JAX state of the previous frame with the JAX
    step's own RANSAC draws replayed, at the tolerances of
    test_torch_pipeline.py: pose 1e-4, table positions 1e-3 px."""
    imgs, states, outs = kitti_sized_run
    prev, jst, want = states[frame - 1], states[frame], outs[frame]
    _, k_pnp, k_rec = jax.random.split(prev.rng, 3)
    st = tpipe.state_from_numpy(prev, "cpu", _replay([k_pnp]), _replay([k_rec]))
    st, out = tpipe.vo_step(st, torch.from_numpy(imgs[frame]), torch.from_numpy(KITTI_K),
                            VOConfig(capacity=KITTI_CAPACITY))
    assert [p.shape[-2:] for p in st.pyramid] == [(370, 1226), (185, 613), (93, 307),
                                                    (47, 154)]
    assert bool(want.pose_ok) and bool(out.pose_ok)
    assert int(st.last_kf_idx) == int(jst.last_kf_idx)
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(want.pose), atol=1e-4)
    for name in ("num_tracked", "num_pnp_inliers", "num_triangulated", "num_new_landmarks"):
        assert abs(int(getattr(out, name)) - int(getattr(want, name))) <= 1, name
    np.testing.assert_array_equal(st.table.state.numpy(), np.asarray(jst.table.state))
    live = np.asarray(jst.table.state) >= 0
    np.testing.assert_allclose(st.table.xy.numpy()[live], np.asarray(jst.table.xy)[live],
                               atol=1e-3)
