"""The three debug steppers of the port (tools/debug_*_torch.py) against the
JAX tools' own arithmetic: a JAX state of the dot world of
test_torch_pipeline.py is carried across with `state_from_numpy`, and the
same per-frame computation runs on both sides: the candidate gates' kill
counts (exact), the track residuals at GT poses, and the non-finite report.
Then each stepper's entry point on a small city on the CPU."""

import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_pipeline import K_DOTS, dot_world, jax_run  # noqa: F401  (fixtures)
from vo_tpu.geom.lie import pose_inverse as jpose_inverse
from vo_tpu.models.feature_table import STATE_MATCHED
from vo_tpu.models.pipeline import _proj_matrix as jproj, _rays_world as jrays
from vo_tpu.ops.triangulate import reprojection_error as jreproj, triangulate_dlt as jdlt
from vo_tpu.utils.config import VOConfig as JaxConfig
from vo_tpu_torch.data import synthetic as tsyn
from vo_tpu_torch.models import pipeline as tpipe
from vo_tpu_torch.utils.config import VOConfig

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import debug_candidate_gates_torch  # noqa: E402
import debug_sift_nan_torch  # noqa: E402
import debug_track_drift_torch  # noqa: E402

torch.set_num_threads(1)



def _carry(jstate):
    return tpipe.state_from_numpy(jstate, "cpu", torch.Generator())


def _jax_gate_counts(state, K, cfg) -> dict:
    """tools/debug_candidate_gates.py's loop body, as the JAX tool runs it."""
    tcfg = cfg.triangulation
    Kinv = jnp.linalg.inv(K)
    t = state.table
    pose = state.pose
    cand = np.asarray(t.state) == STATE_MATCHED
    track_pose = t.track_pose.reshape(-1, 4, 4)
    ray_s = jrays(track_pose, Kinv, t.track_xy)
    ray_n = jrays(pose, Kinv, t.xy)
    ang = np.arccos(np.clip(np.asarray((ray_s * ray_n).sum(-1)), -1, 1))
    gate_b = cand & (ang >= tcfg.bearing_threshold)
    P_s = jproj(track_pose, K)
    P_n = jproj(pose, K)
    X = jdlt(P_s, P_n, t.track_xy, t.xy)
    T_cw = jpose_inverse(pose)
    z_s = np.asarray(
        (jpose_inverse(track_pose)[:, 2, :3] * X).sum(-1) + jpose_inverse(track_pose)[:, 2, 3])
    z_n = np.asarray((T_cw[2, :3] * X).sum(-1) + T_cw[2, 3])
    r_n = np.asarray(jreproj(P_n, X, t.xy))
    r_s = np.asarray(jreproj(P_s, X, t.track_xy))
    fin = np.asarray(jnp.isfinite(X).all(-1))
    kill_depth = gate_b & fin & ~(
        (z_s > tcfg.min_depth) & (z_n > tcfg.min_depth) & (z_n < tcfg.max_depth))
    ok_depth = gate_b & fin & ~kill_depth
    return dict(
        cand=int(cand.sum()), pass_bear=int(gate_b.sum()), kill_depth=int(kill_depth.sum()),
        kill_rnow=int((ok_depth & (r_n >= tcfg.max_reproj_px)).sum()),
        kill_rstart=int((ok_depth & (r_s >= tcfg.max_reproj_px)).sum()),
        good=int((ok_depth & (r_n < tcfg.max_reproj_px) & (r_s < tcfg.max_reproj_px)).sum()),
        med_r_start=float(np.median(r_s[ok_depth])) if ok_depth.any() else np.nan,
    )


# The dot world moves little between frames: after the step has triangulated
# what it could, its candidates have less parallax than the default bearing
# gate asks for. The tightened gates reach every kill count.
TIGHT = dict(bearing_threshold=0.002, max_reproj_px=0.1, max_depth=40.0)


@pytest.mark.parametrize("frame,gates", [(9, "default"), (6, "tight"), (9, "tight")])
def test_candidate_gate_counts_equal_the_jax_tools(jax_run, frame, gates):
    """Every gate's count exactly; the median start residual within 1e-3 px
    + 1e-3 relative (f32 DLT residuals of a few hundredths of a pixel)."""
    from vo_tpu.utils.config import TriangulationConfig as JaxTri

    from vo_tpu_torch.utils.config import TriangulationConfig

    kw = TIGHT if gates == "tight" else {}
    states, _ = jax_run
    want = _jax_gate_counts(states[frame], jnp.asarray(K_DOTS),
                            JaxConfig(triangulation=JaxTri(**kw)))
    got = debug_candidate_gates_torch.gate_counts(
        _carry(states[frame]), torch.from_numpy(K_DOTS),
        VOConfig(triangulation=TriangulationConfig(**kw)))
    med_w, med_g = want.pop("med_r_start"), got.pop("med_r_start")
    assert got == want
    assert want["cand"] > 0
    if gates == "tight":  # every gate kills some
        assert min(want.values()) > 0, want
    np.testing.assert_allclose(med_g, med_w, rtol=1e-3, atol=1e-3)


def _jax_uid_starts(states, last: int) -> dict:
    """tools/debug_track_drift.py's bookkeeping of when each track started."""
    uid_start = {int(u): 0 for u in np.asarray(states[2].table.uid)}
    for i in range(3, last + 1):
        prev_uids = set(np.asarray(states[i - 1].table.uid).tolist())
        t = states[i].table
        for u in np.asarray(t.uid).tolist():
            if u not in prev_uids:
                uid_start[int(u)] = i
        restarted = np.asarray((t.track_xy == t.xy).all(-1) & (np.asarray(t.state) >= 0))
        for idx in np.nonzero(restarted)[0]:
            uid_start[int(np.asarray(t.uid)[idx])] = i
    return uid_start


@pytest.mark.parametrize("frame", [3, 6, 9])
def test_track_residuals_at_gt_equal_the_jax_tools(dot_world, jax_run, frame):
    """The track starts bookkept alike (exact); the residuals at GT poses of
    every candidate within 1e-2 px + 1e-3 relative (f32 DLT through two
    SVDs); the frame's medians likewise."""
    _, gt = dot_world
    states, _ = jax_run
    want_starts = _jax_uid_starts(states, frame)
    starts = {int(u): 0 for u in states[2].table.uid.tolist()}
    for i in range(3, frame + 1):
        prev = set(np.asarray(states[i - 1].table.uid).tolist())
        debug_track_drift_torch.update_starts(starts, prev, _carry(states[i]).table, i)
    assert starts == want_starts

    t = states[frame].table
    idx = np.array([want_starts.get(int(u), 0) for u in np.asarray(t.uid)], int)
    K = jnp.asarray(K_DOTS)
    P_s, P_n = jproj(jnp.asarray(gt[idx]), K), jproj(jnp.asarray(gt[frame]), K)
    X = jdlt(P_s, P_n, t.track_xy, t.xy)
    w_s, w_n = np.asarray(jreproj(P_s, X, t.track_xy)), np.asarray(jreproj(P_n, X, t.xy))
    table = _carry(states[frame]).table
    g_s, g_n = (r.numpy() for r in debug_track_drift_torch.gt_residuals(
        table, torch.from_numpy(K_DOTS), torch.from_numpy(gt[idx]),
        torch.from_numpy(gt[frame])))
    cand = np.asarray(t.state) == STATE_MATCHED
    assert cand.sum() > 0
    for g, w in ((g_s, w_s), (g_n, w_n)):
        np.testing.assert_array_equal(np.isfinite(g[cand]), np.isfinite(w[cand]))
        ok = cand & np.isfinite(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=1e-3, atol=1e-2)
    rep = debug_track_drift_torch.frame_report(table, torch.from_numpy(K_DOTS), gt,
                                               want_starts, frame)
    m = cand & np.isfinite(w_s)
    assert rep["candidates"] == int(m.sum())
    np.testing.assert_allclose([rep["med_r_start"], rep["med_r_now"]],
                               [np.median(w_s[m]), np.median(w_n[m])], rtol=1e-3, atol=1e-2)


def _jax_nonfinite(state, out) -> dict:
    """tools/debug_sift_nan.py's per-frame report, as the JAX tool makes it."""
    def fin(x):
        return bool(np.isfinite(np.asarray(x)).all())

    lm = np.asarray(state.table.landmark)
    st = np.asarray(state.table.state)
    wlm = np.asarray(state.window.landmark)
    wlv = np.asarray(state.window.lm_valid)
    live = st == 2
    return dict(
        pose_fin=fin(out.pose), win_fin=fin(state.window.kf_pose),
        tbl_lm_nan=int((~np.isfinite(lm).all(-1) & (st == 2)).sum()),
        win_lm_nan=int((~np.isfinite(wlm).all(-1) & wlv).sum()),
        t_norm=float(np.linalg.norm(np.asarray(out.pose)[:3, 3])),
        med_depth=float(np.nanmedian(np.abs(lm[live, 2]))) if live.any() else 0.0,
    )


def _poison(state, out, where: str):
    """The state and output with one component made non-finite."""
    if where == "table_landmark":
        lm = np.array(state.table.landmark)
        lm[int(np.argmax(np.asarray(state.table.state) == 2)), 1] = np.nan
        state = state._replace(table=state.table._replace(landmark=jnp.asarray(lm)))
    elif where == "window_landmark":
        wlm = np.array(state.window.landmark)
        wlm[np.unravel_index(int(np.argmax(np.asarray(state.window.lm_valid))),
                             wlm.shape[:-1])] = np.inf
        state = state._replace(window=state.window._replace(landmark=jnp.asarray(wlm)))
    elif where == "window_kf_pose":
        kf = np.array(state.window.kf_pose)
        kf[-1, 3] = np.nan
        state = state._replace(window=state.window._replace(kf_pose=jnp.asarray(kf)))
    elif where == "pose":
        pose = np.array(out.pose)
        pose[0, 3] = np.nan
        out = out._replace(pose=jnp.asarray(pose))
    return state, out


@pytest.mark.parametrize("where", [None, "table_landmark", "window_landmark",
                                   "window_kf_pose", "pose"])
def test_nonfinite_report_equals_the_jax_tools(jax_run, where):
    """Finite flags and non-finite counts exact, the scale telemetry to
    1e-6; the first non-finite component is the one made so."""
    states, outs = jax_run
    state, out = _poison(states[9], outs[9], where)
    assert bool(np.asarray(state.window.lm_valid).any())
    want = _jax_nonfinite(state, out)
    got = debug_sift_nan_torch.nonfinite_report(
        _carry(state), tpipe.StepOutput(*(torch.from_numpy(np.array(f)) for f in out)))
    assert got.pop("first_nonfinite") == where
    for k in ("t_norm", "med_depth"):
        np.testing.assert_allclose(got.pop(k), want.pop(k), rtol=1e-6, equal_nan=True)
    assert got == want


@pytest.fixture(scope="module")
def small_city(tmp_path_factory):
    root = tmp_path_factory.mktemp("city")
    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, num_frames=12, width=160, height=120,
                               focal=104.0)
    tsyn.generate(str(root / "synthetic"), spec, verbose=False, device="cpu")
    return root


def _last_json(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


@pytest.mark.parametrize("tool", ["track_drift", "candidate_gates", "sift_nan"])
def test_stepper_runs_on_the_cpu(tool, small_city, monkeypatch, capsys, tmp_path):
    """Each stepper's entry point over frames 3-8 of a small city: a report
    a frame from the first asked for, the JSON line naming the device; the
    non-finite stepper's --dump-at checkpoint loads in the port."""
    root = ["--data-root", str(small_city), "--device", "cpu"]
    if tool == "track_drift":
        rc = debug_track_drift_torch.main(["5", "9"] + root)
    elif tool == "candidate_gates":
        rc = debug_candidate_gates_torch.main(["5", "9"] + root)
    else:
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
        rc = debug_sift_nan_torch.main(["--frames", "9", "--dump-at", "5"] + root)
    assert rc == 0
    line = _last_json(capsys.readouterr().out)
    assert line["device"] == "cpu" and line["tool"] == f"debug_{tool}_torch"
    frames = [r["frame"] for r in line["rows"]]
    if tool == "sift_nan":
        assert frames == list(range(3, 9)) and line["first_nonfinite"] is None
        from vo_tpu_torch.utils.checkpoint import load_checkpoint

        state, cfg, _, _ = load_checkpoint(str(tmp_path / "dbg_state_5.npz"), device="cpu")
        assert int(state.frame_idx) == 4 and cfg.tracker == "sift"
    else:
        assert frames and set(frames) <= set(range(5, 9))
