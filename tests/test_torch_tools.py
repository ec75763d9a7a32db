"""The port's measurement tools on the CPU at tiny repeats: the roofline
(tools/roofline_torch.py), the part-by-part profile (profile_all_torch.py),
the solver bench (bench_solvers_torch.py) and the pose-graph bench
(bench_pg_torch.py). Each runs once, gives its rows by name with finite
values, leaves every device column empty (a CPU run measures no card), and
refuses to run without a GPU unless asked for the CPU; the solver pairs
agree. Every other tool twin refuses alike (tests/test_torch_ablate.py and
test_torch_debug_tools.py run them on the CPU)."""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import ablate_keyframes_torch  # noqa: E402
import ablate_step_cost_torch  # noqa: E402
import bench_pg_torch  # noqa: E402
import bench_solvers_torch  # noqa: E402
import check_headline_torch  # noqa: E402
import check_kernels_cuda  # noqa: E402
import debug_candidate_gates_torch  # noqa: E402
import debug_sift_nan_torch  # noqa: E402
import debug_track_drift_torch  # noqa: E402
import loop_edges_torch  # noqa: E402
import probe_ablate_torch  # noqa: E402
import profile_all_torch  # noqa: E402
import repro_headline_torch  # noqa: E402
import roofline_torch  # noqa: E402
from vo_tpu_torch.data import synthetic as tsyn  # noqa: E402
from vo_tpu_torch.utils.config import VOConfig  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOOLS = [roofline_torch, profile_all_torch, bench_solvers_torch, bench_pg_torch,
         check_headline_torch, probe_ablate_torch, ablate_step_cost_torch,
         ablate_keyframes_torch, repro_headline_torch, debug_track_drift_torch,
         debug_candidate_gates_torch, debug_sift_nan_torch, check_kernels_cuda]


def _last_json(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__)
def test_tool_refuses_to_run_without_a_gpu(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert tool.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_roofline_rows(capsys):
    """roofline.py's five parts plus the two kernels, with the shapes of
    VOConfig() (4 LK levels where roofline.py has 3); the byte/operation
    models and bounds are finite and positive, the times null on the CPU."""
    assert roofline_torch.main(["--device", "cpu", "--reps", "1"]) == 0
    line = _last_json(capsys.readouterr().out)
    cfg = VOConfig()
    assert line["device"] == "cpu"
    assert [r["kernel"] for r in line["rows"]] == [
        "detect(shi_tomasi+nms+top1024)", "K1 corner_response_nms (kernel)",
        f"pyramidal_lk(1024pts,{cfg.klt.pyramid_levels}lvl,{cfg.klt.max_iters}it)",
        "K2 extract_patch_pairs level 0 (kernel)", "match_descriptors(1024x361)",
        "pnp_ransac(256hyp+10gn)", "ba_gn_iter(W=6,L=1024)"]
    for r in line["rows"]:
        assert r["ms"] is None and r["sol_pct"] is None and r["timed_by"] == "cpu"
        assert np.isfinite([r["mbytes"], r["mflops"], r["bound_ms"]]).all()
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
    # The kernel rows carry chip_smoke.py's models: K1 reads and writes one
    # 640x480 f32 map, the pair writes 1024 patches of 21 and of 35.
    k1, k2 = line["rows"][1], line["rows"][3]
    assert k1["mbytes"] == pytest.approx(2 * 480 * 640 * 4 / 1e6)
    assert k2["mflops"] == 0 and k2["bound_by"] == "bytes"


def test_profile_rows(tmp_path, capsys, monkeypatch):
    """Every part by name on a 6-frame 160x120 city (capacity 256 and
    4-frame rollouts here), host times finite, device columns null; the
    KITTI layout reads through the same frame reader."""
    monkeypatch.setattr(profile_all_torch, "CAPACITY", 256)
    monkeypatch.setattr(profile_all_torch, "ROLLOUT_STEPS", 4)
    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, num_frames=6, width=160, height=120,
                               focal=104.0)
    tsyn.generate(str(tmp_path / "synthetic"), spec, verbose=False, device="cpu")
    assert profile_all_torch.main(["--device", "cpu", "--data-root", str(tmp_path),
                                   "--reps", "1"]) == 0
    line = _last_json(capsys.readouterr().out)
    assert line["device"] == "cpu" and line["frame"] == [120, 160]
    assert [r["name"] for r in line["rows"]] == [
        "noop x + 1.0", "vo_step (ba on)", "vo_step (ba off)", "build_pyramid",
        "pyramidal_lk 256pts", "corner_response_nms (K1)", "select_from_masked top256",
        "detect (K1 + top256)", "pnp_ransac 256hyp", "triangulate_dlt 256",
        "ba_refine 5 iters", "match_descriptors 256x361", "rollout 4f (ba off)",
        "rollout 4f (ba on)"]
    for r in line["rows"]:
        assert np.isfinite(r["host_ms"]) and r["host_ms"] > 0, r
        assert r["device_ms"] is None and "device_idle_share" not in r, r
    assert all(np.isfinite(r["fps"]) for r in line["rows"][-2:])
    # The rollouts' idle share comes from the runner's spans, on the card only.
    assert all(r["device_idle_pct"] is None for r in line["rows"][-2:])

    kitti = tmp_path / "kitti" / "05"
    (kitti / "image_0").mkdir(parents=True)
    for i, src in enumerate(sorted((tmp_path / "synthetic" / "images").iterdir())):
        (kitti / "image_0" / f"{i:06d}.png").write_bytes(src.read_bytes())
    P = np.hstack([spec.K().astype(np.float64), np.zeros((3, 1))])
    (kitti / "calib.txt").write_text("P0: " + " ".join(f"{v:.9e}" for v in P.ravel()) + "\n")
    frames, K = profile_all_torch.read_frames("kitti", str(tmp_path), CPU)
    want, _ = profile_all_torch.read_frames("synthetic", str(tmp_path), CPU)
    assert torch.equal(frames, want) and np.array_equal(K, spec.K())


def test_solver_pairs_agree():
    """The blocked Cholesky and the step's own solve (`kernels.ba_solve`,
    the blocked Cholesky on the CPU) against torch.linalg.solve on the demo
    window (W = 6, L = 1024): the GN step's poses and landmarks within 1e-4
    of each other (relative, max norm), the ten PnP solves likewise."""
    out = bench_solvers_torch.bench(CPU, reps=1)
    assert out["ba_pose_rel_diff"] < 1e-4 and out["ba_landmark_rel_diff"] < 1e-4
    assert out["ba_kernel_pose_rel_diff"] < 1e-4 and out["ba_kernel_landmark_rel_diff"] < 1e-4
    assert out["ba_kernel_pose_rel_diff"] == out["ba_pose_rel_diff"]  # the CPU's solve is (b)
    assert out["pnp_solve_rel_diff"] < 1e-4
    # The camera system itself carries the 1e8 gauge pivot: f32's condition.
    assert out["ba_solve_rel_diff"] < 1e-3 and out["ba_kernel_solve_rel_diff"] < 1e-3
    times = [v for k, v in out.items() if k.endswith("_ms")]
    assert len(times) == 5 and np.isfinite(times).all() and min(times) > 0


def test_pose_graph_bench():
    """A 32-node circuit with its loop edges: the error falls, and the
    edge-sharded optimizer at one rank (Gloo) equals pg_optimize bit for bit."""
    out = bench_pg_torch.bench(CPU, nodes=32, iters=4)
    assert out["nodes"] == 32 and out["loop_edges"] == bench_pg_torch.LOOP_EDGES
    assert np.isfinite([out["err0"], out["err_last"], out["first_s"], out["second_s"]]).all()
    assert out["err_last"] < out["err0"]
    assert out["dist_ranks"] == 1 and out["dist_backend"] == "gloo" and out["dist_equal"]
    assert not torch.distributed.is_initialized()


def test_chip_smoke_holds_the_step_eigh_to_torch_linalg():
    """chip_smoke.py's DLT gate on a 160x120 city: the step's eigh is held
    to torch.linalg.eigh on its own systems for the first calls of an eager
    rollout from the bootstrap (here both routes are LAPACK, so equal), the
    finite systems counted; the rollout's outputs are those without the
    hook, and the step's eigh is put back after."""
    import chip_smoke
    from vo_tpu_torch.models import pipeline

    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, width=160, height=120, focal=104.0)
    seq = tsyn.render_sequence(spec, CPU, 7)
    cfg = VOConfig(capacity=256)
    state = pipeline.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                               torch.Generator().manual_seed(3))[0]
    rewind = pipeline.rewinder(state)
    _, plain = pipeline.vo_rollout(state, seq.frames[3:], seq.K, cfg)
    rewind()
    real = pipeline.eigh_finite
    with chip_smoke._dlt_held_to_torch_linalg(2) as calls:
        _, held = pipeline.vo_rollout(state, seq.frames[3:], seq.K, cfg)
    assert pipeline.eigh_finite is real
    assert [c["shape"] for c in calls] == [[1, 256, 4, 4]] * 2
    assert all(c["equal"] and c["max_abs"] == 0.0 and c["finite"] > 0 for c in calls)
    for name, x, y in zip(plain._fields, plain, held):
        assert torch.equal(x, y), name


def test_chip_smoke_runs_the_city_whole_by_default():
    """The harris, multiseq and data (c) phases run the 600-frame city by
    default, the length at which their ATE gates (and harris's gate that R
    ran) apply."""
    import chip_smoke

    args = chip_smoke._parser().parse_args([])
    assert args.harris_frames == args.multiseq_frames == args.data_frames == 600
    assert chip_smoke.CITY_FRAMES == 600 == tsyn.DEFAULT_SPEC.num_frames


def test_chip_smoke_reruns_the_recovery_on_its_kept_inputs():
    """chip_smoke.py's card-against-CPU check of the recovery R, with both
    sides on the CPU: on the city with PnP's bar out of reach every frame
    falls back to R; its inputs and drawn uniforms are kept from an eager
    rollout, and R run again on them gives the step's own results and no
    difference between the sides (angle and translation exactly 0, the same
    inlier counts, both take R's pose). At 320x240 R finds the inliers to be
    taken (at 160x120 it finds 13-22 of the 30 it needs). The rollout's
    outputs are those without the hook, and R is put back after."""
    import chip_smoke
    from vo_tpu_torch.models import pipeline

    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, width=320, height=240, focal=208.0)
    seq = tsyn.render_sequence(spec, CPU, 5)
    cfg = VOConfig(capacity=256)
    cfg = dataclasses.replace(cfg, pnp=dataclasses.replace(cfg.pnp, min_inliers=10**6))
    state = pipeline.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                               torch.Generator().manual_seed(1))[0]
    rewind = pipeline.rewinder(state)
    _, plain = pipeline.vo_rollout(state, seq.frames[3:], seq.K, cfg)
    rewind()
    real = pipeline.recover_pose
    with chip_smoke._recovery_inputs_kept(2) as kept:
        _, held = pipeline.vo_rollout(state, seq.frames[3:], seq.K, cfg)
    assert pipeline.recover_pose is real
    for name, x, y in zip(plain._fields, plain, held):
        assert torch.equal(x, y), name
    assert not bool(plain.pose_ok.any()) and len(kept) == 2
    records = chip_smoke._r_card_vs_cpu(kept)
    assert len(records) == 2
    for rec in records:
        assert rec["angle_deg"] == 0.0 and rec["trans_m"] == 0.0, rec
        assert rec["inliers_card"] == rec["inliers_cpu"] > 0, rec
        assert rec["took_card"] and rec["took_cpu"] and rec["finite"], rec
        assert rec["card_equals_step"], rec


def test_chip_smoke_gates_the_recovery_card_against_cpu():
    """harris (c) is a gate: R on the card and on the CPU (float64 on both)
    must count the same inliers, take the same decision, lie within 1e-3
    degree and 1e-3 m, be finite, and the card's rerun must be the step's
    own R. A record as float32 R gave on the city's second turn fails it;
    phase_harris applies it to every held frame."""
    import inspect

    import chip_smoke

    same = dict(angle_deg=2e-6, trans_m=3e-7, speed_m=3.9526, inliers_card=262,
                inliers_cpu=262, took_card=True, took_cpu=True, finite=True,
                card_equals_step=True, frame=395)
    assert chip_smoke._r_card_vs_cpu_fails([same, dict(same, frame=396)]) == []
    parted = dict(same, angle_deg=0.2905, trans_m=0.4165, inliers_cpu=266)
    assert len(chip_smoke._r_card_vs_cpu_fails([same, parted])) == 2
    for change in (dict(inliers_cpu=261), dict(took_cpu=False),
                   dict(angle_deg=2 * chip_smoke.R_CARD_CPU_DEG),
                   dict(trans_m=2 * chip_smoke.R_CARD_CPU_M), dict(angle_deg=None),
                   dict(finite=False), dict(card_equals_step=False)):
        assert len(chip_smoke._r_card_vs_cpu_fails([dict(same, **change)])) == 1, change
    assert chip_smoke.R_CARD_CPU_DEG == 1e-3 and chip_smoke.R_CARD_CPU_M == 1e-3
    assert ("fails += _r_card_vs_cpu_fails(line[\"R_card_vs_cpu\"])"
            in inspect.getsource(chip_smoke.phase_harris))


def test_chip_smoke_reruns_the_bootstrap_on_its_kept_inputs():
    """The bootstraps' records, with both sides on the CPU: two bootstraps,
    the second through a distorted lens, draw their uniforms through the
    hook on the shared two-view solve (pipeline.two_view_f64) and give the
    bits they give without it (state, outputs and generator); a third one,
    beyond the records asked for, and the recovery's calls are let
    through. The kept inputs run again give no difference between the
    sides and the run's own solve, and pass the gate. The solve is put back
    after."""
    import chip_smoke
    from vo_tpu_torch.models import pipeline

    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, width=160, height=120, focal=104.0)
    dspec = dataclasses.replace(spec, dist=tsyn.DISTORTED_DIST)
    cfg = VOConfig(capacity=256)
    runs = [(tsyn.render_sequence(spec, CPU, 3), cfg, 3),
            (tsyn.render_sequence(dspec, CPU, 3),
             dataclasses.replace(cfg, dist=tsyn.DISTORTED_DIST), 4),
            (tsyn.render_sequence(spec, CPU, 3), cfg, 5)]

    def boot(seq, c, seed):
        gen = torch.Generator().manual_seed(seed)
        return pipeline.bootstrap(seq.frames[0], seq.frames[2], seq.K, c, gen), gen

    plain = [boot(*run) for run in runs]
    real = pipeline.two_view_f64
    with chip_smoke._bootstrap_inputs_kept(2) as kept:
        held = [boot(*run) for run in runs]
    assert pipeline.two_view_f64 is real and len(kept) == 2
    for ((p_state, p_out), p_gen), ((h_state, h_out), h_gen) in zip(plain, held):
        assert torch.equal(p_gen.get_state(), h_gen.get_state())
        for x, y in zip(p_out, h_out):
            assert torch.equal(x, y)
        for x, y in zip(p_state.table, h_state.table):
            assert torch.equal(x, y)
    assert kept[1]["cfg"].dist == tsyn.DISTORTED_DIST and not kept[1]["ideal1"]
    records = chip_smoke._bootstrap_card_vs_cpu(kept, ["plain", "distorted"])
    assert [rec["bootstrap"] for rec in records] == ["plain", "distorted"]
    for rec in records:
        assert rec["angle_deg"] == 0.0 and rec["trans_m"] == 0.0, rec
        assert rec["inliers_card"] == rec["inliers_cpu"] > 0 and rec["masks_equal"], rec
        assert rec["good_card"] == rec["good_cpu"] > 0 and rec["card_equals_run"], rec
        assert rec["pose_bits_equal"] and rec["good_masks_equal"] and rec["finite"], rec
    assert chip_smoke._bootstrap_card_vs_cpu_fails(records) == []


def test_chip_smoke_gates_the_bootstrap_card_against_cpu():
    """The bootstrap's card-against-CPU record is a gate, at R's limits
    (R_CARD_CPU_DEG, R_CARD_CPU_M of the unit baseline): equal inlier
    counts and masks, equal landmark counts, both poses finite, the card's
    rerun the run's own solve. A record as the float32 bootstrap gave on
    the headline's frames fails it; the headline, multiseq (six lanes and
    the distorted lens) and harris each hold their bootstraps to it."""
    import inspect

    import chip_smoke

    same = dict(bootstrap="headline", angle_deg=0.0, trans_m=0.0, pose_bits_equal=True,
                inliers_card=240, inliers_cpu=240, masks_equal=True, good_card=238,
                good_cpu=238, good_masks_equal=True, finite=True, card_equals_run=True)
    assert chip_smoke._bootstrap_card_vs_cpu_fails([same, dict(same, bootstrap="city")]) == []
    f32 = dict(same, angle_deg=0.0016, trans_m=0.00038, good_card=237)
    assert len(chip_smoke._bootstrap_card_vs_cpu_fails([f32])) == 2
    for change in (dict(inliers_cpu=239), dict(masks_equal=False), dict(good_cpu=237),
                   dict(angle_deg=2 * chip_smoke.R_CARD_CPU_DEG),
                   dict(trans_m=2 * chip_smoke.R_CARD_CPU_M), dict(angle_deg=None),
                   dict(trans_m=None), dict(finite=False), dict(card_equals_run=False)):
        assert len(chip_smoke._bootstrap_card_vs_cpu_fails([dict(same, **change)])) == 1, \
            change
    assert chip_smoke.R_CARD_CPU_DEG == 1e-3 and chip_smoke.R_CARD_CPU_M == 1e-3
    held = {phase: inspect.getsource(fn).count("_bootstraps_held(")
            for phase, fn in (("headline", chip_smoke.phase_headline),
                              ("multiseq", chip_smoke.phase_multiseq),
                              ("harris", chip_smoke.phase_harris))}
    assert held == {"headline": 1, "multiseq": 1, "harris": 1}
    assert "fails += _bootstrap_card_vs_cpu_fails(held)" in inspect.getsource(
        chip_smoke._bootstraps_held)
    fails = []
    chip_smoke._bootstraps_held("headline", [], ["headline"], fails)
    assert fails == ["kept 0 bootstraps, want 1 (['headline'])"]


def test_loop_edges_scores_a_planted_edge():
    """`loop_edges_torch.edge_errors` on a planted circuit whose map runs at
    2 units a metre at the old keyframe and 1.6 at the new one: the true
    edge scores 0 degree, 0 degree, length 1 and scale 1; an edge turned
    10 degrees off in direction scores that, and one twice as long 2."""
    def pose(x, yaw):
        c, s = np.cos(yaw), np.sin(yaw)
        P = np.eye(4)
        P[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        P[0, 3] = x
        return P

    gt = {0: pose(0, 0), 16: pose(1, 0), 200: pose(3, 0.3), 216: pose(4, 0.3)}
    units = {0: 2.0, 16: 2.0, 200: 1.6, 216: 1.6}  # map units a metre
    est = [pose(gt[f][0, 3] * units[f], 0.3 if f >= 200 else 0.0) for f in gt]
    frames = np.array(list(gt))
    true = np.linalg.inv(gt[0]) @ gt[200]
    rel = true.copy()
    rel[:3, 3] *= 2.0  # in the old map's units
    rel[:3, :3] *= 2.0 / 1.6  # s_old / s_new
    c, s = np.cos(np.radians(10)), np.sin(np.radians(10))
    turned = rel.copy()
    turned[:3, 3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ rel[:3, 3]
    longer = rel.copy()
    longer[:3, 3] *= 2.0
    rels = np.stack([rel, turned, longer, rel]).reshape(4, 16)
    out = loop_edges_torch.edge_errors(np.array([[0, 2]] * 4), rels,
                                       np.array([True, True, True, False]), frames,
                                       np.stack(est).reshape(4, 16), gt.__getitem__)
    assert len(out) == 3 and [o[:2] for o in out] == [[200, 0]] * 3
    np.testing.assert_allclose(out[0][2:], [0.0, 0.0, 1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(out[1][2:], [0.0, 10.0, 1.0, 1.0], atol=1e-5)
    np.testing.assert_allclose(out[2][2:], [0.0, 0.0, 2.0, 1.0], atol=1e-6)
