"""The bootstrap's two-view solve in float64 against the JAX package's
functions in float64.

The port runs the bootstrap's solve (undistortion, 8-point RANSAC -> E ->
cheirality, the pose of camera 1 and the landmark gates:
models/pipeline.py `two_view_f64`, shared with the recovery R, and
`bootstrap_map`) in f64, a named deviation: the JAX package's bootstrap is
f32. Here the JAX functions run under `jax.enable_x64(True)` on the same
numpy inputs (what the port's bootstrap hands its solve), with the same
sample indices (`vo_tpu.ops.ransac.sample_indices`), for each tracker: klt
on the dot world of test_torch_pipeline.py and on a small city from the
port's renderer, harris and sift on that city. The tolerance is that of
tests/test_torch_recovery_f64.py: f64 LAPACK against itself, 1e-8."""

import dataclasses
import sys
from collections import Counter

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

from vo_tpu.geom.lie import pose_inverse as jpose_inverse
from vo_tpu.ops import epipolar as jep
from vo_tpu.ops import ransac as jransac

from vo_tpu_torch.data import synthetic as tsyn
from vo_tpu_torch.models import pipeline as tpipe
from vo_tpu_torch.ops import epipolar as tep
from vo_tpu_torch.ops import ransac as transac
from vo_tpu_torch.utils.config import VOConfig

from test_torch_pipeline import CAPACITY, K_DOTS, N, dot_world  # noqa: F401  (fixture)

torch.set_num_threads(1)

F64_TOL = 1e-8  # f64 LAPACK against itself (tests/test_torch_recovery_f64.py)
KEY = jax.random.PRNGKey(7)
CITY = dataclasses.replace(tsyn.DEFAULT_SPEC, width=320, height=240, focal=208.0)
CITY_CAPACITY = 256
DIST = (-0.05, 0.01, 0.001, -0.001, 0.0)
# (tracker, scene) of each case: the dot world has no texture to describe.
CASES = [("klt", "dots"), ("klt", "city"), ("harris", "city"), ("sift", "city")]


@pytest.fixture(scope="module")
def city():
    seq = tsyn.render_sequence(CITY, torch.device("cpu"), 3)
    return seq.frames, seq.K


def _scene(request, scene):
    """(frame 0, frame 2, K, capacity) of a scene, as torch tensors."""
    if scene == "dots":
        imgs, _ = request.getfixturevalue("dot_world")
        return torch.from_numpy(imgs[0]), torch.from_numpy(imgs[2]), torch.from_numpy(K_DOTS), \
            CAPACITY
    frames, K = request.getfixturevalue("city")
    return frames[0], frames[2], K, CITY_CAPACITY


def _solve_inputs(request, tracker, scene):
    """What the port's bootstrap hands `two_view_f64` (its raw tracks, the
    tracked mask, K), as f32 numpy, and the configuration."""
    img0, img2, K, capacity = _scene(request, scene)
    cfg = VOConfig(capacity=capacity, tracker=tracker)
    real, seen = tpipe.two_view_f64, []

    def keeping(*args, **kw):
        seen.append(args[:4])
        return real(*args, **kw)

    tpipe.two_view_f64 = keeping
    try:
        tpipe.bootstrap(img0, img2, K, cfg, torch.Generator().manual_seed(1))
    finally:
        tpipe.two_view_f64 = real
    [(xy0, xy1, tracked, K)] = seen
    return dict(xy0=N(xy0), xy1=N(xy1), tracked=N(tracked), K=N(K)), cfg


def _indices(tracked, hypotheses):
    """The JAX package's sample indices for KEY, as its RANSAC draws them."""
    with jax.enable_x64(True):
        return np.asarray(jransac.sample_indices(KEY, hypotheses, tracked.shape[-1], 8,
                                                 jnp.asarray(tracked)))


def _jax_f64(fn, *args, **kwargs):
    with jax.enable_x64(True):
        args = [jnp.asarray(a, jnp.float64) if a.dtype.kind == "f" else jnp.asarray(a)
                for a in args]
        return jax.tree_util.tree_map(np.asarray, fn(*args, **kwargs))


def _jax_solve(d, cfg):
    """The JAX package's bootstrap solve (vo_tpu/models/pipeline.py
    `bootstrap`, no lens distortion) in f64: the RANSAC, E, the relative
    pose, the pose of camera 1 and the landmark mask."""
    b, t = cfg.bootstrap, cfg.triangulation

    def solve(xy0, xy1, K):
        res = jep.fundamental_ransac(KEY, xy0, xy1, valid=jnp.asarray(d["tracked"]),
                                     inlier_threshold_px=b.inlier_threshold_px,
                                     num_hypotheses=b.num_hypotheses)
        E = jep.essential_from_fundamental(res.model, K, K)
        rp = jep.relative_pose_from_essential(E, xy0, xy1, K, K, weight=res.inliers)
        depth1 = (rp.T_21[2, :3] @ rp.points1.T) + rp.T_21[2, 3]
        good3d = (res.inliers & rp.good & (rp.points1[:, 2] > t.min_depth)
                  & (rp.points1[:, 2] < t.max_depth) & (depth1 > t.min_depth)
                  & jnp.isfinite(rp.points1).all(axis=1))
        return res, E, rp, jpose_inverse(rp.T_21), good3d

    return _jax_f64(solve, d["xy0"], d["xy1"], d["K"])


def _same_up_to_sign(a, b):
    """F (and E with it) is defined up to sign; two eigensolvers may pick
    either."""
    return b * np.sign((a * b).sum())


@pytest.mark.parametrize("tracker,scene", CASES)
def test_the_bootstraps_solve_in_f64_is_the_jax_packages(request, tracker, scene):
    """On the bootstrap's own tracks: the same inlier mask and count, F (up
    to sign), E, T_21 and the points within F64_TOL; the pose of camera 1
    the f32 rounding of the JAX package's f64 pose, and the same landmarks."""
    d, cfg = _solve_inputs(request, tracker, scene)
    res, E, rp, pose1, good3d = _jax_solve(d, cfg)
    idx = _indices(d["tracked"], cfg.bootstrap.num_hypotheses)
    T = torch.from_numpy
    two = tpipe.two_view_f64(T(d["xy0"]), T(d["xy1"]), T(d["tracked"]), T(d["K"]), cfg,
                             cfg.bootstrap, lambda *_: idx)
    assert two.ransac.model.dtype == two.rel.T_21.dtype == torch.float64
    np.testing.assert_array_equal(N(two.ransac.inliers), res.inliers)
    assert int(two.ransac.num_inliers) == int(res.num_inliers) > cfg.bootstrap.min_inliers
    np.testing.assert_allclose(_same_up_to_sign(res.model, N(two.ransac.model)), res.model,
                               rtol=0, atol=F64_TOL)
    got_E = N(tep.essential_from_fundamental(two.ransac.model, *[T(d["K"]).double()] * 2))
    np.testing.assert_allclose(_same_up_to_sign(E, got_E), E, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(N(two.rel.T_21), rp.T_21, rtol=0, atol=F64_TOL)
    np.testing.assert_array_equal(N(two.rel.good), rp.good)
    inl = res.inliers
    np.testing.assert_allclose(N(two.rel.points1)[inl], rp.points1[inl], rtol=F64_TOL,
                               atol=F64_TOL)

    got_pose, got_points, got_good = tpipe.bootstrap_map(two, cfg)
    assert got_pose.dtype == got_points.dtype == torch.float32
    np.testing.assert_array_equal(N(got_good), good3d)
    assert int(good3d.sum()) > cfg.bootstrap.min_inliers
    # Within half an f32 step of the JAX pose, plus the f64 tolerance.
    half_ulp = np.spacing(np.abs(pose1).astype(np.float32)).astype(np.float64) / 2
    assert (np.abs(N(got_pose).astype(np.float64) - pose1) <= half_ulp + F64_TOL).all()
    np.testing.assert_array_equal(N(got_points), N(two.rel.points1).astype(np.float32))


class _F32OpsInSolve(TorchFunctionMode):
    """Counts, by the calling function, every torch op that gives an f32
    tensor while `two_view_f64` or `bootstrap_map` is on the stack."""

    SOLVE = {"two_view_f64", "bootstrap_map"}

    def __init__(self):
        super().__init__()
        self.callers = Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if any(isinstance(o, torch.Tensor) and o.dtype == torch.float32 for o in outs):
            frame, names = sys._getframe(1), []
            while frame is not None and frame.f_code.co_name != "bootstrap":
                names.append(frame.f_code.co_name)
                frame = frame.f_back
            if self.SOLVE & set(names):
                self.callers[names[0]] += 1
        return out


@pytest.mark.parametrize("tracker,scene,dist", [
    ("klt", "dots", (0.0,) * 5), ("klt", "dots", DIST), ("harris", "city", DIST),
    ("sift", "city", (0.0,) * 5)], ids=["klt", "klt-distorted", "harris-distorted", "sift"])
def test_no_f32_intermediate_on_the_bootstraps_solve(request, tracker, scene, dist):
    """The whole bootstrap run op by op (with a distorted lens, the f64
    undistortion too): inside its solve the only f32 tensors are the
    draw's (the uniforms, Gumbel noise and top-k) and the two it rounds
    back, the pose of camera 1 and the landmarks."""
    img0, img2, K, capacity = _scene(request, scene)
    cfg = VOConfig(capacity=capacity, tracker=tracker, dist=dist)
    with _F32OpsInSolve() as mode:
        tpipe.bootstrap(img0, img2, K, cfg, torch.Generator().manual_seed(1))
    assert set(mode.callers) == {"draw_uniforms", "gumbel_top_k", "top_k", "bootstrap_map"}
    assert mode.callers["bootstrap_map"] == 2 and mode.callers["draw_uniforms"] == 1


@pytest.mark.parametrize("tracker,scene", CASES)
def test_the_bootstrap_returns_f32_and_draws_as_before(request, tracker, scene):
    """The state and outputs keep their f32 dtypes (pose, landmarks,
    last_speed, the window), and the generator ends where one draw of
    (hypotheses, capacity) uniforms leaves it, as in f32: PnP's stream starts where it
    did. The recovery's stream is seeded from it as before."""
    img0, img2, K, capacity = _scene(request, scene)
    cfg = VOConfig(capacity=capacity, tracker=tracker)
    gen = torch.Generator().manual_seed(11)
    want = torch.Generator().manual_seed(11)
    transac.draw_uniforms(want, transac.drawn_hypotheses(cfg.bootstrap.num_hypotheses),
                          capacity)
    st, out = tpipe.bootstrap(img0, img2, K, cfg, gen)
    assert torch.equal(gen.get_state(), want.get_state())
    assert st.rng is gen and torch.equal(st.rec_rng.get_state(),
                                         tpipe.recovery_stream(want).get_state())
    f32 = torch.float32
    assert st.pose.dtype == st.prev_pose.dtype == st.last_speed.dtype == out.pose.dtype == f32
    assert st.table.landmark.dtype == st.table.xy.dtype == st.table.track_pose.dtype == f32
    assert all(t.dtype == f32 for t in st.window if t.is_floating_point())
    assert bool(out.pose_ok) and int(out.num_triangulated) > cfg.bootstrap.min_inliers
    # The map's pose is the rounded f64 pose, its last row exact.
    np.testing.assert_array_equal(N(st.pose)[3], [0, 0, 0, 1])
    np.testing.assert_allclose(np.linalg.norm(N(st.pose)[:3, 3]), 1.0, rtol=1e-6)
