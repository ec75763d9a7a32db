"""The recovery R in float64 against the JAX package's functions in float64.

The port runs R (8-point RANSAC -> E -> cheirality, models/pipeline.py
::recover_pose) in f64 from its inputs to its pose, a named deviation: the
JAX package's R is f32. Here the JAX functions run under
`jax.enable_x64(True)` on the same numpy inputs, with the same sample
indices (`vo_tpu.ops.ransac.sample_indices`), on the dot world's tracks.
Those tracks are ill-conditioned for the 8-point refit: the two smallest
eigenvalues of its normal matrix lie about 1e-6 of the largest apart, and
in f32 the JAX package's F and the port's part by about 0.04 on the same
tracks (two LAPACKs). In f64 the two LAPACKs agree to 1e-10: the
tolerance here is 1e-8, that of f64 LAPACK against itself on such a
system (its condition number times 1e-16, with room)."""

import dataclasses
import sys

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

from vo_tpu.geom.lie import pose_inverse as jpose_inverse
from vo_tpu.ops import epipolar as jep
from vo_tpu.ops import ransac as jransac

from vo_tpu_torch.geom.points import normalize_points, to_homogeneous
from vo_tpu_torch.models import pipeline as tpipe
from vo_tpu_torch.ops import epipolar as tep
from vo_tpu_torch.ops import ransac as transac
from vo_tpu_torch.utils.config import VOConfig

from test_torch_pipeline import CAPACITY, K_DOTS, N, dot_world  # noqa: F401  (fixture)

torch.set_num_threads(1)

F64_TOL = 1e-8  # f64 LAPACK against itself on the dot world's systems
CFG = VOConfig(capacity=CAPACITY)
THRESHOLD = CFG.recovery.inlier_threshold_px
HYPOTHESES = CFG.recovery.num_hypotheses
KEY = jax.random.PRNGKey(5)


@pytest.fixture(scope="module")
def r_inputs(dot_world):
    """What R reads at frames 3 and 4 of the dot world, as f32 numpy: the
    port's bootstrap on frames 0 and 2, then its step's front end (A)."""
    imgs, _ = dot_world
    K = torch.from_numpy(K_DOTS)
    st, _ = tpipe.bootstrap(torch.from_numpy(imgs[0]), torch.from_numpy(imgs[2]), K, CFG,
                            torch.Generator().manual_seed(1))
    out = {}
    for frame in (3, 4):
        a = tpipe.step_track(st, torch.from_numpy(imgs[frame]), K, CFG)
        out[frame] = dict(prev_xy=N(st.table.xy), xy_u=N(a.xy_u), tracked=N(a.tracked),
                          pose=N(st.pose), last_speed=N(st.last_speed))
        st, _ = tpipe.vo_step(st, torch.from_numpy(imgs[frame]), K, CFG)
    return out


def _indices(tracked):
    """The JAX package's sample indices for KEY, as its RANSAC draws them."""
    with jax.enable_x64(True):
        return np.asarray(jransac.sample_indices(KEY, HYPOTHESES, tracked.shape[-1], 8,
                                                 jnp.asarray(tracked)))


def _jax_f64(fn, *args, **kwargs):
    with jax.enable_x64(True):
        args = [jnp.asarray(a, jnp.float64) if a.dtype.kind == "f" else jnp.asarray(a)
                for a in args]
        return jax.tree_util.tree_map(np.asarray, fn(*args, **kwargs))


def _f64(*xs):
    return [torch.from_numpy(np.asarray(x, np.float64)) for x in xs]


def _same_up_to_sign(a, b):
    """F is defined up to sign, and the two eigensolvers may pick either."""
    return b * np.sign((a * b).sum())


@pytest.mark.parametrize("frame", [3, 4])
def test_the_8_point_ransac_in_f64_is_the_jax_packages(r_inputs, frame):
    d = r_inputs[frame]
    prev, xy, tracked = d["prev_xy"], d["xy_u"], d["tracked"]
    # The refit's system is nearly degenerate: f32 cannot resolve its null
    # vector (eps32 / gap ~ 0.1), f64 can (eps64 / gap ~ 1e-10).
    w = torch.from_numpy(tracked.astype(np.float64))
    h1, h2 = (to_homogeneous(normalize_points(p, w)[0]) for p in _f64(prev, xy))
    A = (h2[:, :, None] * h1[:, None, :]).flatten(-2) * w[:, None]
    ev = N(torch.linalg.eigvalsh(A.T @ A))
    assert (ev[1] - ev[0]) / ev[-1] < 1e-5

    want = _jax_f64(jep.fundamental_ransac, KEY, prev, xy, valid=tracked,
                    inlier_threshold_px=THRESHOLD, num_hypotheses=HYPOTHESES)
    idx = _indices(tracked)
    got = tep.fundamental_ransac(lambda *_: idx, *_f64(prev, xy),
                                 valid=torch.from_numpy(tracked),
                                 inlier_threshold_px=THRESHOLD, num_hypotheses=HYPOTHESES)
    assert got.model.dtype == torch.float64
    np.testing.assert_array_equal(N(got.inliers), want.inliers)
    assert int(got.num_inliers) == int(want.num_inliers) > 8
    np.testing.assert_allclose(_same_up_to_sign(want.model, N(got.model)), want.model,
                               rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("frame", [3, 4])
def test_the_relative_pose_in_f64_is_the_jax_packages(r_inputs, frame):
    """The same E (the JAX package's, from its f64 RANSAC) decomposed and
    voted on by both: T_21, the cheirality mask and the points."""
    d = r_inputs[frame]
    prev, xy, tracked = d["prev_xy"], d["xy_u"], d["tracked"]
    F = _jax_f64(jep.fundamental_ransac, KEY, prev, xy, valid=tracked,
                 inlier_threshold_px=THRESHOLD, num_hypotheses=HYPOTHESES)
    E = _jax_f64(jep.essential_from_fundamental, F.model, K_DOTS, K_DOTS)
    got_E = tep.essential_from_fundamental(*_f64(F.model, K_DOTS, K_DOTS))
    np.testing.assert_allclose(N(got_E), E, rtol=0, atol=F64_TOL)
    want = _jax_f64(jep.relative_pose_from_essential, E, prev, xy, K_DOTS, K_DOTS,
                    weight=F.inliers)
    got = tep.relative_pose_from_essential(*_f64(E, prev, xy, K_DOTS, K_DOTS),
                                           weight=torch.from_numpy(F.inliers))
    assert got.T_21.dtype == got.points1.dtype == torch.float64
    np.testing.assert_allclose(N(got.T_21), want.T_21, rtol=0, atol=F64_TOL)
    np.testing.assert_array_equal(N(got.good), want.good)
    np.testing.assert_allclose(N(got.points1)[F.inliers], want.points1[F.inliers],
                               rtol=F64_TOL, atol=F64_TOL)


def _jax_recovery(prev, xy, tracked, pose, last_speed):
    """The JAX package's R (vo_tpu/models/pipeline.py, `_visual_rel`) in
    f64: R's pose and its inlier count."""

    def r(prev, xy, K, pose, speed):
        res = jep.fundamental_ransac(KEY, prev, xy, valid=jnp.asarray(tracked),
                                     inlier_threshold_px=THRESHOLD,
                                     num_hypotheses=HYPOTHESES)
        E = jep.essential_from_fundamental(res.model, K, K)
        rp = jep.relative_pose_from_essential(E, prev, xy, K, K, weight=res.inliers)
        T21 = rp.T_21.at[:3, 3].set(rp.T_21[:3, 3] * speed)
        return pose @ jpose_inverse(T21), res.num_inliers

    return _jax_f64(r, prev, xy, K_DOTS, pose, last_speed)


@pytest.mark.parametrize("frame", [3, 4])
def test_the_recovery_in_f64_is_the_jax_packages(r_inputs, frame):
    """R as a whole (`recover_pose`, one lane, PnP's pose lost): its f32
    pose is the f32 rounding of the JAX package's f64 pose to within
    F64_TOL, with the same inlier count, and R's pose is taken."""
    d = r_inputs[frame]
    want_pose, want_inliers = _jax_recovery(d["prev_xy"], d["xy_u"], d["tracked"],
                                            d["pose"], d["last_speed"])
    idx = _indices(d["tracked"])
    T = torch.from_numpy
    fb = torch.eye(4)[None]
    got = tpipe.recover_pose(T(d["prev_xy"])[None], T(d["xy_u"])[None],
                             T(d["tracked"])[None], T(d["pose"])[None],
                             T(d["last_speed"])[None], torch.tensor([False]), fb,
                             T(K_DOTS)[None], CFG, [lambda *_: idx])
    assert got.pose.dtype == got.pose_fb.dtype == torch.float32
    assert bool(got.took[0]) and int(got.num_inliers[0]) == int(want_inliers)
    # Within half an f32 step of the JAX pose, plus the f64 tolerance.
    half_ulp = np.spacing(np.abs(want_pose).astype(np.float32)).astype(np.float64) / 2
    gap = np.abs(N(got.pose[0]).astype(np.float64) - want_pose)
    assert (gap <= half_ulp + F64_TOL).all(), gap.max()
    np.testing.assert_array_equal(N(got.pose_fb[0]), N(got.pose[0]))


class _F32Ops(TorchFunctionMode):
    """Records the calling function of every torch op that gives an f32
    tensor."""

    def __init__(self):
        super().__init__()
        self.callers = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if any(isinstance(o, torch.Tensor) and o.dtype == torch.float32 for o in outs):
            self.callers.add(sys._getframe(1).f_code.co_name)
        return out


def test_no_f32_intermediate_on_the_recoverys_path(r_inputs):
    """With a distorted lens (so the undistortion runs too) and two lanes:
    the only f32 tensors R makes are the draw's (Gumbel noise and top-k
    of the f32 uniforms) and the pose it rounds back at its end."""
    d = r_inputs[3]
    cfg = dataclasses.replace(CFG, dist=(-0.05, 0.01, 0.001, -0.001, 0.0))
    T = torch.from_numpy
    two = lambda x: torch.stack([T(x), T(x)])  # noqa: E731
    u = [transac.draw_uniforms(torch.Generator().manual_seed(s), *tpipe.recovery_shape(cfg))
         for s in (1, 2)]
    args = (two(d["prev_xy"]), two(d["xy_u"]), two(d["tracked"]), two(d["pose"]),
            two(d["last_speed"]), torch.tensor([False, True]), torch.eye(4).expand(2, 4, 4),
            two(K_DOTS), cfg, [transac.Drawn(x) for x in u])
    with _F32Ops() as mode:
        got = tpipe.recover_pose(*args)
    assert mode.callers == {"gumbel_top_k", "top_k", "recover_pose", "where_lane"}
    assert got.pose.dtype == got.pose_fb.dtype == torch.float32 and not bool(got.took[1])


def test_the_recovery_returns_f32_and_draws_as_before(dot_world):
    """A step whose PnP is out of reach (min_inliers 10**6) takes R's pose:
    the state and the outputs keep their dtypes, and the recovery stream
    ends where one draw of `recovery_shape` leaves it, as in f32."""
    imgs, _ = dot_world
    cfg = dataclasses.replace(CFG, pnp=dataclasses.replace(CFG.pnp, min_inliers=10**6))
    K = torch.from_numpy(K_DOTS)
    st, _ = tpipe.bootstrap(torch.from_numpy(imgs[0]), torch.from_numpy(imgs[2]), K, cfg,
                            torch.Generator().manual_seed(1))
    rec = torch.Generator()
    rec.set_state(st.rec_rng.get_state())
    transac.draw_uniforms(rec, *tpipe.recovery_shape(cfg))
    before = {k: v.dtype for k, v in st._asdict().items() if isinstance(v, torch.Tensor)}
    nxt, out = tpipe.vo_step(st, torch.from_numpy(imgs[3]), K, cfg)
    assert not bool(out.pose_ok) and not bool(out.frozen)
    cv = N(st.pose) @ (np.linalg.inv(N(st.prev_pose)) @ N(st.pose))
    assert np.abs(N(out.pose) - cv).max() > 0.1  # R's pose, not the constant-velocity one
    assert out.pose.dtype == torch.float32
    assert {k: v.dtype for k, v in nxt._asdict().items() if k in before} == before
    assert torch.equal(nxt.rec_rng.get_state(), rec.get_state())
