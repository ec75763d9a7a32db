"""Parity of the port's geometry against the JAX package on shared numpy
inputs: points, SE(3), camera, DLT, SPD solves, RANSAC, 8-point/E, P3P/PnP.

RANSAC-bearing functions replay the JAX package's own draws: the port's
sampler is a callable that returns `vo_tpu.ops.ransac.sample_indices` for
the same key and validity mask. Tolerances are stated per test; eigh/svd
sign conventions differ between backends, so only sign-invariant results
are compared.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vo_tpu.geom import camera as jcam
from vo_tpu.geom import lie as jlie
from vo_tpu.geom import points as jpts
from vo_tpu.ops import epipolar as jepi
from vo_tpu.ops import linalg as jlin
from vo_tpu.ops import pnp as jpnp
from vo_tpu.ops import ransac as jransac
from vo_tpu.ops import triangulate as jtri

from vo_tpu_torch.geom import camera as tcam
from vo_tpu_torch.geom import lie as tlie
from vo_tpu_torch.geom import points as tpts
from vo_tpu_torch.ops import epipolar as tepi
from vo_tpu_torch.ops import linalg as tlin
from vo_tpu_torch.ops import pnp as tpnp
from vo_tpu_torch.ops import ransac as transac
from vo_tpu_torch.ops import triangulate as ttri

# Several pytest-xdist workers share the cores: PyTorch's intra-op thread
# pool over the port's many tiny CPU ops would only contend with them.
torch.set_num_threads(1)

K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
ATOL = 1e-5  # geometry helpers: f32 elementwise math, a few ulps apart


def T(x):
    return torch.as_tensor(np.asarray(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def replay(key):
    """A port sampler returning the JAX package's draws for `key`."""
    def sampler(h, n, s, valid):
        v = None if valid is None else jnp.asarray(valid.numpy())
        return np.asarray(jransac.sample_indices(key, h, n, s, v))
    return sampler


# ---------------------------------------------------------------------------
# geom
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_normalize_points(rng, weighted):
    pts = rng.uniform(-50, 400, (3, 40, 2)).astype(np.float32)
    w = (rng.uniform(size=(3, 40)) > 0.3).astype(np.float32) if weighted else None
    jn, jT = jpts.normalize_points(jnp.asarray(pts), None if w is None else jnp.asarray(w))
    tn, tT = tpts.normalize_points(T(pts), None if w is None else T(w))
    np.testing.assert_allclose(N(tn), N(jn), atol=ATOL)
    np.testing.assert_allclose(N(tT), N(jT), rtol=1e-5, atol=ATOL)


def test_points_helpers(rng):
    p = rng.normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(N(tpts.to_homogeneous(T(p))), N(jpts.to_homogeneous(p)))
    np.testing.assert_allclose(N(tpts.to_cartesian(T(p), eps=1e-3)),
                               N(jpts.to_cartesian(jnp.asarray(p), eps=1e-3)), atol=ATOL)
    np.testing.assert_allclose(N(tpts.skew(T(p))), N(jpts.skew(jnp.asarray(p))))
    m = rng.normal(size=(7, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(N(tpts.unskew(T(m))), N(jpts.unskew(jnp.asarray(m))), atol=ATOL)


@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.5, 2.5])
def test_se3_exp_log(rng, scale):
    xi = rng.normal(size=(16, 6)).astype(np.float32)
    xi[:, 3:] *= scale / np.linalg.norm(xi[:, 3:], axis=1, keepdims=True)
    jH = jlie.se3_exp(jnp.asarray(xi))
    tH = tlie.se3_exp(T(xi))
    np.testing.assert_allclose(N(tH), N(jH), atol=ATOL)
    np.testing.assert_allclose(N(tlie.se3_log(tH)), N(jlie.se3_log(jH)), atol=1e-4)
    np.testing.assert_allclose(N(tlie.pose_inverse(tH)), N(jlie.pose_inverse(jH)), atol=ATOL)
    np.testing.assert_allclose(N(tlie.so3_log(tH[:, :3, :3])),
                               N(jlie.so3_log(jH[:, :3, :3])), atol=1e-4)


def test_camera_projection_and_distortion(rng):
    dist = np.array([-0.28, 0.07, 1e-3, -5e-4, 0.0], np.float32)
    pose = N(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.2, 6).astype(np.float32))))
    jc = jcam.Camera.create(K, pose, dist)
    tc = tcam.Camera.create(K, pose, dist)
    X = rng.uniform([-5, -3, 6], [5, 3, 30], (50, 3)).astype(np.float32)
    px = rng.uniform([0, 0], [640, 480], (50, 2)).astype(np.float32)
    np.testing.assert_allclose(N(tc.project_world(T(X))), N(jc.project_world(X)),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(N(tc.normalized_coords(T(px))),
                               N(jc.normalized_coords(px)), atol=ATOL)
    np.testing.assert_allclose(N(tc.distort_points(T(px))), N(jc.distort_points(px)),
                               atol=1e-3)
    np.testing.assert_allclose(N(tc.undistort_points(T(px))), N(jc.undistort_points(px)),
                               atol=1e-3)


# ---------------------------------------------------------------------------
# DLT + small SPD solves
# ---------------------------------------------------------------------------

def _two_views(rng, n=200, noise=0.5, outliers=0.0):
    xi = np.array([0.3, -0.05, 0.9, 0.02, -0.08, 0.03], np.float32)
    T21 = N(jlie.se3_exp(jnp.asarray(xi)))
    X1 = rng.uniform([-8, -5, 6], [8, 5, 40], (n, 3)).astype(np.float32)
    X2 = X1 @ T21[:3, :3].T + T21[:3, 3]
    uv1 = (X1 @ K.T)[:, :2] / X1[:, 2:]
    uv2 = (X2 @ K.T)[:, :2] / X2[:, 2:]
    uv1 = uv1 + rng.normal(0, noise, uv1.shape)
    uv2 = uv2 + rng.normal(0, noise, uv2.shape)
    bad = rng.uniform(size=n) < outliers
    uv2[bad] = rng.uniform([0, 0], [640, 480], (int(bad.sum()), 2))
    return uv1.astype(np.float32), uv2.astype(np.float32), T21, X1


def test_triangulate_dlt(rng):
    uv1, uv2, T21, _ = _two_views(rng, noise=0.3)
    P1 = K @ np.eye(4, dtype=np.float32)[:3]
    P2 = K @ T21[:3]
    jX = jtri.triangulate_dlt(jnp.asarray(P1), jnp.asarray(P2), uv1, uv2)
    tX = ttri.triangulate_dlt(T(P1), T(P2), T(uv1), T(uv2))
    # Dehomogenized points: relative 2e-3. The eigenvector of the f32 normal
    # matrix A^T A squares the DLT's conditioning, and XLA's Jacobi eigh and
    # LAPACK's syevd round differently (observed up to 5e-4 at 40 m depth).
    np.testing.assert_allclose(N(tX), N(jX), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(
        N(ttri.reprojection_error(T(P2), tX, T(uv2))),
        N(jtri.reprojection_error(jnp.asarray(P2), jX, uv2)), atol=1e-3)


def test_spd_solve_small(rng):
    A = rng.normal(size=(5, 6, 12)).astype(np.float32)
    A = A @ np.swapaxes(A, -1, -2) + 1e-2 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(5, 6)).astype(np.float32)
    want = N(jlin.spd_solve_small(jnp.asarray(A), jnp.asarray(b), 6))
    got = N(tlin.spd_solve_small(T(A), T(b), 6))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_spd_solve_blocked_with_gauge(rng):
    Wn, B = 6, 6
    J = rng.normal(size=(Wn * B, 80)).astype(np.float32)
    S = J @ J.T + 1e-3 * np.eye(Wn * B, dtype=np.float32)
    S[:B, :B] += 1e8 * np.eye(B, dtype=np.float32)  # the BA gauge block
    Sb = S.reshape(Wn, B, Wn, B).transpose(0, 2, 1, 3).copy()
    b = rng.normal(size=(Wn, B)).astype(np.float32)
    want = N(jlin.spd_solve_blocked(jnp.asarray(Sb), jnp.asarray(b)))
    got = N(tlin.spd_solve_blocked(T(Sb), T(b)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# RANSAC (replayed draws)
# ---------------------------------------------------------------------------

def test_sample_indices_replay_and_own_draws(rng):
    key = jax.random.PRNGKey(3)
    valid = rng.uniform(size=300) > 0.4
    want = np.asarray(jransac.sample_indices(key, 64, 300, 4, jnp.asarray(valid)))
    got = N(transac.sample_indices(replay(key), 64, 300, 4, T(valid)))
    np.testing.assert_array_equal(got, want)
    own = N(transac.sample_indices(torch.Generator().manual_seed(0), 64, 300, 4, T(valid)))
    assert own.shape == (64, 4)
    assert valid[own].all()
    assert all(len(set(row)) == 4 for row in own)


def test_generic_ransac_line_fit(rng):
    n = 120
    x = rng.uniform(-10, 10, n).astype(np.float32)
    y = (0.7 * x - 2.0 + rng.normal(0, 0.05, n)).astype(np.float32)
    y[:40] = rng.uniform(-20, 20, 40)
    pts = np.stack([x, y], -1).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-5:] = False

    def jmodel(s):
        a = (s[1, 1] - s[0, 1]) / (s[1, 0] - s[0, 0])
        return jnp.stack([a, s[0, 1] - a * s[0, 0]]), jnp.isfinite(a)

    def jerr(m, d):
        return jnp.abs(d[:, 1] - (m[0] * d[:, 0] + m[1]))

    def tmodel(s):  # batched over hypotheses
        a = (s[:, 1, 1] - s[:, 0, 1]) / (s[:, 1, 0] - s[:, 0, 0])
        return torch.stack([a, s[:, 0, 1] - a * s[:, 0, 0]], -1), torch.isfinite(a)

    def terr(m, d):
        return (d[None, :, 1] - (m[:, 0:1] * d[None, :, 0] + m[:, 1:2])).abs()

    key = jax.random.PRNGKey(11)
    for h, chunk in [(100, 1024), (300, 128)]:
        want = jransac.ransac(key, jnp.asarray(pts), n, 2, h, jmodel, jerr, 0.2,
                              valid=jnp.asarray(valid), chunk_size=chunk)
        got = transac.ransac(replay(key), T(pts), n, 2, h, tmodel, terr, 0.2,
                             valid=T(valid), chunk_size=chunk)
        np.testing.assert_allclose(N(got.model), N(want.model), atol=1e-5)
        np.testing.assert_array_equal(N(got.inliers), N(want.inliers))
        assert int(got.num_inliers) == int(want.num_inliers)


def _sign_fixed(F):
    F = np.asarray(F, np.float64)
    return F * np.sign(F.reshape(-1)[np.argmax(np.abs(F))])


def test_fundamental_ransac_and_relative_pose(rng):
    uv1, uv2, T21, _ = _two_views(rng, n=300, noise=0.3, outliers=0.2)
    valid = rng.uniform(size=300) > 0.1
    key = jax.random.PRNGKey(5)
    want = jepi.fundamental_ransac(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                   valid=jnp.asarray(valid), num_hypotheses=256)
    got = tepi.fundamental_ransac(replay(key), T(uv1), T(uv2), valid=T(valid),
                                  num_hypotheses=256)
    # F up to sign, unit Frobenius norm: 1e-4.
    np.testing.assert_allclose(_sign_fixed(N(got.model)), _sign_fixed(want.model), atol=1e-4)
    assert abs(int(got.num_inliers) - int(want.num_inliers)) <= 1
    Kj, Kt = jnp.asarray(K), T(K)
    jE = jepi.essential_from_fundamental(want.model, Kj, Kj)
    tE = tepi.essential_from_fundamental(got.model, Kt, Kt)
    jrp = jepi.relative_pose_from_essential(jE, uv1, uv2, Kj, Kj, weight=want.inliers)
    trp = tepi.relative_pose_from_essential(tE, T(uv1), T(uv2), Kt, Kt, weight=got.inliers)
    # Pose after the cheirality vote: sign-free, 1e-3 (E from an f32 SVD).
    np.testing.assert_allclose(N(trp.T_21), N(jrp.T_21), atol=1e-3)
    t_true = T21[:3, 3] / np.linalg.norm(T21[:3, 3])
    np.testing.assert_allclose(N(trp.T_21)[:3, 3], t_true, atol=0.05)
    agree = N(trp.good) == np.asarray(jrp.good)
    assert agree.mean() > 0.99


# ---------------------------------------------------------------------------
# P3P / PnP
# ---------------------------------------------------------------------------

def _pnp_scene(rng, n=300, noise=0.5, outliers=0.25):
    xi = np.array([0.4, -0.3, 0.6, 0.1, -0.2, 0.15], np.float32)
    T_cw = N(jlie.se3_exp(jnp.asarray(xi)))
    X_c = rng.uniform([-6, -4, 5], [6, 4, 30], size=(n, 3)).astype(np.float32)
    T_wc = np.linalg.inv(T_cw)
    X_w = (X_c @ T_wc[:3, :3].T + T_wc[:3, 3]).astype(np.float32)
    uv = (X_c @ K.T)[:, :2] / X_c[:, 2:]
    uv = uv + rng.normal(0, noise, uv.shape)
    bad = rng.uniform(size=n) < outliers
    uv[bad] = rng.uniform([0, 0], [640, 480], (int(bad.sum()), 2))
    return X_w, uv.astype(np.float32), T_cw


def test_p3p_solve_sample(rng):
    X_w, uv, T_cw = _pnp_scene(rng, n=4, noise=0.0, outliers=0.0)
    jT, jok = jpnp.p3p_solve_sample(jnp.asarray(X_w), jnp.asarray(uv), jnp.asarray(K))
    tT, tok = tpnp.p3p_solve_sample(T(X_w), T(uv), T(K))
    assert bool(jok) and bool(tok)
    np.testing.assert_allclose(N(tT), N(jT), atol=1e-3)
    np.testing.assert_allclose(N(tT), T_cw, atol=1e-2)


def test_pnp_ransac_replayed(rng):
    X_w, uv, T_true = _pnp_scene(rng)
    valid = rng.uniform(size=len(uv)) > 0.05
    key = jax.random.PRNGKey(9)
    want = jpnp.pnp_ransac(key, jnp.asarray(X_w), jnp.asarray(uv), jnp.asarray(K),
                           valid=jnp.asarray(valid), num_hypotheses=256)
    got = tpnp.pnp_ransac(replay(key), T(X_w), T(uv), T(K), valid=T(valid),
                          num_hypotheses=256)
    # Refined pose: 1e-4 (10 GN iterations, f32 reductions in another order).
    np.testing.assert_allclose(N(got.T_cw), N(want.T_cw), atol=1e-4)
    assert abs(int(got.num_inliers) - int(want.num_inliers)) <= 1
    np.testing.assert_allclose(N(got.T_cw), T_true, atol=5e-3)


def test_refine_pose_gn(rng):
    X_w, uv, T_true = _pnp_scene(rng, noise=0.3, outliers=0.0)
    T0 = N(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6).astype(np.float32)))) @ T_true
    w = (rng.uniform(size=len(uv)) > 0.2).astype(np.float32)
    want = jpnp.refine_pose_gn(jnp.asarray(T0), jnp.asarray(X_w), jnp.asarray(uv),
                               jnp.asarray(K), jnp.asarray(w))
    got = tpnp.refine_pose_gn(T(T0), T(X_w), T(uv), T(K), T(w))
    np.testing.assert_allclose(N(got), N(want), atol=1e-4)
