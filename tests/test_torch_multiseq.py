"""The lockstep multi-sequence slice of the port (vo_tpu_torch.parallel.multiseq)
on the CPU, at the size tests/test_parallel.py uses (capacity 64, 256 for
the rollouts, 72x96, two pyramid levels, radius 4, two or three lanes), and a
320x240 city at the full config for the lane-equals-its-single-run tests:

  * the batched kernel wrappers (their plain versions here) against the
    batched Pallas kernels in interpret mode;
  * every module that gained a lane axis: lane b of the batched call equals
    the unbatched call on lane b;
  * the batched rollout against the single rollout per lane, against the JAX
    package's batched step from a carried state, under per-lane keyframe
    policies, and beside a lane whose PnP fails;
  * the lane placements without a process group, and the
    run_multiseq_torch.py script.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax
import jax.numpy as jnp

from vo_tpu.models import pipeline as jpipe
from vo_tpu.ops import ransac as jransac
from vo_tpu.ops.pallas_kernels import (
    corner_response_nms_batched,
    extract_patches_aligned_batched,
)
from vo_tpu.parallel import multiseq as jmulti
from vo_tpu.utils.config import VOConfig as JaxConfig

from vo_tpu_torch.geom import camera as tcam
from vo_tpu_torch.geom import lie as tlie
from vo_tpu_torch.geom import points as tpoints
from vo_tpu_torch.models import ba as tba
from vo_tpu_torch.models import feature_table as tft
from vo_tpu_torch.models import pipeline as tpipe
from vo_tpu_torch.ops import epipolar as tepi
from vo_tpu_torch.ops import harris as th
from vo_tpu_torch.ops import image as timg
from vo_tpu_torch.ops import kernels
from vo_tpu_torch.ops import klt as tklt
from vo_tpu_torch.ops import linalg as tlin
from vo_tpu_torch.ops import pnp as tpnp
from vo_tpu_torch.ops import ransac as transac
from vo_tpu_torch.ops import triangulate as ttri
from vo_tpu_torch.parallel import multiseq as tmulti
from vo_tpu_torch.utils.config import DetectorConfig, KLTConfig, VOConfig

# Several pytest-xdist workers share the cores (see test_torch_frontend.py).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H, W, CAP = 72, 96, 64
# The rollout tests hold a lane to its single run at the capacity at which a
# batch-shape-dependent reduction first showed (256), not only at CAP.
LANE_CAP = 256
K_SMALL = np.array([[80.0, 0, 48.0], [0, 80.0, 36.0], [0, 0, 1.0]], np.float32)
ATOL = 1e-5  # lane b of a batched call against the unbatched call, floats


def small_cfg(capacity=CAP):
    return VOConfig(capacity=capacity, detector=DetectorConfig(border=8, nms_radius=4),
                    klt=KLTConfig(pyramid_levels=2, radius=4))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def noise_frames(seed: int, n: int, dx: int = 2) -> np.ndarray:
    """The rolled random image of tests/test_parallel.py, from a numpy seed."""
    base = 127.0 + 40.0 * np.random.default_rng(seed).standard_normal((H, W))
    return np.stack([np.roll(base, (i, dx * i), axis=(0, 1)) for i in range(n)]
                    ).astype(np.float32)


def assert_lanes_equal(batched, singles, atol=ATOL):
    """Leaf by leaf: lane b of `batched` is `singles[b]` — exact for integer
    and boolean leaves, `atol` for floats."""
    flat_b = batched if isinstance(batched, (tuple, list)) else (batched,)
    for b, single in enumerate(singles):
        flat_s = single if isinstance(single, (tuple, list)) else (single,)
        assert len(flat_b) == len(flat_s)
        for xb, xs in zip(flat_b, flat_s):
            assert xb[b].shape == xs.shape
            if xs.dtype.is_floating_point:
                np.testing.assert_allclose(N(xb[b]), N(xs), atol=atol, rtol=0,
                                           equal_nan=True)
            else:
                np.testing.assert_array_equal(N(xb[b]), N(xs))


# ---------------------------------------------------------------------------
# (a) the batched kernels: plain versions against the Pallas (B, ...) kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,patch,nms_r", [("shi_tomasi", 7, 8), ("harris", 9, 5)])
def test_k1b_plain_matches_batched_pallas(mode, patch, nms_r):
    imgs = np.random.default_rng(1).uniform(0, 255, (3, 96, 200)).astype(np.float32)
    got = N(kernels.corner_response_nms(T(imgs), mode, patch, 0.08, nms_r))
    want = np.asarray(corner_response_nms_batched(
        jnp.asarray(imgs), mode=mode, patch_size=patch, kappa=0.08, nms_radius=nms_r,
        interpret=True))
    # As tests/test_pallas_frontend.py: identical maxima, values at rtol 1e-5
    # / atol 1e-2 (f32 box sums in another order).
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fw = np.isfinite(want)
    assert fw.reshape(3, -1).sum(axis=1).min() > 10
    np.testing.assert_allclose(got[fw], want[fw], rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("size", [17, 21])
def test_k2b_plain_matches_batched_pallas_and_dynamic_slice(size):
    rng = np.random.default_rng(2)
    h, w = 104, 384
    imgs = rng.uniform(0, 255, (3, h, w)).astype(np.float32)
    # Inside the Pallas kernel's contract (its aligned cover region in
    # bounds): bit-identical to the batched TPU kernel.
    cor = rng.integers(0, 50, (3, 70, 2)).astype(np.int32)
    want = np.asarray(extract_patches_aligned_batched(
        jnp.asarray(imgs), jnp.asarray(cor), size, interpret=True))
    got = kernels.extract_patches(T(imgs), T(cor), size)
    np.testing.assert_array_equal(N(got), want)
    # Beyond it, the contract is lax.dynamic_slice's: negative starts count
    # from the end, every start is clamped so the window fits.
    cor = np.stack([rng.integers(-30, w + 30, (3, 60)),
                    rng.integers(-30, h + 30, (3, 60))], -1)
    edge = np.array([[0, 0], [w - size, h - size], [w, h], [-1, -1], [-w - 5, -h - 5]])
    cor = np.concatenate([cor, np.broadcast_to(edge, (3,) + edge.shape)], axis=1)
    cor = cor.astype(np.int32)
    want = jax.vmap(jax.vmap(
        lambda im, c: jax.lax.dynamic_slice(im, (c[1], c[0]), (size, size)),
        in_axes=(None, 0)))(jnp.asarray(imgs), jnp.asarray(cor))
    got = kernels.extract_patches(T(imgs), T(cor), size)
    np.testing.assert_array_equal(N(got), np.asarray(want))


def test_batched_launches_have_their_own_counts():
    assert {"corner_response_nms_batched", "extract_patches_batched"} <= set(
        kernels.launch_counts)
    before = dict(kernels.launch_counts)
    kernels.corner_response_nms(torch.zeros(2, 40, 50))
    kernels.extract_patches(torch.zeros(2, 40, 50), torch.zeros(2, 3, 2, dtype=torch.int32), 5)
    assert kernels.launch_counts == before  # the plain path never counts


# ---------------------------------------------------------------------------
# (b) every module with a lane axis: lane b == the unbatched call on lane b
# ---------------------------------------------------------------------------

def _smooth_imgs(b=3, seed=3):
    rng = np.random.default_rng(seed)
    return np.stack([
        3.0 * scipy.ndimage.gaussian_filter(rng.uniform(0, 255, (H, W)), 1.0)
        for _ in range(b)]).astype(np.float32)


@pytest.mark.parametrize("op", ["sobel", "box7", "gauss", "down", "grad", "pyramid",
                                "bilinear"])
def test_image_ops_per_lane(op):
    imgs = T(_smooth_imgs())
    pts = T(np.random.default_rng(4).uniform(-3, 100, (3, 50, 2)).astype(np.float32))
    fns = {
        "sobel": lambda x, p: timg.sobel(x),
        "box7": lambda x, p: timg.box_filter(x, 7),
        "gauss": lambda x, p: timg.gaussian_blur(x, 1.3),
        "down": lambda x, p: timg.downsample2(x),
        "grad": lambda x, p: timg.image_gradients(x),
        "pyramid": lambda x, p: tuple(timg.build_pyramid(x, 3)),
        "bilinear": lambda x, p: timg.bilinear_sample(x, p),
    }
    assert_lanes_equal(fns[op](imgs, pts), [fns[op](imgs[b], pts[b]) for b in range(3)])


def test_detect_keypoints_per_lane_with_ties():
    """Per-lane quality floor, top-k and the stable tie order: lane 1 is an
    image of exact ties (tests/test_torch_frontend.py), lane 0 and 2 random
    with very different response scales."""
    tile = np.zeros((12, 12), np.float32)
    tile[3:9, 3:9] = 200.0
    imgs = _smooth_imgs()
    imgs[1] = np.tile(tile, (6, 8))
    imgs[2] *= 0.05
    args = dict(mode="shi_tomasi", patch_size=7, nms_radius=4, border=8, quality_level=0.01)
    got = th.detect_keypoints(T(imgs), CAP, **args)
    singles = [th.detect_keypoints(T(imgs[b]), CAP, **args) for b in range(3)]
    assert all(int(s.valid.sum()) > 10 for s in singles)
    assert_lanes_equal(got, singles, atol=0)
    masked = kernels.corner_response_nms(T(imgs), "shi_tomasi", 7, 0.08, 4)
    assert_lanes_equal(
        th.select_from_masked(masked, CAP, border=8, quality_level=0.01),
        [th.select_from_masked(masked[b], CAP, border=8, quality_level=0.01)
         for b in range(3)], atol=0)
    vals, idx = th.top_k(T(np.array([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 0.0]],
                                    np.float32)), 3)
    np.testing.assert_array_equal(N(idx), [[1, 2, 3], [0, 1, 2]])


@pytest.mark.parametrize("with_init_flow", [False, True])
def test_pyramidal_lk_per_lane(with_init_flow):
    imgs = _smooth_imgs()
    nxt = np.stack([scipy.ndimage.shift(im, (1.3 + b, -2.1), order=1, mode="nearest")
                    for b, im in enumerate(imgs)]).astype(np.float32)
    rng = np.random.default_rng(5)
    xy = rng.uniform(6, 66, (3, CAP, 2)).astype(np.float32)
    xy[:, :2] = [[1.0, 1.0], [94.0, 70.0]]
    flow = (rng.normal(0, 1.0, (3, CAP, 2)) + [-2.1, 1.3]).astype(np.float32)
    p0, p1 = timg.build_pyramid(T(imgs), 2), timg.build_pyramid(T(nxt), 2)
    kw = dict(radius=4)
    got = tklt.pyramidal_lk(p0, p1, T(xy), init_flow=T(flow) if with_init_flow else None, **kw)
    singles = [
        tklt.pyramidal_lk([p[b] for p in p0], [p[b] for p in p1], T(xy[b]),
                          init_flow=T(flow[b]) if with_init_flow else None, **kw)
        for b in range(3)]
    assert any(bool(s.status.any()) for s in singles)
    assert_lanes_equal(got, singles)
    # _sel and _resample on their own.
    pos = T(rng.uniform(0, 5, (3, 7)).astype(np.float32))
    assert_lanes_equal(tklt._sel(pos, 9, 15), [tklt._sel(pos[b], 9, 15) for b in range(3)])
    patch = T(rng.uniform(0, 255, (3, 7, 15, 15)).astype(np.float32))
    pxy = T(rng.uniform(0, 5, (3, 7, 2)).astype(np.float32))
    assert_lanes_equal(tklt._resample(patch, pxy, 9),
                       [tklt._resample(patch[b], pxy[b], 9) for b in range(3)])


def _scene(b=3, n=CAP, seed=6):
    """Per lane: world points, a camera, noisy projections with outliers."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-3, -2, 4], [3, 2, 12], (b, n, 3)).astype(np.float32)
    T_cw = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    T_cw[:, :3, 3] = rng.normal(0, 0.2, (b, 3))
    for i in range(b):
        T_cw[i, :3, :3] = N(tlie.so3_exp(T(rng.normal(0, 0.05, 3).astype(np.float32))))
    Ks = np.stack([K_SMALL * s for s in (1.0, 1.1, 0.9)][:b]).astype(np.float32)
    Ks[:, 2, 2] = 1.0
    uv0 = N(tpnp.project_T(torch.eye(4).expand(b, 1, 4, 4), T(Ks), T(X)))
    uv1 = N(tpnp.project_T(T(T_cw)[:, None], T(Ks), T(X)))
    uv1 = uv1 + rng.normal(0, 0.2, uv1.shape).astype(np.float32)
    uv1[:, :8] += 15.0
    valid = np.ones((b, n), bool)
    valid[:, -5:] = False
    return X, T_cw, Ks, uv0.astype(np.float32), uv1.astype(np.float32), valid


def _replay_fixed(idx):
    return lambda h, n, s, valid: idx


def test_geom_per_lane():
    X, T_cw, Ks, uv0, uv1, valid = _scene()
    dist = torch.tensor([-0.28, 0.08, 0.0005, -0.0005, 0.0])
    cam = tcam.Camera.create(T(Ks), pose=T(T_cw), dist=dist)
    singles = [tcam.Camera.create(T(Ks[b]), pose=T(T_cw[b]), dist=dist) for b in range(3)]
    for fn in ("distort_points", "undistort_points", "normalized_coords"):
        assert_lanes_equal(getattr(cam, fn)(T(uv1)),
                           [getattr(singles[b], fn)(T(uv1[b])) for b in range(3)])
    assert_lanes_equal(cam.project_world(T(X)),
                       [singles[b].project_world(T(X[b])) for b in range(3)], atol=1e-4)
    assert_lanes_equal(tcam.transform_points(T(T_cw), T(X)),
                       [tcam.transform_points(T(T_cw[b]), T(X[b])) for b in range(3)])
    w = T(valid.astype(np.float32))
    assert_lanes_equal(tpoints.normalize_points(T(uv1), w),
                       [tpoints.normalize_points(T(uv1[b]), w[b]) for b in range(3)])
    xi = T(np.random.default_rng(7).normal(0, 0.3, (3, 6)).astype(np.float32))
    assert_lanes_equal(tlie.se3_exp(xi), [tlie.se3_exp(xi[b]) for b in range(3)])
    assert_lanes_equal(tlie.se3_log(tlie.se3_exp(xi)),
                       [tlie.se3_log(tlie.se3_exp(xi[b])) for b in range(3)])
    assert_lanes_equal(tlie.pose_inverse(T(T_cw)),
                       [tlie.pose_inverse(T(T_cw[b])) for b in range(3)])


@pytest.mark.parametrize("hyps,chunk", [(64, 1024), (96, 32)])
def test_ransac_per_lane(hyps, chunk):
    """sample_indices with one sampler per lane, and the generic ransac (one
    block, and chunked with the running best) on a per-lane line fit."""
    rng = np.random.default_rng(8)
    b, n = 3, 80
    x = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    y = (np.array([[2.0], [-1.0], [0.5]]) * x + np.array([[0.3], [0.0], [-0.7]])
         + rng.normal(0, 0.01, (b, n))).astype(np.float32)
    y[:, :20] += rng.uniform(1, 3, (b, 20)).astype(np.float32)
    pts = T(np.stack([x, y], -1))
    valid = torch.ones(b, n, dtype=torch.bool)
    valid[1, 40:] = False

    def model_fn(s):  # (..., C, 2, 2) -> line (a, c) through the two points
        dx = s[..., 1, 0] - s[..., 0, 0]
        a = (s[..., 1, 1] - s[..., 0, 1]) / torch.where(dx.abs() < 1e-9, 1e-9, dx)
        return torch.stack([a, s[..., 0, 1] - a * s[..., 0, 0]], -1), dx.abs() > 1e-6

    def error_fn(m, d):  # (..., C, 2), (..., N, 2) -> (..., C, N)
        d = d.unsqueeze(-3)
        return (m[..., None, 0] * d[..., 0] + m[..., None, 1] - d[..., 1]).abs()

    def gens():
        return [torch.Generator().manual_seed(10 + i) for i in range(b)]

    idx = transac.sample_indices(gens(), hyps, n, 2, valid)
    assert idx.shape == (b, hyps, 2)
    for i, g in enumerate(gens()):
        np.testing.assert_array_equal(
            N(idx[i]), N(transac.sample_indices(g, hyps, n, 2, valid[i])))
        assert bool(valid[i][idx[i]].all())
    got = transac.ransac(gens(), pts, n, 2, hyps, model_fn, error_fn, 0.05, valid, chunk)
    singles = [transac.ransac(g, pts[i], n, 2, hyps, model_fn, error_fn, 0.05, valid[i], chunk)
               for i, g in enumerate(gens())]
    assert all(int(s.num_inliers) > 15 for s in singles)
    assert_lanes_equal(got, singles)
    # IDLE draws nothing: the generator of that lane is where it was.
    g = gens()
    transac.sample_indices([g[0], transac.IDLE, g[2]], hyps, n, 2, valid)
    assert torch.equal(g[1].get_state(), gens()[1].get_state())


def test_pnp_per_lane():
    X, T_cw, Ks, uv0, uv1, valid = _scene()
    idx = [transac.sample_indices(torch.Generator().manual_seed(b), 128, CAP, 4, T(valid[b]))
           for b in range(3)]
    got = tpnp.pnp_ransac([_replay_fixed(i) for i in idx], T(X), T(uv1), T(Ks), T(valid),
                          num_hypotheses=128)
    singles = [tpnp.pnp_ransac(_replay_fixed(idx[b]), T(X[b]), T(uv1[b]), T(Ks[b]),
                               T(valid[b]), num_hypotheses=128) for b in range(3)]
    assert all(int(s.num_inliers) > 30 for s in singles)
    assert_lanes_equal(got, singles)
    w = T(valid.astype(np.float32))
    start = T(T_cw) @ tlie.se3_exp(torch.full((3, 6), 0.02))
    assert_lanes_equal(
        tpnp.refine_pose_gn(start, T(X), T(uv1), T(Ks), w, iters=4),
        [tpnp.refine_pose_gn(start[b], T(X[b]), T(uv1[b]), T(Ks[b]), w[b], iters=4)
         for b in range(3)])
    s4 = T(X[:, :8].reshape(3, 2, 4, 3))
    u4 = T(uv1[:, :8].reshape(3, 2, 4, 2))
    assert_lanes_equal(tpnp.p3p_solve_sample(s4, u4, T(Ks)),
                       [tpnp.p3p_solve_sample(s4[b], u4[b], T(Ks[b])) for b in range(3)])


def test_epipolar_and_triangulation_per_lane():
    X, T_cw, Ks, uv0, uv1, valid = _scene()
    idx = [transac.sample_indices(torch.Generator().manual_seed(b), 128, CAP, 8, T(valid[b]))
           for b in range(3)]
    got = tepi.fundamental_ransac([_replay_fixed(i) for i in idx], T(uv0), T(uv1), T(valid),
                                  num_hypotheses=128)
    singles = [tepi.fundamental_ransac(_replay_fixed(idx[b]), T(uv0[b]), T(uv1[b]),
                                       T(valid[b]), num_hypotheses=128) for b in range(3)]
    assert all(int(s.num_inliers) > 30 for s in singles)
    # F is defined up to sign (an eigenvector): compare it sign-aligned.
    for b, s in enumerate(singles):
        sign = torch.sign((got.model[b] * s.model).sum())
        np.testing.assert_allclose(N(got.model[b] * sign), N(s.model), atol=ATOL)
        np.testing.assert_array_equal(N(got.inliers[b]), N(s.inliers))
        assert int(got.num_inliers[b]) == int(s.num_inliers)
    E = tepi.essential_from_fundamental(got.model, T(Ks), T(Ks))
    rp = tepi.relative_pose_from_essential(E, T(uv0), T(uv1), T(Ks), T(Ks), weight=got.inliers)
    for b in range(3):
        Eb = tepi.essential_from_fundamental(got.model[b], T(Ks[b]), T(Ks[b]))
        np.testing.assert_allclose(N(E[b]), N(Eb), atol=1e-4)
        rpb = tepi.relative_pose_from_essential(Eb, T(uv0[b]), T(uv1[b]), T(Ks[b]), T(Ks[b]),
                                                weight=got.inliers[b])
        # Unit translation and rotation: atol 1e-4 (two SVDs per lane).
        np.testing.assert_allclose(N(rp.T_21[b]), N(rpb.T_21), atol=1e-4)
        np.testing.assert_array_equal(N(rp.good[b]), N(rpb.good))
        # The baseline is a fiftieth of the unit translation, so the points
        # lie hundreds of baselines away: 1% of their own size.
        inl = N(got.inliers[b]) & N(rpb.good)
        np.testing.assert_allclose(N(rp.points1[b])[inl], N(rpb.points1)[inl],
                                   rtol=1e-2, atol=1e-3)
    # DLT with one matrix per lane and one per point.
    P0 = T(Ks) @ torch.eye(4)[:3].expand(3, 3, 4)
    P1 = T(Ks) @ T(T_cw)[:, :3]
    P1_pts = P1[:, None].expand(3, CAP, 3, 4).contiguous()
    for P1x, P1b in ((P1, lambda b: P1[b]), (P1_pts, lambda b: P1_pts[b])):
        Xt = ttri.triangulate_dlt(P0, P1x, T(uv0), T(uv1))
        ok = N(T(valid)) & (np.arange(CAP) >= 8)
        for b in range(3):
            Xs = ttri.triangulate_dlt(P0[b], P1b(b), T(uv0[b]), T(uv1[b]))
            np.testing.assert_allclose(N(Xt[b])[ok[b]], N(Xs)[ok[b]], rtol=1e-4, atol=1e-4)
        assert_lanes_equal(
            ttri.reprojection_error(P1x, Xt, T(uv1)),
            [ttri.reprojection_error(P1b(b), Xt[b], T(uv1[b])) for b in range(3)], atol=1e-4)


def test_linalg_per_lane():
    rng = np.random.default_rng(9)
    A = rng.normal(size=(3, 6, 6)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    rhs = rng.normal(size=(3, 6)).astype(np.float32)
    assert_lanes_equal(tlin.spd_solve_small(T(A), T(rhs), 6),
                       [tlin.spd_solve_small(T(A[b]), T(rhs[b]), 6) for b in range(3)])
    Wn, Bn = 4, 6
    M = rng.normal(size=(3, Wn * Bn, Wn * Bn)).astype(np.float32)
    M = M @ M.transpose(0, 2, 1) + Wn * Bn * np.eye(Wn * Bn, dtype=np.float32)
    S = M.reshape(3, Wn, Bn, Wn, Bn).transpose(0, 1, 3, 2, 4).copy()
    bb = rng.normal(size=(3, Wn, Bn)).astype(np.float32)
    got = tlin.spd_solve_blocked(T(S), T(bb))
    assert_lanes_equal(got, [tlin.spd_solve_blocked(T(S[b]), T(bb[b])) for b in range(3)])
    want = np.linalg.solve(M.astype(np.float64), bb.reshape(3, -1, 1).astype(np.float64))
    np.testing.assert_allclose(N(got).reshape(3, -1), want[..., 0], atol=1e-4)


def _tables(b=3, seed=10):
    rng = np.random.default_rng(seed)
    state = rng.integers(-1, 3, (b, CAP)).astype(np.int32)
    state[1, :50] = 2  # a nearly full lane
    return tft.empty_table(CAP)._replace(
        xy=T(rng.uniform(0, 90, (b, CAP, 2)).astype(np.float32)),
        landmark=T(rng.normal(size=(b, CAP, 3)).astype(np.float32)),
        state=T(state),
        track_xy=T(rng.uniform(0, 90, (b, CAP, 2)).astype(np.float32)),
        track_pose=torch.eye(4).reshape(1, 1, 16).repeat(b, CAP, 1),
        uid=T(np.stack([rng.permutation(CAP) + 100 * i for i in range(b)]).astype(np.int32)),
        score=T(rng.uniform(0, 1, (b, CAP)).astype(np.float32)),
        desc=torch.zeros(b, CAP, 1),
        sigma=torch.zeros(b, CAP),
        miss=torch.zeros(b, CAP, dtype=torch.int32),
    )


def _lane(nt, b):
    return type(nt)(*(f[b] for f in nt))


def test_feature_table_per_lane():
    rng = np.random.default_rng(11)
    table = _tables()
    mask = T(rng.uniform(size=(3, CAP)) < 0.3)
    pose = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    pose[:, :3, 3] = rng.normal(size=(3, 3))
    pose_flat = T(pose.reshape(3, 16))
    assert_lanes_equal(
        tft.restart_tracks(table, mask, pose_flat),
        [tft.restart_tracks(_lane(table, b), mask[b], pose_flat[b]) for b in range(3)], atol=0)
    det_xy = T(rng.uniform(0, 90, (3, 40, 2)).astype(np.float32))
    det_score = T(rng.uniform(0, 1, (3, 40)).astype(np.float32))
    det_ok = T(rng.uniform(size=(3, 40)) < 0.7)
    next_uid = torch.tensor([1000, 2000, 3000], dtype=torch.int32)
    got, got_uid = tft.fill_free_slots(table, det_xy, det_score, det_ok, pose_flat, next_uid)
    for b in range(3):
        want, want_uid = tft.fill_free_slots(_lane(table, b), det_xy[b], det_score[b],
                                             det_ok[b], pose_flat[b], next_uid[b])
        for f_got, f_want in zip(got, want):
            np.testing.assert_array_equal(N(f_got[b]), N(f_want))
        assert int(got_uid[b]) == int(want_uid)
    assert tft.debug_validate(got) == []
    broken = got._replace(uid=torch.zeros_like(got.uid))
    assert any(m.startswith("lane 1:") for m in tft.debug_validate(broken))


def _windows(b=3, seed=12):
    """Per lane a window of 4 valid keyframes (lane 2: 3) observing CAP points."""
    rng = np.random.default_rng(seed)
    wn = 5
    win = tba.empty_window(wn, CAP)
    wins = []
    for lane in range(b):
        X = rng.uniform([-3, -2, 5], [3, 2, 12], (CAP, 3)).astype(np.float32)
        w = win
        for k in range(4 if lane < 2 else 3):
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = [0.3 * k, 0.02 * lane, 0.1 * k]
            T_cw = np.linalg.inv(pose)
            Xc = X @ T_cw[:3, :3].T + T_cw[:3, 3]
            uv = (Xc @ K_SMALL.T)
            uv = uv[:, :2] / uv[:, 2:] + rng.normal(0, 0.3, (CAP, 2))
            tri = rng.uniform(size=CAP) < 0.9
            pose[:3, 3] += rng.normal(0, 0.02, 3)
            w = tba.push_keyframe(w, T(pose), T(uv.astype(np.float32)),
                                  T(X + rng.normal(0, 0.05, X.shape).astype(np.float32)),
                                  torch.arange(CAP, dtype=torch.int32), T(tri))
        wins.append(w)
    return wins


def test_ba_per_lane():
    wins = _windows()
    batched = tba.BAWindow(*(torch.stack(f) for f in zip(*wins)))
    Ks = T(np.stack([K_SMALL] * 3))
    rng = np.random.default_rng(13)
    pose = T(np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)))
    xy = T(rng.uniform(0, 90, (3, CAP, 2)).astype(np.float32))
    lm = T(rng.normal(size=(3, CAP, 3)).astype(np.float32))
    uid = torch.arange(CAP, dtype=torch.int32).expand(3, CAP).clone()
    uid[1, :10] += 500  # recycled slots drop their observations
    tri = T(rng.uniform(size=(3, CAP)) < 0.8)
    assert_lanes_equal(
        tba.push_keyframe(batched, pose, xy, lm, uid, tri),
        [tba.push_keyframe(wins[b], pose[b], xy[b], lm[b], uid[b], tri[b]) for b in range(3)],
        atol=0)
    got, errs = tba.ba_refine(batched, Ks, iters=3)
    assert errs.shape == (3, 3)
    for b in range(3):
        want, want_errs = tba.ba_refine(wins[b], T(K_SMALL), iters=3)
        assert float(want_errs[-1]) < float(want_errs[0])  # it did refine
        np.testing.assert_allclose(N(errs[b]), N(want_errs), atol=ATOL)
        np.testing.assert_allclose(N(got.kf_pose[b]), N(want.kf_pose), atol=ATOL)
        np.testing.assert_allclose(N(got.landmark[b]), N(want.landmark), atol=ATOL)
    # The accept veto is per lane: a lane with a non-finite landmark keeps its
    # input window, its neighbours are refined.
    bad_lm = batched.landmark.clone()
    bad_lm[1, 3] = float("nan")
    bad = batched._replace(landmark=bad_lm,
                           lm_valid=batched.lm_valid | (torch.arange(3) == 1)[:, None])
    out, _ = tba.ba_refine(bad, Ks, iters=2)
    np.testing.assert_array_equal(N(out.kf_pose[1]), N(bad.kf_pose[1]))
    assert not torch.equal(out.kf_pose[0], bad.kf_pose[0])
    # where_window with one predicate per lane, against a shared empty window.
    cond = torch.tensor([True, False, True])
    sel = tba.where_window(cond, batched, tba.empty_window(5, CAP))
    assert bool(sel.kf_valid[0].any()) and not bool(sel.kf_valid[1].any())
    assert torch.equal(sel.obs_uv[2], batched.obs_uv[2])


# ---------------------------------------------------------------------------
# (c) batched rollout == single rollout per lane, identical draws
# ---------------------------------------------------------------------------

def _bootstrap(frames, seed, cfg=None):
    cfg = cfg or small_cfg()
    return tpipe.bootstrap(T(frames[0]), T(frames[2]), T(K_SMALL), cfg,
                           torch.Generator().manual_seed(seed))[0]


def test_batched_vo_rollout_matches_single():
    """(N, B) rollout must reproduce the single-sequence rollout per lane,
    bit for bit."""
    cfg = small_cfg(LANE_CAP)
    frames = noise_frames(0, 6)
    _, single = tpipe.vo_rollout(_bootstrap(frames, 7, cfg), T(frames[3:6]), T(K_SMALL), cfg)

    b = 2
    st = _bootstrap(frames, 7, cfg)
    # Identical samplers so that both lanes are comparable to the single run.
    states = tmulti.replicate_state(st, b, [st.rng, _bootstrap(frames, 7, cfg).rng])
    Ks = T(K_SMALL).expand(b, 3, 3).contiguous()
    bstack = T(np.stack([np.stack([im] * b) for im in frames[3:6]]))
    final, batched = tmulti.batched_vo_rollout(states, bstack, Ks, cfg)
    assert batched.pose.shape == (3, b, 4, 4) and batched.pose_ok.shape == (3, b)
    assert final.table.xy.shape == (b, LANE_CAP, 2) and len(final.rng) == b
    np.testing.assert_array_equal(N(batched.pose[:, 0]), N(single.pose))
    np.testing.assert_array_equal(N(batched.num_triangulated[:, 1]),
                                  N(single.num_triangulated))
    assert int(single.num_triangulated.min()) > 0


@pytest.fixture(scope="module")
def city_320():
    """Frames 0-7 of the default city at 320x240 (focal 208) and its K."""
    from vo_tpu_torch.data import synthetic as tsyn

    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, width=320, height=240, focal=208.0)
    rects, tex = tsyn.scene(spec)
    poses = tsyn.make_path(spec.path, spec.num_frames)[:8]
    frames = tsyn.render_frames_torch(rects, tex, poses, spec.K(), spec.width, spec.height)
    return frames.to(torch.float32), T(spec.K())


@pytest.mark.parametrize("capacity", [256, 1024])
def test_klt_lane_of_two_equals_its_single_run_bit_for_bit(city_320, capacity):
    """Two KLT lanes of the city (frames 0-6 and 1-7), full size config,
    through four steps (PnP on every step, BA on the keyframe steps): each
    lane of the batch equals its single run bit for bit, poses, outputs and
    table. No reduction on the path may pick its kernel by the batch shape."""
    frames, K = city_320
    cfg = VOConfig(capacity=capacity)
    clips = [frames[:7], frames[1:8]]

    def boot(i):
        return tpipe.bootstrap(clips[i][0], clips[i][2], K, cfg,
                               torch.Generator().manual_seed(10 + i))[0]

    singles = [tpipe.vo_rollout(boot(i), clips[i][3:], K, cfg) for i in range(2)]
    states, outs = tmulti.batched_vo_rollout(
        tmulti.stack_states([boot(0), boot(1)]), torch.stack([c[3:] for c in clips], dim=1),
        torch.stack([K, K]), cfg)
    assert bool(outs.pose_ok.all())
    for b, (st, out) in enumerate(singles):
        for name in out._fields:
            np.testing.assert_array_equal(N(getattr(outs, name)[:, b]), N(getattr(out, name)),
                                          err_msg=name)
        for name in st.table._fields:
            np.testing.assert_array_equal(N(getattr(states.table, name)[b]),
                                          N(getattr(st.table, name)), err_msg=name)
        for name in st.window._fields:
            np.testing.assert_array_equal(N(getattr(states.window, name)[b]),
                                          N(getattr(st.window, name)), err_msg=name)


def test_stack_states_keeps_each_lane():
    """Three DISTINCT lanes, each bootstrapped alone with its own sampler,
    stacked and rolled over 5 frames: every lane is its own single rollout,
    bit for bit."""
    cfg = small_cfg(LANE_CAP)
    lanes = [noise_frames(s, 8, dx=2 + s) for s in range(3)]
    singles = [tpipe.vo_rollout(_bootstrap(f, 7 + i, cfg), T(f[3:]), T(K_SMALL), cfg)
               for i, f in enumerate(lanes)]
    states = tmulti.stack_states([_bootstrap(f, 7 + i, cfg) for i, f in enumerate(lanes)])
    stack = T(np.stack(lanes, axis=1)[3:])
    Ks = T(K_SMALL).expand(3, 3, 3).contiguous()
    final, outs = tmulti.batched_vo_rollout(states, stack, Ks, cfg)
    for b, (st, out) in enumerate(singles):
        np.testing.assert_array_equal(N(outs.pose[:, b]), N(out.pose))
        for name in ("pose_ok", "num_tracked", "num_triangulated", "num_pnp_inliers"):
            np.testing.assert_array_equal(N(getattr(outs, name)[:, b]), N(getattr(out, name)))
        np.testing.assert_array_equal(N(final.table.state[b]), N(st.table.state))
        np.testing.assert_array_equal(N(final.table.uid[b]), N(st.table.uid))
        assert int(final.next_uid[b]) == int(st.next_uid)
    assert tft.debug_validate(final.table) == []
    with pytest.raises(ValueError, match="single-sequence"):
        tmulti.stack_states([final])
    with pytest.raises(ValueError, match="samplers"):
        tmulti.replicate_state(singles[0][0], 3, [torch.Generator()])
    with pytest.raises(ValueError, match="lanes"):
        tmulti.batched_vo_step(final, stack[0, :2], Ks, cfg)


# ---------------------------------------------------------------------------
# (d) one batched step from a batched JAX state, the JAX draws replayed
# ---------------------------------------------------------------------------

H2, W2, CAP2 = 240, 320, 384
K_DOTS = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)


def _dot_frames(seed, n=6):
    """The random-dot world of tests/test_torch_pipeline.py."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-25, -15, 2], [25, 15, 60], (4000, 3)).astype(np.float32)
    imgs = []
    for i in range(n):
        yaw = 0.015 * i
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]]
        pose[:3, 3] = [0.1 * i, 0.0, 0.55 * i]
        T_cw = np.linalg.inv(pose)
        Xc = pts @ T_cw[:3, :3].T + T_cw[:3, 3]
        uv = Xc @ K_DOTS.T
        uv = uv[:, :2] / uv[:, 2:]
        ok = ((Xc[:, 2] > 1.0) & (uv[:, 0] > 2) & (uv[:, 0] < W2 - 3)
              & (uv[:, 1] > 2) & (uv[:, 1] < H2 - 3))
        ij = np.round(uv[ok]).astype(int)
        img = np.zeros((H2, W2), np.float32)
        np.add.at(img, (ij[:, 1], ij[:, 0]), 200.0 + 55.0 * np.cos(np.arange(ok.sum())))
        img = scipy.ndimage.gaussian_filter(img, 1.2) + rng.normal(0, 0.5, img.shape)
        imgs.append(np.clip(img * 4.0, 0, 255).astype(np.float32))
    return np.stack(imgs)


def _replay(keys):
    """A port sampler that hands out the JAX package's draws for `keys`, one
    key per RANSAC call, in call order (tests/test_torch_pipeline.py)."""
    keys = list(keys)

    def sampler(h, n, s, valid):
        key = keys.pop(0)
        v = None if valid is None else jnp.asarray(valid.numpy())
        return np.asarray(jransac.sample_indices(key, h, n, s, v))

    return sampler


@pytest.mark.parametrize("frame", [3, 4])
def test_one_batched_step_from_a_jax_state(frame):
    """Two distinct lanes bootstrapped by the JAX package, stacked as
    run_multiseq.py stacks them, stepped by `jax` batched_vo_step; the port
    steps the same batched state, carried across by state_from_numpy, with
    each lane's own JAX draws replayed. Frame 3 runs PnP; frame 4 also pushes
    a keyframe and runs BA in both lanes."""
    jcfg = JaxConfig(capacity=CAP2)
    cfg = VOConfig(capacity=CAP2)
    lanes = [_dot_frames(2023), _dot_frames(77)]
    K = jnp.asarray(K_DOTS)
    jstates = []
    for i, f in enumerate(lanes):
        st, out = jpipe.bootstrap(jnp.asarray(f[0]), jnp.asarray(f[2]), K, jcfg,
                                  jax.random.PRNGKey(1 + i))
        assert bool(out.pose_ok)
        jstates.append(st)
    prev = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jstates)
    Ks = jnp.broadcast_to(K, (2, 3, 3))
    for i in range(3, frame):
        prev, _ = jmulti.batched_vo_step(prev, jnp.asarray(np.stack([f[i] for f in lanes])),
                                         Ks, jcfg)
    imgs = np.stack([f[frame] for f in lanes])
    jst, want = jmulti.batched_vo_step(prev, jnp.asarray(imgs), Ks, jcfg)

    samplers = []
    for b in range(2):
        _, k_pnp, k_rec = jax.random.split(prev.rng[b], 3)
        samplers.append(_replay([k_pnp, k_rec]))
    st = tpipe.state_from_numpy(prev, "cpu", samplers)
    assert st.table.xy.shape == (2, CAP2, 2) and st.pose.shape == (2, 4, 4)
    st, out = tmulti.batched_vo_step(st, T(imgs), T(np.asarray(Ks)), cfg)

    np.testing.assert_array_equal(N(st.last_kf_idx), N(jst.last_kf_idx))
    np.testing.assert_array_equal(N(out.pose_ok), N(want.pose_ok))
    assert bool(N(want.pose_ok).all())
    if frame == 4:
        assert N(jst.last_kf_idx).tolist() == [4, 4]
    # The tolerances of test_one_step_from_a_jax_state: pose 1e-4 (f32 LK, GN
    # and BA sums in another order), counts within 1, table lifecycle states
    # and uids exact, positions 1e-3 px, landmarks 1e-3 relative.
    np.testing.assert_allclose(N(out.pose), N(want.pose), atol=1e-4)
    for name in ("num_tracked", "num_pnp_inliers", "num_triangulated", "num_new_landmarks"):
        assert np.abs(N(getattr(out, name)) - N(getattr(want, name))).max() <= 1, name
    np.testing.assert_array_equal(N(st.table.state), N(jst.table.state))
    np.testing.assert_array_equal(N(st.table.uid), N(jst.table.uid))
    np.testing.assert_array_equal(N(st.next_uid), N(jst.next_uid))
    live = N(jst.table.state) >= 0
    np.testing.assert_allclose(N(st.table.xy)[live], N(jst.table.xy)[live], atol=1e-3)
    tri = N(jst.table.state) == 2
    np.testing.assert_allclose(N(st.table.landmark)[tri], N(jst.table.landmark)[tri],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(N(st.window.kf_valid), N(jst.window.kf_valid))
    # And back: a batched state round-trips through numpy.
    back = tpipe.state_to_numpy(st)
    assert back["pose"].shape == (2, 4, 4) and back["table"]["state"].dtype == np.int32
    with pytest.raises(ValueError, match="samplers"):
        tpipe.state_from_numpy(prev, "cpu", [torch.Generator()] * 3)


# ---------------------------------------------------------------------------
# (e) per-lane keyframe policy in one batched program
# ---------------------------------------------------------------------------

def test_per_lane_keyframe_policy_diverges_in_one_program():
    """kf_adaptive is a lane parameter: one lockstep rollout runs fixed
    cadence on lane 0 and the adaptive gates on lane 1. A stationary camera
    separates them: fixed cadence keeps pushing keyframes while the adaptive
    policy (correctly) pushes none."""
    cfg = small_cfg()
    frames = noise_frames(0, 3)
    st = _bootstrap(frames, 7)
    b = 2
    states = tmulti.replicate_state(st, b, [st.rng, _bootstrap(frames, 7).rng])
    states = states._replace(kf_adaptive=torch.tensor([False, True]))
    Ks = T(K_SMALL).expand(b, 3, 3).contiguous()
    # Stationary: every frame equals the bootstrap frame.
    bstack = T(np.stack([np.stack([frames[2]] * b)] * 6))
    final, outs = tmulti.batched_vo_rollout(states, bstack, Ks, cfg)
    last_kf = N(final.last_kf_idx)
    # Fixed cadence pushed through the stop; adaptive pushed nothing after
    # the bootstrap keyframe (frame_gap = 2).
    assert last_kf[0] > 2, last_kf
    assert last_kf[1] == 2, last_kf
    # Both lanes stayed healthy (tracking a static scene is trivial).
    assert bool(outs.pose_ok.all())


# ---------------------------------------------------------------------------
# (f) a lane whose PnP fails beside a healthy lane
# ---------------------------------------------------------------------------

class _CountingSampler:
    """A generator-backed sampler that records every draw it is asked for."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)
        self.calls = []

    def __call__(self, h, n, s, valid):
        self.calls.append((h, s))
        return transac.sample_indices(self.gen, h, n, s, valid)


def test_a_failing_lane_leaves_its_neighbour_alone():
    """Lane 1 sees unrelated noise after the bootstrap, so its PnP fails and
    the recovery RANSAC runs; lane 0 is healthy. Lane 0 must draw exactly
    what it draws alone (one PnP draw a step, no recovery draw) and give
    exactly the result of its single rollout."""
    cfg = small_cfg()
    good = noise_frames(0, 7)
    lost = noise_frames(0, 7)
    lost[3:] = np.random.default_rng(99).uniform(0, 255, lost[3:].shape)
    n_pnp, n_rec = cfg.pnp.num_hypotheses, cfg.recovery.num_hypotheses

    alone = _CountingSampler(5)
    st = _bootstrap(good, 7)._replace(rng=alone)
    _, single = tpipe.vo_rollout(st, T(good[3:]), T(K_SMALL), cfg)
    assert bool(single.pose_ok.all())
    assert alone.calls == [(n_pnp, 4)] * 4

    healthy, failing = _CountingSampler(5), _CountingSampler(6)
    states = tmulti.stack_states([_bootstrap(good, 7)._replace(rng=healthy),
                                  _bootstrap(lost, 7)._replace(rng=failing)])
    Ks = T(K_SMALL).expand(2, 3, 3).contiguous()
    _, outs = tmulti.batched_vo_rollout(states, T(np.stack([good, lost], axis=1)[3:]), Ks, cfg)
    assert not bool(outs.pose_ok[:, 1].any())  # the neighbour really failed
    assert failing.calls == [(n_pnp, 4), (n_rec, 8)] * 4  # PnP, then its recovery
    assert healthy.calls == alone.calls  # no draw was added to the healthy lane
    np.testing.assert_array_equal(N(outs.pose[:, 0]), N(single.pose))
    np.testing.assert_array_equal(N(outs.num_triangulated[:, 0]), N(single.num_triangulated))
    assert bool(torch.isfinite(outs.pose).all()) and not bool(outs.frozen.any())


# ---------------------------------------------------------------------------
# (g) what is not ported, and the run_multiseq_torch.py script
# ---------------------------------------------------------------------------

class _RankOfTwo:
    """The mesh calls the lane placements make, as rank 1 of two on "data"."""

    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return (2, 1)[dim]

    def get_local_rank(self, axis):
        return {"data": 1, "model": 0}[axis]


@pytest.mark.parametrize("name", ["shard_batched_state", "make_sharded_rollout"])
def test_mesh_placements_are_not_ported(name):
    """The placements were the unported half of this module; they are ported
    now (tests/test_torch_dist.py runs them over real ranks). Here, without a
    process group: rank 1 of two holds lanes 2-3 with their own samplers, and
    its rollout is the batched rollout of those lanes."""
    cfg = small_cfg()
    frames = noise_frames(0, 5)
    st = _bootstrap(frames, 7)
    gens = [torch.Generator().manual_seed(i) for i in range(4)]
    mine = tmulti.shard_batched_state(tmulti.replicate_state(st, 4, gens), _RankOfTwo())
    assert mine.rng == gens[2:] and mine.table.xy.shape == (2, CAP, 2)
    with pytest.raises(ValueError, match="split"):
        tmulti.shard_batched_state(tmulti.replicate_state(st, 3, gens[:3]), _RankOfTwo())
    if name == "make_sharded_rollout":
        images = T(np.stack([np.stack([im] * 2) for im in frames[3:5]]))
        Ks = T(K_SMALL).expand(2, 3, 3).contiguous()
        _, got = tmulti.make_sharded_rollout(_RankOfTwo(), cfg)(mine, images, Ks)
        again = tmulti.shard_batched_state(tmulti.replicate_state(
            st, 4, [torch.Generator().manual_seed(i) for i in range(4)]), _RankOfTwo())
        _, want = tmulti.batched_vo_rollout(again, images, Ks, cfg)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(N(a), N(b))


def test_run_multiseq_torch_needs_cuda_unless_asked():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "run_multiseq_torch.py", "--full"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert '"metric"' not in proc.stdout
    proc = subprocess.run([sys.executable, "run_multiseq_torch.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and "--full" in proc.stderr


def test_run_multiseq_torch_on_cpu_small(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    import run_multiseq_torch as runner

    from vo_tpu_torch.data import synthetic as tsyn

    small = dataclasses.replace(tsyn.DEFAULT_SPEC, width=160, height=120, focal=104.0)
    monkeypatch.setattr(tsyn, "DEFAULT_SPEC", small)
    rc = runner.main(["--full", "--device", "cpu", "--full-frames", "8", "--full-lanes", "2",
                      "--capacity", "128", "--no-kernels"])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    report = lines[-1]
    assert set(report) == {"metric", "lanes", "batch", "steps", "agg_fps", "device"}
    assert report["metric"] == "multiseq_full" and report["batch"] == 2
    assert report["steps"] == 5 and report["device"] == "cpu" and report["agg_fps"] > 0
    assert [lane["lane"] for lane in report["lanes"]] == ["city_lr", "city_rl", "distorted"]
    assert lines[:-1] == report["lanes"]
    assert all(lane["finite"] for lane in report["lanes"])
    assert tsyn.select_lanes(["a", "b", "c"], "c,a") == ["c", "a"]
    assert tsyn.select_lanes(["a", "b", "c"], "0") == ["a", "b", "c"]
    with pytest.raises(ValueError, match="unknown lanes"):
        tsyn.select_lanes(["a"], "z")
