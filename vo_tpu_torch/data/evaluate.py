"""Trajectory evaluation: Umeyama alignment, ATE RMSE, RPE — the port's own
numpy copy of vo_tpu/data/evaluate.py (tests/test_torch_no_jax.py holds the
two equal on seeded trajectories). Monocular VO is scale-free, so alignment
is similarity (Sim3) by default.
"""

from __future__ import annotations

import numpy as np


def align_umeyama(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform: dst ~ s * R @ src + t.

    src/dst: (N, 3). Returns (s, R, t). Umeyama (1991) closed form.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_positions: np.ndarray, gt_positions: np.ndarray, with_scale: bool = True
) -> float:
    """Absolute trajectory error RMSE after (Sim3 by default) alignment.

    est/gt: (N, 3) camera centers, row-aligned by frame index.
    """
    s, R, t = align_umeyama(est_positions, gt_positions, with_scale)
    aligned = (s * (R @ np.asarray(est_positions, np.float64).T)).T + t
    err = np.linalg.norm(aligned - np.asarray(gt_positions, np.float64), axis=1)
    return float(np.sqrt((err**2).mean()))


def rpe(
    est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
) -> tuple[float, float]:
    """Relative pose error over `delta`-frame intervals.

    est/gt: (N, 4, 4) w_T_c poses. Returns (trans RMSE in gt units,
    rot RMSE in radians). Scale of est is corrected globally first.
    """
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    s, _, _ = align_umeyama(est[:, :3, 3], gt[:, :3, 3])
    est = est.copy()
    est[:, :3, 3] *= s
    terrs, rerrs = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        err = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(err[:3, 3]))
        ang = np.clip((np.trace(err[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rerrs.append(np.arccos(ang))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(
        np.sqrt(np.mean(np.square(rerrs)))
    )


def positions_from_poses(poses: np.ndarray) -> np.ndarray:
    """(N, 4, 4) w_T_c -> (N, 3) camera centers."""
    return np.asarray(poses)[:, :3, 3]
