"""Trajectory evaluation: Umeyama Sim(3) alignment and ATE RMSE — the
benchmark's frozen copy of vo_tpu_torch/data/evaluate.py (itself a copy of
the JAX package's numpy). Monocular VO is scale-free, so alignment is a
similarity. `vobench/tests` holds the copy to the port's source.
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


def positions_from_poses(poses: np.ndarray) -> np.ndarray:
    """(N, 4, 4) w_T_c -> (N, 3) camera centers."""
    return np.asarray(poses)[:, :3, 3]
