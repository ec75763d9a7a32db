"""Trajectory evaluation (Umeyama alignment, ATE RMSE, RPE) — the reference's
numpy module vo_tpu/data/evaluate.py itself, loaded by file path (see
vo_tpu_torch/_shared.py)."""

from vo_tpu_torch._shared import load

_evaluate = load("data/evaluate.py")

align_umeyama = _evaluate.align_umeyama
ate_rmse = _evaluate.ate_rmse
positions_from_poses = _evaluate.positions_from_poses
rpe = _evaluate.rpe

__all__ = ["align_umeyama", "ate_rmse", "positions_from_poses", "rpe"]
