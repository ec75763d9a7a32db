"""Sequence-parallel bundle adjustment: the BA window grows with ranks —
port of vo_tpu/parallel/window_blocks.py.

`dist_ba` shards LANDMARK rows: map capacity scales with the ranks, the
keyframe window stays W. This module shards the KEYFRAME axis instead. A
composed window of W_eff = ranks * W_block keyframes: each rank holds only
its block's keyframe state (kf_pose, kf_valid: (W_block,)) and observations
(obs_uv, obs_mask: (L, W_block, ...)), the memory that bounds the window on
one device. Landmarks are replicated.

Per GN iteration (the single-device Schur step of models/ba.py, with the
sums placed per tensor):

  residuals/Jacobians        local        (L, W_block) sweep
  camera blocks U, b_c       local        per keyframe
  landmark blocks V, b_x     all-reduce   every landmark seen from several
                                          blocks couples them here
  cross blocks Wc            local        (L, W_block, 6, 3)
  Schur fill-in S[w, v]      all-gather   of Wc, then of the S rows and b_red
  reduced (6 W_eff) solve    every rank   kernels.ba_solve on the same numbers
  landmark back-substitution all-reduce   partial Wc^T dc sums

then the global gauge (the oldest valid keyframe of ALL blocks), the scale
fix between the two oldest valid keyframes and the finite veto, reduced over
the blocks. The result equals `ba_refine` on the whole composed window to
f32 rounding (the all-reduces reorder sums that the 1e8 gauge amplifies).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from vo_tpu_torch.geom.lie import pose_inverse, se3_exp
from vo_tpu_torch.models.ba import (
    _GAUGE,
    BAWindow,
    _inv3,
    _masked_mean,
    _obs_mask,
    _residuals_jacobians,
    _two_oldest_valid,
    where_window,
)
from vo_tpu_torch.ops.kernels import ba_solve
from vo_tpu_torch.parallel.mesh import (
    all_gather,
    axis_index,
    axis_size,
    broadcast,
    local_rows,
    psum,
)


def window_block_specs() -> BAWindow:
    """The dimension of each field that is sharded over "model" (the keyframe
    axis); None = replicated landmark state. The transpose of dist_ba's."""
    return BAWindow(kf_pose=0, kf_valid=0, obs_uv=1, obs_mask=1,
                    landmark=None, lm_uid=None, lm_valid=None)


def shard_window_blocks(window: BAWindow, mesh: DeviceMesh, axis: str = "model") -> BAWindow:
    """This rank's keyframe block of a composed W_eff window given whole on
    every rank (W_eff must divide by the axis size); the landmark state as
    the first rank of the axis has it."""
    return BAWindow(*(
        broadcast(x, mesh, axis) if dim is None else local_rows(x, mesh, axis, dim)
        for x, dim in zip(window, window_block_specs())))


def gather_window_blocks(window: BAWindow, mesh: DeviceMesh, axis: str = "model") -> BAWindow:
    """The composed window from every rank's block (the inverse of
    `shard_window_blocks`), on every rank."""
    return BAWindow(*(
        x if dim is None else all_gather(x, mesh, axis, dim)
        for x, dim in zip(window, window_block_specs())))


def _masked_err(win: BAWindow, K: torch.Tensor, reduce) -> torch.Tensor:
    r, _, _, depth_ok = _residuals_jacobians(win.kf_pose, win.landmark, win.obs_uv, K)
    return _masked_mean(torch.linalg.vector_norm(r, dim=-1), _obs_mask(win, depth_ok), reduce)


def seqpar_ba_refine(
    mesh: DeviceMesh,
    window: BAWindow,
    K: torch.Tensor,
    iters: int = 5,
    damping: float = 1e-3,
    huber_px: float = 2.0,
    fix_scale: bool = True,
    axis: str = "model",
) -> tuple[BAWindow, torch.Tensor]:
    """`ba_refine` over a composed window whose keyframe axis is sharded over
    `axis` (`shard_window_blocks`). Returns (this rank's refined block, the
    (iters,) error trace), with the same accept-only-if-the-error-did-not-grow
    gate as the single-device solver, decided alike on every rank."""
    if axis != "model":
        raise ValueError("keyframe blocks shard over the 'model' axis")
    n_shards, shard = axis_size(mesh, axis), axis_index(mesh, axis)
    Wb = window.window_size
    W_eff = n_shards * Wb
    K = broadcast(K, mesh, axis)
    dev = K.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    local_w = shard * Wb + torch.arange(Wb, device=dev)
    diag = torch.arange(W_eff, device=dev)

    def reduce(x):
        return psum(x, mesh, axis)

    def gather_kf(x, dim):
        return all_gather(x, mesh, axis, dim)

    kf_valid_all = gather_kf(window.kf_valid, 0)

    def gn_step(win: BAWindow):
        r, Jc, Jx, depth_ok = _residuals_jacobians(win.kf_pose, win.landmark, win.obs_uv, K)
        mask = _obs_mask(win, depth_ok)
        rn = torch.linalg.vector_norm(r, dim=-1)
        wgt = torch.where(rn > huber_px, huber_px / torch.clamp(rn, min=1e-9), 1.0)
        m = (mask * wgt)[..., None, None]
        err = _masked_mean(rn, mask, reduce)

        Jc_m = Jc * m
        U = torch.einsum("lwia,lwib->wab", Jc_m, Jc)  # (Wb, 6, 6) local
        bc = (Jc_m * r[..., None]).sum(dim=-2).sum(dim=-3)  # (Wb, 6) local
        Jx_m = Jx * m
        # Landmark blocks couple every block observing the landmark: the
        # all-reduce is the exchange on the shared-landmark boundary.
        V = reduce(torch.einsum("lwia,lwib->lab", Jx_m, Jx))
        bx = reduce((Jx_m * r[..., None]).sum(dim=-2).sum(dim=-2))
        Wc = torch.einsum("lwia,lwib->lwab", Jc_m, Jx)  # (L, Wb, 6, 3) local

        V = V + damping * eye3
        Vinv = _inv3(V) * win.lm_valid[:, None, None]
        WVi = torch.einsum("lwab,lbc->lwac", Wc, Vinv)  # (L, Wb, 6, 3) local

        # Cross-block Schur fill-in S[w, v] = -sum_l WVi[l, w] Wc[l, v]^T
        # needs every block's Wc.
        Wc_all = gather_kf(Wc, 1)  # (L, W_eff, 6, 3)
        S_rows = -torch.einsum("lwac,lvbc->wvab", WVi, Wc_all)  # (Wb, W_eff, 6, 6)
        S_rows[torch.arange(Wb, device=dev), local_w] += U + damping * eye6
        S = gather_kf(S_rows, 0)  # (W_eff, W_eff, 6, 6) on every rank
        b_red = gather_kf(bc - (WVi * bx[:, None, None, :]).sum(dim=-1).sum(dim=-3), 0)

        # Gauge on the oldest valid keyframe of all blocks; pin dead rows.
        first = torch.argmax(kf_valid_all.to(torch.int32))
        S[first, first] += _GAUGE * eye6
        S[diag, diag] += (~kf_valid_all)[:, None, None] * _GAUGE * eye6

        delta_c = ba_solve(S, -b_red)  # (W_eff, 6)
        solve_ok = torch.isfinite(delta_c).all()
        delta_c = torch.where(solve_ok, delta_c, 0.0)
        delta_c = torch.where(kf_valid_all[:, None], delta_c, 0.0)
        dc_loc = delta_c[shard * Wb:(shard + 1) * Wb]

        # Landmark back-substitution: V dx = -bx - sum_w Wc^T dc over ALL
        # blocks, so the local partial sum is all-reduced.
        cross = reduce((Wc * dc_loc[None, :, :, None]).sum(dim=(-3, -2)))
        delta_x = (Vinv * (-bx - cross)[:, None, :]).sum(dim=-1)
        delta_x = torch.where(
            solve_ok & torch.isfinite(delta_x).all(dim=-1, keepdim=True), delta_x, 0.0)

        T_cw = pose_inverse(win.kf_pose.reshape(-1, 4, 4))
        kf_pose = pose_inverse(se3_exp(dc_loc) @ T_cw).reshape(Wb, 16)
        landmark = win.landmark + torch.where(win.lm_valid[:, None], delta_x, 0.0)
        return win._replace(kf_pose=kf_pose, landmark=landmark), err

    err0 = _masked_err(window, K, reduce)
    centers0 = gather_kf(window.kf_pose.reshape(-1, 4, 4)[:, :3, 3], 0)
    i0, i1, has2 = _two_oldest_valid(kf_valid_all)
    d_before = torch.linalg.vector_norm(centers0[i1] - centers0[i0])

    refined = window
    errs = []
    for _ in range(iters):
        refined, err = gn_step(refined)
        errs.append(err)

    if fix_scale:
        poses = refined.kf_pose.reshape(-1, 4, 4).clone()
        centers_all = gather_kf(poses[:, :3, 3], 0)
        anchor = centers_all[i0]
        d_after = torch.linalg.vector_norm(centers_all[i1] - anchor)
        s = torch.where(has2 & (d_after > 1e-9), d_before / d_after, 1.0)
        poses[:, :3, 3] = anchor + s * (poses[:, :3, 3] - anchor)
        refined = refined._replace(kf_pose=poses.reshape(-1, 16),
                                   landmark=anchor + s * (refined.landmark - anchor))

    err1 = _masked_err(refined, K, reduce)
    # The explicit finite veto of ba_refine, reduced over all blocks.
    bad = reduce((~torch.isfinite(refined.kf_pose)).sum()
                 + (refined.lm_valid[:, None] & ~torch.isfinite(refined.landmark)).sum())
    accept = torch.isfinite(err1) & (err1 <= err0 * 1.02) & (bad == 0)
    return where_window(accept, refined, window), torch.stack(errs)
