"""Fixed-capacity feature/landmark table — port of
vo_tpu/models/feature_table.py.

A table of `capacity` SLOTS; a slot carries one track through its whole
lifecycle:

    -1 empty        (no track)
     0 unmatched    (fresh detection, not yet tracked to a second frame)
     1 matched      (tracked >= once; a triangulation CANDIDATE)
     2 triangulated (carries a world landmark)

All updates are masked `where`s and out-of-place scatters, so slot identity
IS track identity.

Every field may carry a leading lane axis (B, K, ...): the updates then act
per lane (free-slot order, detection ranks and uids are each lane's own).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

STATE_EMPTY = -1
STATE_UNMATCHED = 0
STATE_MATCHED = 1
STATE_TRIANGULATED = 2


class FeatureTable(NamedTuple):
    xy: torch.Tensor  # (K, 2) f32 current keypoint position
    landmark: torch.Tensor  # (K, 3) f32 world landmark (state==2 only)
    state: torch.Tensor  # (K,) int32 lifecycle state
    track_xy: torch.Tensor  # (K, 2) f32 track-start pixel
    track_pose: torch.Tensor  # (K, 16) f32 w_T_c at track start
    uid: torch.Tensor  # (K,) int32 stable track identity
    score: torch.Tensor  # (K,) f32 detector response at birth
    desc: torch.Tensor  # (K, D) f32 descriptor of the last match (D=1: unused)
    sigma: torch.Tensor  # (K,) f32 detection scale (SIFT); 0 = base scale
    miss: torch.Tensor  # (K,) int32 consecutive unmatched frames (0 in KLT)

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


def empty_table(capacity: int, desc_dim: int = 1, device=None) -> FeatureTable:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return FeatureTable(
        xy=torch.zeros((capacity, 2), **f32),
        landmark=torch.zeros((capacity, 3), **f32),
        state=torch.full((capacity,), STATE_EMPTY, **i32),
        track_xy=torch.zeros((capacity, 2), **f32),
        track_pose=torch.eye(4, **f32).reshape(1, 16).repeat(capacity, 1),
        uid=torch.zeros((capacity,), **i32),
        score=torch.zeros((capacity,), **f32),
        desc=torch.zeros((capacity, desc_dim), **f32),
        sigma=torch.zeros((capacity,), **f32),
        miss=torch.zeros((capacity,), **i32),
    )


def restart_tracks(
    table: FeatureTable, mask: torch.Tensor, pose_flat: torch.Tensor
) -> FeatureTable:
    """Reset masked slots to fresh unmatched tracks starting at their current
    position and the current pose (ref state.py:162-172)."""
    m = mask[..., None]
    return table._replace(
        state=torch.where(mask, STATE_UNMATCHED, table.state).to(torch.int32),
        track_xy=torch.where(m, table.xy, table.track_xy),
        track_pose=torch.where(m, pose_flat[..., None, :], table.track_pose),
    )


def _scatter_drop(dst: torch.Tensor, index: torch.Tensor, src) -> torch.Tensor:
    """dst.at[index].set(src, mode="drop") along the slot axis, for index
    (..., C) in [0, K] against dst (..., K, *tail): row K is a scratch row
    that swallows the dropped writes. The kept targets are distinct."""
    dim = index.ndim - 1
    k = dst.shape[dim]
    tail = dst.shape[dim + 1:]
    ext = torch.cat([dst, dst.narrow(dim, 0, 1)], dim=dim)
    idx = index.reshape(index.shape + (1,) * len(tail)).expand(index.shape + tail)
    if torch.is_tensor(src):
        ext = ext.scatter(dim, idx, src.to(dst.dtype).expand(idx.shape))
    else:
        ext = ext.scatter(dim, idx, src)
    return ext.narrow(dim, 0, k)


def fill_free_slots(
    table: FeatureTable,
    det_xy: torch.Tensor,  # (..., C, 2) candidate detections (strongest first)
    det_score: torch.Tensor,  # (..., C)
    det_ok: torch.Tensor,  # (..., C) bool eligible (valid + far from live tracks)
    pose_flat: torch.Tensor,  # (..., 16) current w_T_c
    next_uid: torch.Tensor,  # (...) int32
    det_desc: torch.Tensor | None = None,  # (..., C, D)
    det_sigma: torch.Tensor | None = None,  # (..., C)
) -> tuple[FeatureTable, torch.Tensor]:
    """Scatter eligible detections into empty slots (r-th eligible detection
    -> r-th free slot, free slots in index order). Returns (table, new
    next_uid)."""
    k = table.capacity
    free = table.state == STATE_EMPTY
    free_order = torch.argsort(torch.where(free, 0, 1), stable=True)  # free first
    n_free = free.sum(dim=-1, keepdim=True)
    det_rank = torch.cumsum(det_ok.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    use = det_ok & (det_rank < n_free)
    target = torch.take_along_dim(free_order, torch.clamp(det_rank, 0, k - 1).long(), dim=-1)
    safe_target = torch.where(use, target, k)  # k = dropped
    new_uid = (next_uid[..., None] + det_rank).to(torch.int32)

    state = _scatter_drop(table.state, safe_target, STATE_UNMATCHED)
    desc = table.desc
    if det_desc is not None:
        desc = _scatter_drop(desc, safe_target, det_desc)
    sigma = _scatter_drop(
        table.sigma, safe_target,
        det_sigma if det_sigma is not None else torch.zeros_like(det_score),
    )
    new_table = table._replace(
        xy=_scatter_drop(table.xy, safe_target, det_xy),
        score=_scatter_drop(table.score, safe_target, det_score),
        state=state,
        track_xy=_scatter_drop(table.track_xy, safe_target, det_xy),
        track_pose=_scatter_drop(
            table.track_pose, safe_target,
            pose_flat[..., None, :].expand(det_xy.shape[:-1] + (16,))),
        uid=_scatter_drop(table.uid, safe_target, new_uid),
        desc=desc,
        sigma=sigma,
        miss=_scatter_drop(table.miss, safe_target, 0),
    )
    return new_table, (next_uid + use.sum(dim=-1)).to(torch.int32)


def debug_validate(table: FeatureTable) -> list[str]:
    """Host-side invariant checks (the reference's runtime asserts as a
    validator). Returns a list of violation messages (empty = valid); a
    batched table is checked lane by lane, messages prefixed by the lane."""
    if table.state.ndim > 1:
        return [
            f"lane {b}: {msg}"
            for b in range(table.state.shape[0])
            for msg in debug_validate(FeatureTable(*(f[b] for f in table)))
        ]
    xy = table.xy.cpu().numpy()
    lm = table.landmark.cpu().numpy()
    st = table.state.cpu().numpy()
    txy = table.track_xy.cpu().numpy()
    tp = table.track_pose.cpu().numpy()
    uid = table.uid.cpu().numpy()
    ms = table.miss.cpu().numpy()
    k = st.shape[0]
    errs: list[str] = []

    def chk(cond, msg):
        if not cond:
            errs.append(msg)

    chk(xy.shape == (k, 2), f"xy shape {xy.shape} != ({k}, 2)")
    chk(lm.shape == (k, 3), f"landmark shape {lm.shape} != ({k}, 3)")
    chk(txy.shape == (k, 2), f"track_xy shape {txy.shape} != ({k}, 2)")
    chk(tp.shape == (k, 16), f"track_pose shape {tp.shape} != ({k}, 16)")
    chk(bool(np.isin(st, [-1, 0, 1, 2]).all()), "state outside {-1,0,1,2}")
    chk(ms.shape == (k,), f"miss shape {ms.shape} != ({k},)")
    chk(bool((ms >= 0).all()), "negative miss counter")
    live = st >= 0
    chk(bool(np.isfinite(xy[live]).all()), "non-finite keypoint on live slot")
    chk(bool(np.isfinite(txy[live]).all()), "non-finite track_xy on live slot")
    chk(bool(np.isfinite(tp[live]).all()), "non-finite track_pose on live slot")
    tri = st == 2
    chk(bool(np.isfinite(lm[tri]).all()), "non-finite landmark on state==2")
    if live.any():
        bottom = tp[live].reshape(-1, 4, 4)[:, 3, :]
        chk(
            bool(np.allclose(bottom, [0.0, 0.0, 0.0, 1.0], atol=1e-5)),
            "track_pose bottom row != [0,0,0,1]",
        )
    chk(len(np.unique(uid[live])) == int(live.sum()), "duplicate uid on live slots")
    return errs
