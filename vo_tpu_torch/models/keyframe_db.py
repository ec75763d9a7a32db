"""Long-term keyframe database + appearance loop closure — port of
vo_tpu/models/keyframe_db.py. The long-term memory behind the pose graph
(models/pose_graph.py):

  * fixed-capacity entry store, 1:1 with pose-graph node ids (append order;
    culling compacts both stores with the same permutation);
  * per entry: pose, frame id, a **global appearance descriptor** (normalized
    anti-aliased thumbnail; retrieval is one cosine-similarity product), and
    M local observations (pixel, world landmark, normalized intensity patch)
    for geometric verification;
  * **loop detection** = gdesc product + frame-gap gate; **verification** =
    mutual-ratio descriptor matching (ops/descriptors.py) + P3P RANSAC of
    the OLD entry's landmarks against the CURRENT keyframe's pixels
    (ops/pnp.py), then a Sim(3) edge from the inlier 3D-3D pairs.

Fixed capacities and masked appends throughout; the caller invokes these
once per pose-graph keyframe, not per frame.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from vo_tpu_torch.geom.lie import det3, pose_inverse
from vo_tpu_torch.geom.points import to_homogeneous as to_h
from vo_tpu_torch.ops.descriptors import extract_patches, match_descriptors
from vo_tpu_torch.ops.harris import top_k
from vo_tpu_torch.ops.pnp import pnp_ransac
from vo_tpu_torch.ops.ransac import Samplers


class KeyframeEntry(NamedTuple):
    pose: torch.Tensor  # (16,) w_T_c
    frame: torch.Tensor  # () int32
    gdesc: torch.Tensor  # (G,) normalized global descriptor
    obs_xy: torch.Tensor  # (M, 2)
    obs_lm: torch.Tensor  # (M, 3) world landmarks at entry time
    obs_desc: torch.Tensor  # (M, D) normalized intensity patches
    obs_valid: torch.Tensor  # (M,) bool


class KeyframeDB(NamedTuple):
    pose: torch.Tensor  # (N, 16)
    frame: torch.Tensor  # (N,) int32
    valid: torch.Tensor  # (N,) bool
    gdesc: torch.Tensor  # (N, G)
    obs_xy: torch.Tensor  # (N, M, 2)
    obs_lm: torch.Tensor  # (N, M, 3)
    obs_desc: torch.Tensor  # (N, M, D)
    obs_valid: torch.Tensor  # (N, M)

    @property
    def capacity(self) -> int:
        return self.pose.shape[0]

    @property
    def n_entries(self) -> torch.Tensor:
        return self.valid.sum()


def empty_db(
    num_entries: int,
    obs_per_entry: int = 256,
    patch_radius: int = 4,
    grid: int = 16,
    device=None,
) -> KeyframeDB:
    d = (2 * patch_radius + 1) ** 2
    f32 = dict(dtype=torch.float32, device=device)
    return KeyframeDB(
        pose=torch.eye(4, **f32).reshape(1, 16).repeat(num_entries, 1),
        frame=torch.full((num_entries,), -1, dtype=torch.int32, device=device),
        valid=torch.zeros((num_entries,), dtype=torch.bool, device=device),
        gdesc=torch.zeros((num_entries, grid * grid), **f32),
        obs_xy=torch.zeros((num_entries, obs_per_entry, 2), **f32),
        obs_lm=torch.zeros((num_entries, obs_per_entry, 3), **f32),
        obs_desc=torch.zeros((num_entries, obs_per_entry, d), **f32),
        obs_valid=torch.zeros((num_entries, obs_per_entry), dtype=torch.bool, device=device),
    )


@functools.lru_cache(maxsize=16)
def _resize_weights(input_size: int, output_size: int) -> np.ndarray:
    """(input_size, output_size) f32 weights of an anti-aliased linear
    resize: a triangle kernel widened by the shrink factor, sampled at the
    half-pixel centres and normalized per output sample — the weights
    `jax.image.resize(..., "linear")` builds. `F.interpolate(bilinear)` is
    another function: it takes two taps where this averages input_size /
    output_size of them."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(output_size) / f32(input_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(output_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(input_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def global_descriptor(image: torch.Tensor, grid: int = 16) -> torch.Tensor:
    """Mean-pooled thumbnail, zero-mean / unit-norm: cheap, rotation-variant
    (fine for forward-facing VO), illumination-bias-free via the mean/norm
    normalization. The thumbnail is two products with the resize weights."""
    img = image.to(torch.float32)
    h, w = img.shape
    wy = torch.as_tensor(_resize_weights(h, grid), device=img.device)  # (H, grid)
    wx = torch.as_tensor(_resize_weights(w, grid), device=img.device)  # (W, grid)
    thumb = wy.T @ img @ wx
    v = thumb.reshape(-1)
    v = v - v.mean()
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-6)


def make_entry(
    image: torch.Tensor,  # (H, W) current frame
    xy: torch.Tensor,  # (K, 2) table keypoints
    landmark: torch.Tensor,  # (K, 3) table landmarks
    score: torch.Tensor,  # (K,) detector responses
    triangulated: torch.Tensor,  # (K,) bool
    pose: torch.Tensor,  # (4, 4) w_T_c
    frame,  # () int32
    obs_per_entry: int = 256,
    patch_radius: int = 4,
    grid: int = 16,
) -> KeyframeEntry:
    """Snapshot the current frame's triangulated map slots as a DB entry.

    Top `obs_per_entry` slots by detector score (among equal scores the
    lower slot first); intensity patches are re-extracted from the image at
    the CURRENT keypoint position."""
    img = image.to(torch.float32)
    masked = torch.where(triangulated, score, -float("inf"))
    _, top = top_k(masked, obs_per_entry)
    sel_valid = triangulated[top]
    sel_xy = xy[top]
    desc = extract_patches(img, sel_xy, radius=patch_radius, normalize=True)
    return KeyframeEntry(
        pose=pose.reshape(16),
        frame=torch.as_tensor(frame, dtype=torch.int32, device=img.device),
        gdesc=global_descriptor(img, grid),
        obs_xy=sel_xy,
        obs_lm=landmark[top],
        obs_desc=torch.where(sel_valid[:, None], desc, 0.0),
        obs_valid=sel_valid,
    )


def add_entry(db: KeyframeDB, entry: KeyframeEntry) -> KeyframeDB:
    """Masked append (no-op when full — cull first, mirroring the graph)."""
    k = db.n_entries
    ok = k < db.capacity
    idx = torch.where(ok, k, 0)

    def wr(arr, row):
        out = arr.clone()
        out[idx] = torch.where(ok, row.to(arr.dtype), arr[idx])
        return out

    return KeyframeDB(
        pose=wr(db.pose, entry.pose),
        frame=wr(db.frame, entry.frame),
        valid=wr(db.valid, ok),
        gdesc=wr(db.gdesc, entry.gdesc),
        obs_xy=wr(db.obs_xy, entry.obs_xy),
        obs_lm=wr(db.obs_lm, entry.obs_lm),
        obs_desc=wr(db.obs_desc, entry.obs_desc),
        obs_valid=wr(db.obs_valid, entry.obs_valid),
    )


def cull_entry(db: KeyframeDB, victim) -> KeyframeDB:
    """Compact out row `victim` — the same gather permutation as
    pose_graph.cull_node, so DB rows stay 1:1 with graph node ids."""
    dev = db.pose.device
    v = torch.as_tensor(victim, device=dev).long()
    n = db.n_entries
    ok = (v >= 0) & (v < n) & db.valid[torch.clamp(v, 0, db.capacity - 1)]
    idx = torch.arange(db.capacity, device=dev)
    src = torch.where(idx < v, idx, torch.clamp(idx + 1, max=db.capacity - 1))
    last = torch.clamp(n - 1, min=0)

    def compact(arr, fill):
        out = torch.where(ok.reshape((1,) * arr.ndim), arr[src], arr)
        fill = torch.as_tensor(fill, dtype=arr.dtype, device=dev)
        out[last] = torch.where(ok, fill, out[last])
        return out

    eye16 = torch.eye(4, dtype=torch.float32, device=dev).reshape(16)
    return KeyframeDB(
        pose=compact(db.pose, eye16),
        frame=compact(db.frame, -1),
        valid=compact(db.valid, False),
        gdesc=compact(db.gdesc, 0.0),
        obs_xy=compact(db.obs_xy, 0.0),
        obs_lm=compact(db.obs_lm, 0.0),
        obs_desc=compact(db.obs_desc, 0.0),
        obs_valid=compact(db.obs_valid, False),
    )


class LoopCandidate(NamedTuple):
    idx: torch.Tensor  # () int32 DB row of the best candidate
    similarity: torch.Tensor  # () cosine similarity
    found: torch.Tensor  # () bool


def _eligible_similarity(db: KeyframeDB, entry: KeyframeEntry, min_frame_gap: int):
    sim = db.gdesc @ entry.gdesc  # (N,)
    eligible = db.valid & (db.frame <= entry.frame - min_frame_gap)
    return torch.where(eligible, sim, -float("inf"))


def query_loop(
    db: KeyframeDB,
    entry: KeyframeEntry,
    min_frame_gap: int = 100,
    min_similarity: float = 0.85,
) -> LoopCandidate:
    """Place recognition: best stored view by global-descriptor cosine
    similarity, excluding temporally-near keyframes (those match trivially
    and carry no new constraint)."""
    sim = _eligible_similarity(db, entry, min_frame_gap)
    idx = torch.argmax(sim)
    best = sim[idx]
    return LoopCandidate(idx=idx.to(torch.int32), similarity=best,
                         found=best >= min_similarity)


class LoopCandidates(NamedTuple):
    idx: torch.Tensor  # (k,) int32 DB rows, best first
    similarity: torch.Tensor  # (k,)
    found: torch.Tensor  # (k,) bool


def query_loop_topk(
    db: KeyframeDB,
    entry: KeyframeEntry,
    k: int = 4,
    min_frame_gap: int = 100,
    min_similarity: float = 0.85,
) -> LoopCandidates:
    """Top-k place recognition: the k best stored views by global-descriptor
    cosine similarity (among equal similarities, the -inf of ineligible rows
    included, the lower row first). Geometric verification, not retrieval,
    separates true revisits from self-similar streetscape, so several
    candidates are verified per keyframe."""
    sim = _eligible_similarity(db, entry, min_frame_gap)
    top_sim, top_idx = top_k(sim, k)
    return LoopCandidates(idx=top_idx.to(torch.int32), similarity=top_sim,
                          found=top_sim >= min_similarity)


class LoopConstraint(NamedTuple):
    rel: torch.Tensor  # (4, 4) measured old_S_new (SIMILARITY: scale = det^1/3)
    num_inliers: torch.Tensor  # () int
    ok: torch.Tensor  # () bool


def _umeyama_sim(X: torch.Tensor, Y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted Umeyama: the similarity (..., 4, 4) mapping X -> Y
    (y ~ s R x + t) for point sets (..., N, 3) with weights (..., N), closed
    form via SVD of the weighted cross-covariance. Degenerate weights
    (sum ~ 0) return identity."""
    wsum = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    wn = w / wsum
    mx = (wn[..., None] * X).sum(dim=-2)
    my = (wn[..., None] * Y).sum(dim=-2)
    Xc = X - mx[..., None, :]
    Yc = Y - my[..., None, :]
    C = (wn[..., None] * Yc).transpose(-1, -2) @ Xc  # (..., 3, 3)
    U, D, Vt = torch.linalg.svd(C)
    sgn = torch.sign(det3(U @ Vt))
    Sdiag = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], dim=-1)
    R = (U * Sdiag[..., None, :]) @ Vt
    var_x = (wn * (Xc * Xc).sum(-1)).sum(dim=-1)
    s = (D * Sdiag).sum(dim=-1) / torch.clamp(var_x, min=1e-12)
    t = my - s[..., None] * (R @ mx[..., None])[..., 0]
    eye = torch.eye(4, dtype=X.dtype, device=X.device).expand(X.shape[:-2] + (4, 4))
    out = eye.clone()
    out[..., :3, :3] = s[..., None, None] * R
    out[..., :3, 3] = t
    degenerate = (w.sum(dim=-1) < 3.0) | ~torch.isfinite(s) | (s < 1e-3)
    return torch.where(degenerate[..., None, None], eye, out)


def verify_loop(
    key: Samplers,
    db: KeyframeDB,
    cand_idx: torch.Tensor,
    entry: KeyframeEntry,
    K: torch.Tensor,
    ratio: float = 0.8,
    inlier_threshold_px: float = 2.0,
    min_inliers: int = 25,
    num_hypotheses: int = 256,
    search_radius_px: float = 120.0,
) -> LoopConstraint:
    """Geometric verification of a loop candidate.

    Matches the current entry's patches against the candidate's (mutual +
    Lowe ratio), then P3P-RANSACs the candidate's stored WORLD landmarks
    against the current PIXELS: the recovered T_cw lives in the old map's
    metric frame. `search_radius_px` gates matches to a pixel window between
    the two views (same-lane revisits; heading-reversed loop closure is out
    of scope).

    Candidates are lanes: `cand_idx` () with one sampler verifies one
    candidate; `cand_idx` (k,) with a sequence of k samplers verifies k of
    them in one pass, candidate c drawing from sampler c alone. Every field
    of the result then carries the leading (k,)."""
    cand_idx = torch.as_tensor(cand_idx, device=db.pose.device).long()
    lead = cand_idx.shape
    c_xy = db.obs_xy[cand_idx]  # (..., M, 2)
    e_xy = entry.obs_xy.expand(lead + entry.obs_xy.shape)
    d2 = ((e_xy[..., :, None, :] - c_xy[..., None, :, :]) ** 2).sum(dim=-1)
    near = d2 <= search_radius_px * search_radius_px
    m = match_descriptors(
        entry.obs_desc.expand(lead + entry.obs_desc.shape),
        db.obs_desc[cand_idx],
        valid1=entry.obs_valid.expand(lead + entry.obs_valid.shape),
        valid2=db.obs_valid[cand_idx],
        ratio=ratio,
        pair_valid=near,
    )
    pair_ok = m.valid
    X = torch.take_along_dim(db.obs_lm[cand_idx], torch.clamp(m.idx, min=0)[..., None], dim=-2)
    res = pnp_ransac(
        key,
        X,
        e_xy,
        K.expand(lead + (3, 3)),
        valid=pair_ok,
        inlier_threshold_px=inlier_threshold_px,
        num_hypotheses=num_hypotheses,
    )
    # Sim(3) edge from the inlier 3D-3D pairs, both point sets expressed in
    # their own keyframe's CAMERA frame (each self-consistent in its local
    # map scale): Z maps new-cam points -> old-cam points, so its scale is
    # the relative map scale s_old/s_new.
    old = db.pose[cand_idx].reshape(lead + (4, 4))
    new = entry.pose.reshape(4, 4)
    X_old_cam = (pose_inverse(old)[..., None, :, :] @ to_h(X)[..., None])[..., :3, 0]
    X_new_cam = (pose_inverse(new) @ to_h(entry.obs_lm)[..., None])[..., :3, 0]
    w_in = (pair_ok & res.inliers).to(X.dtype)
    rel = _umeyama_sim(X_new_cam.expand(lead + X_new_cam.shape), X_old_cam, w_in)
    ok = (
        (res.num_inliers >= min_inliers)
        & torch.isfinite(rel).flatten(-2).all(dim=-1)
        & (pair_ok.sum(dim=-1) >= min_inliers)
    )
    return LoopConstraint(rel=rel, num_inliers=res.num_inliers, ok=ok)
