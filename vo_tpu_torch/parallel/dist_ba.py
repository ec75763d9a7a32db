"""Distributed sliding-window bundle adjustment — port of
vo_tpu/parallel/dist_ba.py.

Landmark rows of the BA window are sharded over the mesh "model" axis; every
rank computes the residuals and Jacobians of its own landmarks, the
camera-side normal equations (U, b_c, the Schur fill-in and the reduced
gradient) and the error terms are all-reduced over the axis
(`ba_refine(..., reduce_fn=...)`), every rank solves the same tiny (6W x 6W)
reduced camera system, and landmark back-substitution stays on the rank.
Communication per GN iteration is O(W^2) camera blocks, independent of the
landmark count. At one rank the all-reduces return their input and the
result is `ba_refine`'s bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from vo_tpu_torch.models.ba import BAWindow, ba_refine
from vo_tpu_torch.parallel.mesh import broadcast, local_rows, psum

# The dimension of each BAWindow field that is sharded over "model" (landmark
# rows); None = replicated keyframe state.
WINDOW_SPECS = BAWindow(kf_pose=None, kf_valid=None, obs_uv=0, obs_mask=0,
                        landmark=0, lm_uid=0, lm_valid=0)


def shard_window(window: BAWindow, mesh: DeviceMesh) -> BAWindow:
    """This rank's part of a window given whole on every rank: its landmark
    rows, and the keyframe state as the first rank of "model" has it."""
    return BAWindow(*(
        broadcast(x, mesh, "model") if dim is None else local_rows(x, mesh, "model", dim)
        for x, dim in zip(window, WINDOW_SPECS)))


def demo_window(
    num_landmarks: int,
    num_keyframes: int = 4,
    K: np.ndarray | None = None,
    seed: int = 11,
    pix_noise: float = 0.3,
    perturb_pose: float = 0.02,
    perturb_pt: float = 0.1,
    device=None,
) -> BAWindow:
    """Deterministic synthetic BA window, built in numpy so that every rank
    builds the SAME window without communication: forward-translating
    keyframes observing a planted landmark cloud, with noisy observations and
    perturbed initial geometry (GN has real work to do, the truth is known).
    The arrays are the reference's (vo_tpu/parallel/dist_ba.py) byte for
    byte; `device` is where the tensors go."""
    if K is None:
        K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(seed)
    L, W = num_landmarks, num_keyframes
    X = np.stack(
        [rng.uniform(-8, 8, L), rng.uniform(-4, 4, L), rng.uniform(12, 40, L)],
        axis=-1,
    ).astype(np.float32)
    poses, uvs = [], []
    for i in range(W):
        T = np.eye(4, dtype=np.float32)
        T[2, 3] = 0.6 * i  # forward along +z
        poses.append(T)
        xc = X - T[:3, 3]  # identity rotation
        uv_h = (K @ xc.T).T
        uv = uv_h[:, :2] / uv_h[:, 2:]
        uvs.append(uv + rng.normal(0, pix_noise, uv.shape))
    kf_pose = np.stack([p.reshape(16) for p in poses]).astype(np.float32)
    # Perturb every non-gauge keyframe translation + all landmark estimates.
    kf_pose[1:, 3::4][:, :3] += rng.normal(0, perturb_pose, (W - 1, 3))
    landmark = (X + rng.normal(0, perturb_pt, X.shape)).astype(np.float32)

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return BAWindow(
        kf_pose=t(kf_pose),
        kf_valid=torch.ones((W,), dtype=torch.bool, device=device),
        obs_uv=t(np.stack(uvs, axis=1).astype(np.float32)),
        obs_mask=torch.ones((L, W), dtype=torch.bool, device=device),
        landmark=t(landmark),
        lm_uid=torch.arange(L, dtype=torch.int32, device=device),
        lm_valid=torch.ones((L,), dtype=torch.bool, device=device),
    )


def distributed_ba_refine(
    mesh: DeviceMesh,
    window: BAWindow,
    K: torch.Tensor,
    iters: int = 5,
    damping: float = 1e-3,
    huber_px: float = 2.0,
) -> tuple[BAWindow, torch.Tensor]:
    """`ba_refine` over this rank's landmark rows (`shard_window`), the
    camera-side sums all-reduced over "model". Returns (this rank's refined
    window, the (iters,) error trace, equal on every rank)."""
    return ba_refine(window, broadcast(K, mesh, "model"), iters=iters, damping=damping,
                     huber_px=huber_px, reduce_fn=lambda x: psum(x, mesh, "model"))
