"""Headless visualization — port of vo_tpu/utils/viz.py: keypoint and match
overlays (cv2), the trajectory, point-cloud and landmark-history figures
(matplotlib, Agg), the per-frame HUD line and the rolling frames/s meter.
Frames and figures are written to disk; the device loop never waits on a
GUI. cv2 and matplotlib are imported only by the function that draws with
them, so the rest of the port runs without them.
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np

# State colors, RGB (ref overlays.py:161-175: unmatched blue(255,0,0 BGR),
# matched yellow, triangulated green).
STATE_COLORS = {0: (0, 0, 255), 1: (255, 255, 0), 2: (0, 255, 0)}


def keypoint_overlay(
    image: np.ndarray, xy: np.ndarray, state: np.ndarray, tracks: np.ndarray | None = None
) -> np.ndarray:
    """Draw state-colored keypoints (+ optional track lines) on a grayscale
    frame. Returns an (H, W, 3) uint8 RGB image. Ref: overlays.py:148-199."""
    import cv2

    img = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
    rgb = cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)
    for s, color in STATE_COLORS.items():
        for p in xy[state == s]:
            cv2.circle(rgb, (int(p[0]), int(p[1])), 3, color, 1, cv2.LINE_AA)
    if tracks is not None:
        for p, q in zip(xy[state >= 1], tracks[state >= 1]):
            cv2.line(rgb, (int(q[0]), int(q[1])), (int(p[0]), int(p[1])),
                     (160, 160, 160), 1, cv2.LINE_AA)
    return rgb


def match_overlay(
    image1: np.ndarray,
    image2: np.ndarray,
    xy1: np.ndarray,
    xy2: np.ndarray,
    mask: np.ndarray,
    max_draw: int = 25,
) -> np.ndarray:
    """Side-by-side frames with match lines (ref overlays.py:106-146
    plot_matches — same 25-match default). Returns (H, 2W, 3) uint8 RGB."""
    import cv2

    a = cv2.cvtColor(np.clip(image1, 0, 255).astype(np.uint8), cv2.COLOR_GRAY2RGB)
    b = cv2.cvtColor(np.clip(image2, 0, 255).astype(np.uint8), cv2.COLOR_GRAY2RGB)
    canvas = np.concatenate([a, b], axis=1)
    w = a.shape[1]
    idx = np.flatnonzero(np.asarray(mask))[:max_draw]
    for i in idx:
        p = (int(xy1[i, 0]), int(xy1[i, 1]))
        q = (int(xy2[i, 0]) + w, int(xy2[i, 1]))
        cv2.circle(canvas, p, 3, (0, 255, 0), 1, cv2.LINE_AA)
        cv2.circle(canvas, q, 3, (0, 255, 0), 1, cv2.LINE_AA)
        cv2.line(canvas, p, q, (255, 128, 0), 1, cv2.LINE_AA)
    return canvas


def save_point_cloud_plot(
    path: str,
    landmarks: np.ndarray,
    poses: np.ndarray | None = None,
    title: str = "map",
):
    """3-D landmark/trajectory figure (ref point_cloud.py:11-66
    PointCloudVisualizer) — headless, with the reference's percentile-based
    axis rescale (point_cloud.py:24-32) and camera frusta markers."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    if len(landmarks):
        lo = np.percentile(landmarks, 5, axis=0)
        hi = np.percentile(landmarks, 95, axis=0)
        keep = np.all((landmarks >= lo - (hi - lo)) & (landmarks <= hi + (hi - lo)), axis=1)
        pts = landmarks[keep]
        ax.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=1, c="#999999", alpha=0.5)
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[2], hi[2])
        ax.set_zlim(-hi[1], -lo[1])
    if poses is not None and len(poses):
        c = poses[:, :3, 3]
        ax.plot(c[:, 0], c[:, 2], -c[:, 1], "-o", ms=2, c="#1f77b4")
        # Frustum rays of the newest camera.
        T = poses[-1]
        scale = 1.0
        for d in ([0.3, 0.2, 1.0], [-0.3, 0.2, 1.0], [0.3, -0.2, 1.0], [-0.3, -0.2, 1.0]):
            tip = T[:3, 3] + (T[:3, :3] @ np.asarray(d)) * scale
            ax.plot(*zip(T[:3, 3][[0, 2]], tip[[0, 2]]),
                    zs=[-T[1, 3], -tip[1]], c="#d62728", lw=0.8)
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("-y")
    ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def save_trajectory_plot(
    path: str,
    est_positions: np.ndarray,
    gt_positions: np.ndarray | None = None,
    landmarks: np.ndarray | None = None,
    title: str = "trajectory",
):
    """Top-down (x, z) trajectory figure — the reference's full_trajectory.pdf
    artifact (main.py:330), headless."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 7))
    if landmarks is not None and len(landmarks):
        # 75th-percentile distance filter like the reference (main.py:86-93).
        d = np.linalg.norm(landmarks - landmarks.mean(0), axis=1)
        keep = d <= np.percentile(d, 75) * 2
        ax.scatter(landmarks[keep, 0], landmarks[keep, 2], s=1, c="#bbbbbb",
                   label="landmarks")
    ax.plot(est_positions[:, 0], est_positions[:, 2], "-o", ms=2, c="#1f77b4",
            label="estimate")
    if gt_positions is not None:
        ax.plot(gt_positions[:, 0], gt_positions[:, 2], "-", c="#2ca02c",
                label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def save_landmark_history_plot(
    path: str,
    frame_ids: np.ndarray,
    num_triangulated: np.ndarray,
    num_candidates: np.ndarray | None = None,
    num_tracked: np.ndarray | None = None,
    title: str = "landmarks per frame",
):
    """Per-frame landmark-count history figure (ref main.py:144-165
    plot_nr_of_landmarks — the reference redraws the last SHOW_N_POSES
    frames live; headless here, the full history in one artifact)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 3.2))
    ax.plot(frame_ids, num_triangulated, c="#2ca02c", label="triangulated")
    if num_candidates is not None:
        ax.plot(frame_ids, num_candidates, c="#ff7f0e", lw=0.9, label="candidates")
    if num_tracked is not None:
        ax.plot(frame_ids, num_tracked, c="#1f77b4", lw=0.9, label="tracked")
    ax.set_xlabel("frame")
    ax.set_ylabel("# keypoints")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)




def hud_text(out) -> str:
    """Keypoint-count HUD line (ref overlays.py:41-67 display_keypoints_info)."""
    return (
        f"tracked {int(out.num_tracked)}  tri {int(out.num_triangulated)}  "
        f"cand {int(out.num_candidates)}  pnp_inl {int(out.num_pnp_inliers)}  "
        f"new {int(out.num_new_landmarks)}"
    )


class FpsMeter:
    """Rolling-average frames/s over the last `window` frame periods."""

    def __init__(self, window: int = 20):
        self._dts = deque(maxlen=window)
        self._last = None

    def tick(self, now: float | None = None) -> float:
        now = time.perf_counter() if now is None else now
        if self._last is not None:
            self._dts.append(now - self._last)
        self._last = now
        if not self._dts:
            return 0.0
        return len(self._dts) / sum(self._dts)

    def text(self) -> str:
        fps = len(self._dts) / sum(self._dts) if self._dts else 0.0
        return f"FPS: {fps:5.1f}"
