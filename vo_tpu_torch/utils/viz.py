"""The text half of the reference's headless visualization
(vo_tpu/utils/viz.py): the per-frame HUD line and the rolling frames/s
meter. The figures (overlays, trajectory and map plots) are not ported."""

from __future__ import annotations

import time
from collections import deque


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
