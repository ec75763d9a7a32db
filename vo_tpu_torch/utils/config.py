"""The VOConfig tree — the port's own copy of the frozen (hashable) config
dataclasses of vo_tpu/utils/config.py; tests/test_torch_no_jax.py holds the
two trees equal field for field, so the defaults cannot fork silently.

The `use_pallas` fields keep their name and meaning for the CUDA kernels:
None lets the tensor's device decide (kernel on CUDA, plain PyTorch on CPU),
False forces the plain version (the `--no-pallas` twin), True demands the
kernel and raises for a CPU tensor.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Keypoint detection (ref: harris.py:16-34, klt.py:23-27)."""

    method: str = "shi_tomasi"  # "shi_tomasi" | "harris"
    patch_size: int = 7  # structure-tensor window (ref klt blockSize=7)
    kappa: float = 0.08  # harris kappa (ref harris.py:19 uses 0.09/0.08)
    nms_radius: int = 8  # ref klt minDistance=8 / harris nms_radius=5
    border: int = 16
    quality_level: float = 0.01  # ref klt.py:25
    harris_quality_level: float = 2e-4
    harris_nms_radius: int = 5
    min_dist_to_live: float = 8.0  # suppression radius vs existing tracks
    use_pallas: bool | None = None


@dataclasses.dataclass(frozen=True)
class DescriptorConfig:
    """Patch-descriptor matching (ref: harris.py:26-34, 196-262)."""

    radius: int = 9  # (2r+1)^2-pixel patch (ref descriptor_radius=9)
    ratio: float = 0.85  # Lowe ratio (ref match_lambda-era 0.85 / sift 0.8)
    max_move_px: float = 32.0
    max_miss: int = 0


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """DoG front-end (ref: sift.py:8-21 via cv2.SIFT_create)."""

    num_octaves: int = 3
    scales_per_octave: int = 3
    contrast_threshold: float = 0.02
    edge_ratio: float = 10.0
    ratio: float = 0.8  # ref sift.py:45
    max_move_px: float = 40.0
    max_miss: int = 0


@dataclasses.dataclass(frozen=True)
class KLTConfig:
    """Pyramidal LK (ref: klt.py:29-39)."""

    pyramid_levels: int = 4  # one deeper than ref maxLevel=2: turn-rate flow
    radius: int = 8  # 17x17 window
    max_iters: int = 10
    eps: float = 0.03
    max_err: float = 25.0
    min_eig_threshold: float = 1e-4
    predict_motion: bool = True
    use_pallas: bool | None = None


@dataclasses.dataclass(frozen=True)
class BootstrapConfig:
    """Two-view initialization (ref: main.py:185-193, 204-216)."""

    frame_gap: int = 2  # bootstrap on frames 0 and 2 (main.py:207)
    inlier_threshold_px: float = 1.0  # Sampson px (ref uses algebraic 0.25)
    num_hypotheses: int = 512
    min_inliers: int = 30


@dataclasses.dataclass(frozen=True)
class PnPConfig:
    """RANSAC-P3P localization (ref: main.py:194-201, p3p.py:14-49)."""

    inlier_threshold_px: float = 1.25
    num_hypotheses: int = 256
    refine_iters: int = 10
    min_inliers: int = 8


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Lost-pose recovery (new capability — the reference assert-crashes on
    PnP failure, p3p.py:153, and its report documents the unrecoverable
    'vicious circle' on Malaga, Report 3.1.2).

    When PnP fails, the prev->curr relative pose is re-estimated visually
    from the current frame's 2D-2D tracks (8-point RANSAC -> E ->
    cheirality vote, the bootstrap machinery) and the unit translation is
    scaled by the constant-velocity speed. This keeps the rotation locked
    to the imagery — a pure constant-velocity fallback compounds rotation
    error during turns until every pose gate fails permanently."""

    enabled: bool = True
    num_hypotheses: int = 256
    inlier_threshold_px: float = 1.0
    min_inliers: int = 30


@dataclasses.dataclass(frozen=True)
class TriangulationConfig:
    """Continuous candidate triangulation (ref: state.py:8, 90-160)."""

    bearing_threshold: float = 0.0075  # rad (state.py:8)
    min_depth: float = 0.5
    max_depth: float = 200.0
    max_reproj_px: float = 2.0


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Sliding-window bundle adjustment (new capability — the reference
    names it as future work, Report §3.1.1)."""

    enabled: bool = True
    window: int = 6  # keyframes in the window
    refine_in_step: bool = True
    keyframe_every: int = 2
    keyframe_mode: str = "every"
    min_gap: int = 3  # never two keyframes closer than this (frames)
    max_gap: int = 9  # force a keyframe at least this often (while moving)
    min_baseline_ratio: float = 0.04
    min_rotation_rad: float = 0.03  # ~1.7 deg since last keyframe
    min_covisibility: float = 0.6  # overlap with newest keyframe
    iters: int = 5  # GN iterations per refinement
    damping: float = 1e-3
    huber_px: float = 2.0


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Top-level pipeline config. Hashable -> usable as a static jit arg."""

    capacity: int = 1024  # fixed feature-table slots (ref num_keypoints=1000)
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    tracker: str = "klt"
    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    klt: KLTConfig = dataclasses.field(default_factory=KLTConfig)
    descriptor: DescriptorConfig = dataclasses.field(default_factory=DescriptorConfig)
    sift: SiftConfig = dataclasses.field(default_factory=SiftConfig)
    bootstrap: BootstrapConfig = dataclasses.field(default_factory=BootstrapConfig)
    pnp: PnPConfig = dataclasses.field(default_factory=PnPConfig)
    recovery: RecoveryConfig = dataclasses.field(default_factory=RecoveryConfig)
    triangulation: TriangulationConfig = dataclasses.field(
        default_factory=TriangulationConfig
    )
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)

    def replace(self, **kw) -> "VOConfig":
        return dataclasses.replace(self, **kw)

    @property
    def desc_dim(self) -> int:
        """Descriptor lane width of the feature table for this tracker mode
        (1 = unused dummy lane for KLT)."""
        if self.tracker == "harris":
            return (2 * self.descriptor.radius + 1) ** 2
        if self.tracker == "sift":
            return 128
        return 1
