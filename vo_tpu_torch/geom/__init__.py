"""Math core: homogeneous coordinates, Hartley normalization, SE(3), camera."""

from vo_tpu_torch.geom.camera import Camera, project, transform_points
from vo_tpu_torch.geom.lie import pose_inverse, se3_exp, se3_log, so3_exp, so3_log
from vo_tpu_torch.geom.points import (
    normalize_points,
    skew,
    to_cartesian,
    to_homogeneous,
    unskew,
)

__all__ = [
    "to_homogeneous",
    "to_cartesian",
    "normalize_points",
    "skew",
    "unskew",
    "so3_exp",
    "so3_log",
    "se3_exp",
    "se3_log",
    "pose_inverse",
    "Camera",
    "project",
    "transform_points",
]
