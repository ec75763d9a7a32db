"""Pinhole camera with Brown-Conrady distortion — port of vo_tpu/geom/camera.py.

Pose conventions (as in vo_tpu):
  pose   = w_T_c : camera-to-world;
  extrin = c_T_w = pose^-1 : world-to-camera, the classic [R|t];
  projection of world point X: u ~ K @ (c_T_w @ X_h)[:3].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vo_tpu_torch.geom.lie import pose_inverse
from vo_tpu_torch.geom.points import bmat, inverse, to_cartesian, to_homogeneous


class Camera(NamedTuple):
    """K (3, 3) intrinsics, pose (4, 4) w_T_c, dist (5,) (k1, k2, p1, p2, k3).
    K and pose may carry leading lane axes (B, 3, 3) / (B, 4, 4); `dist` is
    one lens shared by all lanes (distortion is static in the config)."""

    K: torch.Tensor
    pose: torch.Tensor
    dist: torch.Tensor

    @classmethod
    def create(cls, K, pose=None, dist=None, device=None,
               dtype: torch.dtype = torch.float32) -> "Camera":
        """Every field in `dtype`: f32, as the JAX package's, unless asked
        (the recovery asks for f64, models/pipeline.py::recover_pose)."""
        K = torch.as_tensor(K, dtype=dtype, device=device)
        dev = K.device
        pose = (torch.eye(4, dtype=dtype, device=dev).expand(K.shape[:-2] + (4, 4))
                if pose is None
                else torch.as_tensor(pose, dtype=dtype, device=dev))
        dist = (torch.zeros(5, dtype=dtype, device=dev) if dist is None
                else torch.as_tensor(dist, dtype=dtype, device=dev))
        return cls(K=K, pose=pose, dist=dist)

    @property
    def extrinsics(self) -> torch.Tensor:
        return pose_inverse(self.pose)

    @property
    def projection_matrix(self) -> torch.Tensor:
        return self.K @ self.extrinsics[..., :3, :4]

    def project_world(self, points_w: torch.Tensor) -> torch.Tensor:
        return project(self.projection_matrix, points_w)

    def normalized_coords(self, pixels: torch.Tensor) -> torch.Tensor:
        h = to_homogeneous(pixels)
        return to_cartesian((bmat(inverse(self.K), h) @ h[..., None])[..., 0])

    def distort_points(self, pixels: torch.Tensor) -> torch.Tensor:
        """Apply the radial-tangential distortion to ideal pixels (..., 2)."""
        d = to_homogeneous(_distort_normalized(self.normalized_coords(pixels), self.dist))
        return to_cartesian((bmat(self.K, d) @ d[..., None])[..., 0])

    def undistort_points(self, pixels: torch.Tensor, iters: int = 8) -> torch.Tensor:
        """Invert the distortion by fixed-point iteration."""
        n_obs = self.normalized_coords(pixels)
        n = n_obs
        for _ in range(iters):
            n = n + (n_obs - _distort_normalized(n, self.dist))
        n = to_homogeneous(n)
        return to_cartesian((bmat(self.K, n) @ n[..., None])[..., 0])


def _distort_normalized(n: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Brown-Conrady forward model on normalized coords (..., 2)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = n[..., 0], n[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xt = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yt = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + xt, y * radial + yt], dim=-1)


def project(P: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a (3, 4) or per-lane (B, 3, 4) projection matrix to (..., 3)
    points -> (..., 2) pixels."""
    h = to_homogeneous(points)
    return to_cartesian((bmat(P, h) @ h[..., None])[..., 0])


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) or per-lane (B, 4, 4) rigid transform to (..., 3)
    points -> (..., 3)."""
    return (bmat(T[..., :3, :3], points) @ points[..., None]
            + bmat(T[..., :3, 3:4], points))[..., 0]
