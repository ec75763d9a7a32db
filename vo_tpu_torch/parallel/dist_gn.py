"""Distributed Gauss-Newton: observation-sharded pose refinement — port of
vo_tpu/parallel/dist_gn.py.

Observations (landmark, pixel) pairs are sharded over the mesh "model" axis;
every rank accumulates the 6x6 camera-block normal equations of its own rows
(`ops.pnp._normal_equations`, the same code `refine_pose_gn` runs) and one
all-reduce of the system per iteration sums them before the tiny 6x6 solve,
which every rank repeats on the same numbers. At one rank this is
`refine_pose_gn` exactly: the same sums in the same order.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from vo_tpu_torch.geom.lie import se3_exp
from vo_tpu_torch.ops.linalg import spd_solve_small
from vo_tpu_torch.ops.pnp import _normal_equations
from vo_tpu_torch.parallel.mesh import broadcast, psum


def distributed_refine_pose(
    mesh: DeviceMesh,
    T_cw: torch.Tensor,  # (4, 4), replicated
    X_w: torch.Tensor,  # (N / ranks, 3): this rank's rows (mesh.local_rows)
    uv: torch.Tensor,  # (N / ranks, 2)
    weights: torch.Tensor,  # (N / ranks,)
    K: torch.Tensor,  # (3, 3), replicated
    iters: int = 5,
    damping: float = 1e-4,
) -> torch.Tensor:
    """Pose GN with observations sharded over "model" and the normal
    equations all-reduced over it; returns the refined T_cw on every rank."""
    T = broadcast(T_cw, mesh, "model")
    K = broadcast(K, mesh, "model")
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    for _ in range(iters):
        H_loc, g_loc = _normal_equations(T, X_w, uv, weights, K)
        system = psum(torch.cat([H_loc, g_loc[None]]), mesh, "model")  # one all-reduce
        H, g = system[:6], system[6]
        delta = spd_solve_small(H + damping * eye6, -g, 6)
        delta = torch.where(torch.isfinite(delta).all(dim=-1, keepdim=True), delta, 0.0)
        T = se3_exp(delta) @ T
    return T
