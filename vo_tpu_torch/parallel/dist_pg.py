"""Edge-sharded pose-graph optimization — port of vo_tpu/parallel/dist_pg.py.

The single-device optimizer (models/pose_graph.py `pg_optimize`) assembles
the (7N, 7N) Sim(3) normal system over ALL constraints and solves it
densely. The constraints, not the solve, grow with a long trajectory: every
edge costs a Sim(3) log, two 7x7 Jacobians and four 7x7 block products, and
edges are independent. So (the same shape as dist_gn):

  * the edge set (`build_edges`: chain, then loop constraints) is padded with
    invalid edges to a multiple of the axis size and each rank takes its rows;
  * every rank assembles the normal system of ITS edges (`scatter_edge_terms`);
  * four all-reduces per GN iteration (H, g, row_deg, and the error's
    numerator and count together), one more for the final accept-gate error;
  * damping, the gauge pins and the Cholesky solve run on every rank on the
    same numbers (`regularize_and_solve`).

At one rank nothing is padded and every all-reduce returns its input: the
result is `pg_optimize`'s bit for bit.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from vo_tpu_torch.geom.lie import sim3_exp
from vo_tpu_torch.models.pose_graph import (
    PoseGraph,
    _edge_terms,
    build_edges,
    regularize_and_solve,
    scatter_edge_terms,
)
from vo_tpu_torch.parallel.mesh import axis_size, broadcast, local_rows, psum


def _pad_edges(edges, n_shards: int):
    """Append invalid edges (node 0 to node 0, identity, weight 0) until the
    count divides by `n_shards`; they add exact zeros to H and g."""
    a_idx, b_idx, z, w, valid = edges
    pad = (-a_idx.shape[0]) % n_shards
    if not pad:
        return edges
    eye = torch.eye(4, dtype=z.dtype, device=z.device).expand(pad, 4, 4)
    return (
        torch.cat([a_idx, a_idx.new_zeros(pad)]),
        torch.cat([b_idx, b_idx.new_zeros(pad)]),
        torch.cat([z, eye]),
        torch.cat([w, w.new_zeros(pad)]),
        torch.cat([valid, valid.new_zeros(pad)]),
    )


def distributed_pg_optimize(
    mesh: DeviceMesh,
    graph: PoseGraph,
    iters: int = 10,
    damping: float = 1e-4,
    optimize_scale: bool = True,
    axis: str = "model",
) -> tuple[PoseGraph, torch.Tensor]:
    """`pg_optimize` with the edge terms assembled on the ranks of `axis`.
    The graph is given whole on every rank (the first rank's copy is used);
    returns (optimized graph, (iters,) error trace), equal on every rank.
    The semantics are pg_optimize's: the same accept gate and gauge."""
    graph = PoseGraph(*(broadcast(x, mesh, axis) for x in graph))
    N = graph.capacity
    dev = graph.node_pose.device
    edges = _pad_edges(build_edges(graph), axis_size(mesh, axis))
    a_s, b_s, z_s, w_s, v_s = (local_rows(e, mesh, axis) for e in edges)
    gauge_idx = torch.argmax(graph.node_valid.to(torch.int32))
    scale_gauge = (torch.zeros if optimize_scale else torch.ones)(
        (N,), dtype=torch.float32, device=dev)

    def reduce(x):
        return psum(x, mesh, axis)

    poses = graph.node_pose.reshape(-1, 4, 4)
    errs = []
    for _ in range(iters):
        H, g, row_deg, err_num, err_den = scatter_edge_terms(
            poses, a_s, b_s, z_s, w_s, v_s, N)
        H, g, row_deg = reduce(H), reduce(g), reduce(row_deg)
        err_num, err_den = reduce(torch.stack([err_num, err_den]))
        delta = regularize_and_solve(H, g, row_deg, N, gauge_idx, damping, scale_gauge)
        errs.append(err_num / torch.clamp(err_den, min=1))
        delta = torch.where(graph.node_valid[:, None], delta, 0.0)
        poses = poses @ sim3_exp(delta)
    errs = torch.stack(errs) if errs else torch.zeros((0,), device=dev)

    # The accept gate's error on the updated poses.
    r, _, _ = _edge_terms(poses[a_s.long()], poses[b_s.long()], z_s)
    e_num, e_den = reduce(torch.stack([((r * r).sum(-1) * w_s * v_s).sum(), v_s.sum()]))
    err1 = e_num / torch.clamp(e_den, min=1)
    accept = torch.isfinite(err1) & (err1 <= errs[0] * 1.02)
    new_pose = torch.where(accept, poses.reshape(-1, 16), graph.node_pose)
    return graph._replace(node_pose=new_pose), errs
