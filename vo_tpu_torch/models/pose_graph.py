"""Pose-graph back-end: long-term keyframe chain + batched Sim(3) graph GN —
port of vo_tpu/models/pose_graph.py.

  * **fixed-capacity node chain** — keyframes appended in order; node id =
    append order, so the odometry ("sequential") constraints need no edge
    list at all: `rel_prev[k]` stores the measured relative pose between
    chain-neighbour keyframes. Culling a node composes its two chain
    constraints into one and compacts the arrays with a gather permutation.
  * **fixed-capacity loop-edge store** — place-recognition constraints
    between arbitrary node pairs (i < j), appended masked.
  * **batched Gauss-Newton over Sim(3)** — monocular VO drifts in SCALE,
    which SE(3) closure cannot express, so the graph optimizes similarities
    (Strasdat et al., RSS 2010). Nodes and constraints are 4x4 similarity
    matrices (scale lives in det of the upper-left block); every constraint
    contributes a 7-vector residual r = log_sim3(Z^-1 Sa^-1 Sb) with
    analytic right-perturbation Jacobians (first-order inverse right
    Jacobian, J ~ I + 0.5 ad(r)); the dense (7N, 7N) normal system is
    assembled by accumulation and solved in one shot by Cholesky.
  * fixed iteration count, Levenberg damping, gauge frozen at the oldest
    valid node (all 7 DoF): no data-dependent control flow anywhere.

The accumulations over edges that share nodes are `index_put_(accumulate=
True)`, which sorts its indices on a GPU and adds in a fixed order (an
`index_add_` would be atomics there, and a seeded run would stop
reproducing). A system that is not positive definite gives NaN steps
(`cholesky_ex`, no exception and no host sync), which the acceptance test at
the end of `pg_optimize` turns away, as the reference's NaN Cholesky does.

SE(3)-only behaviour is available with `pg_optimize(..., optimize_scale=
False)`: every node's scale DoF is pinned.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vo_tpu_torch.geom.lie import sim3_exp, sim3_inverse, sim3_log, sim3_scale
from vo_tpu_torch.geom.points import skew

_GAUGE = 1e8  # diagonal added to the gauge node / dead nodes


class PoseGraph(NamedTuple):
    """Fixed-capacity keyframe pose graph.

    Nodes live at indices [0, n_nodes); append order is chain order.
    `rel_prev[k]` is the measured pose of node k in node k-1's frame
    (T_{k-1}^-1 T_k at insertion time); row 0 is unused (identity).

    All 16-float rows are 4x4 SIMILARITY matrices: odometry constraints and
    freshly-added nodes are rigid (scale 1), loop constraints carry the
    measured relative map scale, and optimized node poses carry the
    recovered per-node scale correction (extract the rigid pose with
    `node_se3`)."""

    node_pose: torch.Tensor  # (N, 16) w_S_c per keyframe (current estimate)
    node_frame: torch.Tensor  # (N,) int32 frame index of the keyframe
    node_valid: torch.Tensor  # (N,) bool
    rel_prev: torch.Tensor  # (N, 16) chain constraint k-1 -> k
    loop_ij: torch.Tensor  # (E, 2) int32 node ids (i < j), -1 if free
    loop_rel: torch.Tensor  # (E, 16) measured i_T_j
    loop_valid: torch.Tensor  # (E,) bool
    seq_weight: torch.Tensor  # () relative info of chain vs loop constraints

    @property
    def capacity(self) -> int:
        return self.node_pose.shape[0]

    @property
    def n_nodes(self) -> torch.Tensor:
        return self.node_valid.sum()


def _eye16(n: int, device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device).reshape(1, 16).repeat(n, 1)


def empty_pose_graph(
    num_nodes: int, num_loop_edges: int, seq_weight: float = 1.0, device=None
) -> PoseGraph:
    return PoseGraph(
        node_pose=_eye16(num_nodes, device),
        node_frame=torch.full((num_nodes,), -1, dtype=torch.int32, device=device),
        node_valid=torch.zeros((num_nodes,), dtype=torch.bool, device=device),
        rel_prev=_eye16(num_nodes, device),
        loop_ij=torch.full((num_loop_edges, 2), -1, dtype=torch.int32, device=device),
        loop_rel=_eye16(num_loop_edges, device),
        loop_valid=torch.zeros((num_loop_edges,), dtype=torch.bool, device=device),
        seq_weight=torch.tensor(seq_weight, dtype=torch.float32, device=device),
    )


def node_se3(graph: PoseGraph) -> torch.Tensor:
    """(N, 4, 4) rigid poses: node similarities with the scale stripped."""
    S = graph.node_pose.reshape(-1, 4, 4).clone()
    S[:, :3, :3] = S[:, :3, :3] / sim3_scale(S)[:, None, None]
    return S


def _masked_write(arr: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor, row) -> torch.Tensor:
    """arr.at[idx].set(where(ok, row, arr[idx])) for a 0-dim index tensor."""
    out = arr.clone()
    row = torch.as_tensor(row, dtype=arr.dtype, device=arr.device)
    out[idx] = torch.where(ok, row, arr[idx])
    return out


def add_node(graph: PoseGraph, pose: torch.Tensor, frame) -> PoseGraph:
    """Append a keyframe (masked no-op when full — cull first).

    The chain constraint to the previous node is measured from the *current*
    estimates at insertion time, exactly like an odometry edge.
    """
    k = graph.n_nodes
    ok = k < graph.capacity
    prev = graph.node_pose[torch.clamp(k - 1, min=0)].reshape(4, 4)
    rel = sim3_inverse(prev) @ pose
    rel = torch.where(k > 0, rel, torch.eye(4, dtype=pose.dtype, device=pose.device))
    idx = torch.where(ok, k, 0)  # masked write target
    return graph._replace(
        node_pose=_masked_write(graph.node_pose, idx, ok, pose.reshape(16)),
        node_frame=_masked_write(graph.node_frame, idx, ok, frame),
        node_valid=_masked_write(graph.node_valid, idx, ok, ok),
        rel_prev=_masked_write(graph.rel_prev, idx, ok, rel.reshape(16)),
    )


def add_loop_edge(graph: PoseGraph, i, j, rel: torch.Tensor) -> PoseGraph:
    """Append a loop constraint: node j's pose in node i's frame (masked
    no-op when the edge store is full or i==j)."""
    dev = graph.loop_ij.device
    i = torch.as_tensor(i, device=dev)
    j = torch.as_tensor(j, device=dev)
    e = graph.loop_valid.sum()
    ok = (e < graph.loop_ij.shape[0]) & (i != j) & (i >= 0) & (j >= 0)
    idx = torch.where(ok, e, 0)
    return graph._replace(
        loop_ij=_masked_write(graph.loop_ij, idx, ok, torch.stack([i, j]).to(torch.int32)),
        loop_rel=_masked_write(graph.loop_rel, idx, ok, rel.reshape(16)),
        loop_valid=_masked_write(graph.loop_valid, idx, ok, ok),
    )


def chain_span_scores(graph: PoseGraph) -> torch.Tensor:
    """Per-node culling score: the chain span a node's removal would merge
    (|t| of its incoming + outgoing constraints). Low score = the node's
    neighbours almost coincide with it = least information lost by culling.
    Protected nodes (gauge node 0, the chain tail, loop-edge endpoints,
    invalid rows) score +inf."""
    t_in = torch.linalg.vector_norm(graph.rel_prev.reshape(-1, 4, 4)[:, :3, 3], dim=-1)
    t_out = torch.cat([t_in[1:], torch.zeros((1,), dtype=t_in.dtype, device=t_in.device)])
    score = t_in + t_out
    n = graph.n_nodes
    idx = torch.arange(graph.capacity, device=t_in.device)
    flat = torch.where(graph.loop_valid[:, None], graph.loop_ij, 0).reshape(-1).long()
    marks = torch.zeros((graph.capacity,), dtype=torch.int32, device=t_in.device)
    # Integer counts: the order of the adds cannot change the result.
    marks = marks.scatter_add(0, flat, graph.loop_valid.to(torch.int32).repeat_interleave(2))
    in_loop = (marks > 0) & graph.node_valid
    protected = (idx == 0) | (idx >= n - 1) | in_loop | ~graph.node_valid
    return torch.where(protected, float("inf"), score)


def cull_node(graph: PoseGraph, victim) -> PoseGraph:
    """Remove node `victim` by contracting its chain constraints
    (rel[v+1] <- rel[v] @ rel[v+1]) and compacting all node arrays with a
    gather; loop-edge node ids above the victim shift down by one.

    Masked no-op when victim is invalid (e.g. `argmin(chain_span_scores)`
    returned an inf row)."""
    dev = graph.node_pose.device
    v = torch.as_tensor(victim, device=dev).long()
    n = graph.n_nodes
    vc = torch.clamp(v, 0, graph.capacity - 1)  # a row to read for any victim
    ok = (v > 0) & (v < n - 1) & graph.node_valid[vc]

    rel = graph.rel_prev.reshape(-1, 4, 4)
    succ = torch.clamp(vc + 1, max=graph.capacity - 1)
    merged = rel[vc] @ rel[succ]
    rel_prev = _masked_write(graph.rel_prev, succ, ok, merged.reshape(16))

    idx = torch.arange(graph.capacity, device=dev)
    src = torch.where(idx < v, idx, torch.clamp(idx + 1, max=graph.capacity - 1))
    last = n - 1  # row that becomes free after the shift

    def compact(arr, fill):
        cond = ok.reshape((1,) * arr.ndim)
        out = torch.where(cond, arr[src], arr)
        return _masked_write(out, last, ok, fill)

    eye16 = torch.eye(4, dtype=torch.float32, device=dev).reshape(16)
    loop_ij = torch.where(ok & (graph.loop_ij > v), graph.loop_ij - 1, graph.loop_ij)
    return graph._replace(
        node_pose=compact(graph.node_pose, eye16),
        node_frame=compact(graph.node_frame, -1),
        node_valid=compact(graph.node_valid, False),
        rel_prev=compact(rel_prev, eye16),
        loop_ij=loop_ij.to(torch.int32),
    )


def _ad_sim3(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) adjoint ad(xi) for twist order (v, w, lam):
    [[w^ + lam*I, v^, -v], [0, w^, 0], [0, 0, 0]] — from the bracket
    [(v1,w1,l1),(v2,w2,l2)] = (w1xv2 - w2xv1 + l1 v2 - l2 v1, w1xw2, 0)."""
    v, w, lam = xi[..., :3], xi[..., 3:6], xi[..., 6]
    wh, vh = skew(w), skew(v)
    eye3 = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(wh.shape)
    top = torch.cat([wh + lam[..., None, None] * eye3, vh, -v[..., None]], dim=-1)
    mid = torch.cat([torch.zeros_like(wh), wh, torch.zeros_like(v[..., None])], dim=-1)
    bot = torch.zeros_like(top[..., :1, :])
    return torch.cat([top, mid, bot], dim=-2)


def _Ad_sim3(S: torch.Tensor) -> torch.Tensor:
    """Sim(3) adjoint Ad(S) for twist order (v, w, lam), S = [[sR, t],[0,1]]:
    [[sR, t^R, -t], [0, R, 0], [0, 0, 1]]."""
    sR = S[..., :3, :3]
    s = sim3_scale(S)
    R = sR / s[..., None, None]
    t = S[..., :3, 3]
    top = torch.cat([sR, skew(t) @ R, -t[..., None]], dim=-1)
    mid = torch.cat([torch.zeros_like(R), R, torch.zeros_like(t[..., None])], dim=-1)
    bot = torch.cat(
        [torch.zeros_like(t), torch.zeros_like(t), torch.ones_like(s)[..., None]], dim=-1
    )[..., None, :]
    return torch.cat([top, mid, bot], dim=-2)


def _edge_terms(Sa, Sb, z):
    """Residual + right-perturbation Jacobians for constraints (batched over
    leading dims) r = log(z^-1 Sa^-1 Sb); Sa <- Sa exp(xi_a), Sb <- Sb exp(xi_b).

      dr/dxi_b =  Jr^-1(r)            ~ I + 0.5 ad(r)
      dr/dxi_a = -Jl^-1(r) Ad(z^-1)   ~ -(I - 0.5 ad(r)) Ad(z^-1)
    """
    zinv = sim3_inverse(z)
    r = sim3_log(zinv @ sim3_inverse(Sa) @ Sb)
    eye = torch.eye(7, dtype=r.dtype, device=r.device)
    adr = _ad_sim3(r)
    Jb = eye + 0.5 * adr
    Ja = -(eye - 0.5 * adr) @ _Ad_sim3(zinv)
    return r, Ja, Jb


def _jtj(Jx: torch.Tensor, Jy: torch.Tensor) -> torch.Tensor:
    """einsum("eia,eib->eab") as a product and a sum (elementwise work whose
    rounding does not depend on the number of edges)."""
    return (Jx[..., :, :, None] * Jy[..., :, None, :]).sum(dim=-3)


def scatter_edge_terms(poses, a_idx, b_idx, z, w, valid, n_cap):
    """Assemble the (unregularized) normal system for a SET of constraints:
    H (N, N, 7, 7) block Hessian, g (N, 7) gradient, row_deg (N,) constraint
    count per node, err the weighted mean squared residual
    numerator/denominator pair. Pure function of its edge set."""
    a_idx, b_idx = a_idx.long(), b_idx.long()
    Sa = poses[a_idx]
    Sb = poses[b_idx]
    r, Ja, Jb = _edge_terms(Sa, Sb, z)
    wm = (w * valid)[:, None, None]

    H = torch.zeros((n_cap, n_cap, 7, 7), dtype=r.dtype, device=r.device)
    g = torch.zeros((n_cap, 7), dtype=r.dtype, device=r.device)
    JaW = Ja * wm
    JbW = Jb * wm
    H.index_put_((a_idx, a_idx), _jtj(JaW, Ja), accumulate=True)
    H.index_put_((b_idx, b_idx), _jtj(JbW, Jb), accumulate=True)
    H.index_put_((a_idx, b_idx), _jtj(JaW, Jb), accumulate=True)
    H.index_put_((b_idx, a_idx), _jtj(JbW, Ja), accumulate=True)
    g.index_put_((a_idx,), (JaW * r[:, :, None]).sum(dim=-2), accumulate=True)
    g.index_put_((b_idx,), (JbW * r[:, :, None]).sum(dim=-2), accumulate=True)
    row_deg = torch.zeros((n_cap,), dtype=r.dtype, device=r.device)
    row_deg.index_put_((a_idx,), valid, accumulate=True)
    row_deg.index_put_((b_idx,), valid, accumulate=True)
    err_num = ((r * r).sum(-1) * w * valid).sum()
    err_den = valid.sum()
    return H, g, row_deg, err_num, err_den


def regularize_and_solve(H, g, row_deg, n_cap, gauge_idx, damping, scale_gauge):
    """Damping + gauge pins + the SPD block solve. H/g/row_deg are the
    outputs of `scatter_edge_terms`. A system that is not positive definite
    gives a NaN step (no exception)."""
    N7 = 7 * n_cap
    dev = H.device
    eye7 = torch.eye(7, dtype=H.dtype, device=dev)
    diag = torch.arange(n_cap, device=dev)
    lam_pin = torch.zeros((7, 7), dtype=H.dtype, device=dev)
    lam_pin[6, 6] = _GAUGE
    H = H.clone()
    H[diag, diag] += damping * eye7
    H[gauge_idx, gauge_idx] += _GAUGE * eye7
    # Optional rigid mode: pin every node's scale DoF.
    H[diag, diag] += scale_gauge[:, None, None] * lam_pin
    # Unconstrained rows (invalid nodes): pin so the dense solve is well-posed.
    H[diag, diag] += (row_deg < 0.5).to(H.dtype)[:, None, None] * _GAUGE * eye7

    Hd = H.permute(0, 2, 1, 3).reshape(N7, N7)
    L, info = torch.linalg.cholesky_ex(Hd)
    y = torch.linalg.solve_triangular(L, -g.reshape(N7, 1), upper=False)
    delta = torch.linalg.solve_triangular(L.mT, y, upper=True).reshape(n_cap, 7)
    return torch.where(info == 0, delta, float("nan"))


def build_edges(graph: PoseGraph):
    """Flatten a PoseGraph into its constraint set: (a_idx, b_idx, z, w,
    valid) with the chain constraints first, then the loop edges."""
    N = graph.capacity
    dev = graph.node_pose.device
    idx = torch.arange(N, device=dev)
    # Chain constraints: (k-1, k) for valid k >= 1.
    seq_a = torch.clamp(idx - 1, min=0)
    seq_b = idx
    seq_valid = graph.node_valid & (idx >= 1) & graph.node_valid[seq_a]
    # Loop constraints.
    li = torch.clamp(graph.loop_ij[:, 0], 0, N - 1).long()
    lj = torch.clamp(graph.loop_ij[:, 1], 0, N - 1).long()
    lv = graph.loop_valid & graph.node_valid[li] & graph.node_valid[lj]

    a_idx = torch.cat([seq_a, li])
    b_idx = torch.cat([seq_b, lj])
    z = torch.cat([graph.rel_prev.reshape(-1, 4, 4), graph.loop_rel.reshape(-1, 4, 4)])
    w = torch.cat([
        graph.seq_weight.expand(N),
        torch.ones((graph.loop_valid.shape[0],), dtype=torch.float32, device=dev),
    ])
    valid = torch.cat([seq_valid, lv]).to(z.dtype)
    return a_idx, b_idx, z, w, valid


def pg_optimize(
    graph: PoseGraph,
    iters: int = 10,
    damping: float = 1e-4,
    optimize_scale: bool = True,
) -> tuple[PoseGraph, torch.Tensor]:
    """Batched GN over the whole graph. Returns (optimized graph, (iters,)
    mean squared residual trace — errs[i] is BEFORE step i).

    The gauge is the oldest valid node (all 7 DoF); with
    `optimize_scale=False` every node's scale is pinned (rigid SE(3) mode).
    The optimized graph is accepted only if the final error is finite and
    did not increase (diverged solves never corrupt the trajectory)."""
    N = graph.capacity
    dev = graph.node_pose.device
    a_idx, b_idx, z, w, valid = build_edges(graph)
    gauge_idx = torch.argmax(graph.node_valid.to(torch.int32))
    scale_gauge = (torch.zeros if optimize_scale else torch.ones)(
        (N,), dtype=torch.float32, device=dev)

    poses = graph.node_pose.reshape(-1, 4, 4)
    errs = []
    for _ in range(iters):
        H, g, row_deg, err_num, err_den = scatter_edge_terms(
            poses, a_idx, b_idx, z, w, valid, N)
        delta = regularize_and_solve(H, g, row_deg, N, gauge_idx, damping, scale_gauge)
        errs.append(err_num / torch.clamp(err_den, min=1))
        delta = torch.where(graph.node_valid[:, None], delta, 0.0)
        poses = poses @ sim3_exp(delta)
    errs = torch.stack(errs) if errs else torch.zeros((0,), device=dev)

    r, _, _ = _edge_terms(poses[a_idx], poses[b_idx], z)
    err1 = ((r * r).sum(-1) * w * valid).sum() / torch.clamp(valid.sum(), min=1)
    accept = torch.isfinite(err1) & (err1 <= errs[0] * 1.02)
    new_pose = torch.where(accept, poses.reshape(-1, 16), graph.node_pose)
    return graph._replace(node_pose=new_pose), errs


def correct_trajectory(
    traj: torch.Tensor,  # (F, 4, 4) per-frame w_T_c estimates
    frame_idx: torch.Tensor,  # (F,) frame index of each trajectory row
    node_frame: torch.Tensor,  # (N,) keyframe frame index (sorted, -1 pad)
    old_node_pose: torch.Tensor,  # (N, 16) node poses BEFORE optimization
    new_node_pose: torch.Tensor,  # (N, 16) node poses AFTER optimization
    node_valid: torch.Tensor,  # (N,) bool
) -> torch.Tensor:
    """Re-anchor every frame with the SIMILARITY correction of its
    keyframes: C_k = S_kf_new @ S_kf_old^-1 per node, INTERPOLATED in
    sim(3) log space between the two bracketing keyframes:

        C(f) = exp((1-a) log C_k + a log C_{k+1}),  a = (f-f_k)/(f_{k+1}-f_k)

    then T_f' = C(f) @ T_f with the scale stripped from the rotation block
    (poses stay SE(3); the scale correction rescales each frame's position).
    Frames before the first keyframe are untouched; frames after the last
    get its correction."""
    big = 2**30
    frame_idx = frame_idx.to(torch.int32)
    nf = torch.where(node_valid, node_frame.to(torch.int32), big)
    nf_sorted, order = torch.sort(nf, stable=True)
    n_valid = node_valid.sum()
    pos = torch.searchsorted(nf_sorted, frame_idx, right=True) - 1
    has_kf = pos >= 0
    top = torch.clamp(n_valid - 1, min=0)
    pos = torch.minimum(torch.clamp(pos, min=0), top)
    pos2 = torch.minimum(pos + 1, top)
    src, src2 = order[pos], order[pos2]

    def log_corr(idx):
        S_old = old_node_pose[idx].reshape(-1, 4, 4)
        S_new = new_node_pose[idx].reshape(-1, 4, 4)
        return sim3_log(S_new @ sim3_inverse(S_old))

    c1 = log_corr(src)  # (F, 7)
    c2 = log_corr(src2)
    f1 = nf_sorted[pos].to(torch.float32)
    f2 = nf_sorted[pos2].to(torch.float32)
    span = f2 - f1
    alpha = torch.where(
        span > 0, (frame_idx.to(torch.float32) - f1) / torch.clamp(span, min=1), 0.0)
    alpha = torch.clamp(alpha, 0.0, 1.0)[:, None]
    C = sim3_exp((1.0 - alpha) * c1 + alpha * c2)
    corrected = C @ traj
    # De-scale the rotation block: det(sR R_f) = s^3 (closed-form det: one
    # per frame, no LU and no sync).
    s = sim3_scale(corrected)
    corrected = corrected.clone()
    corrected[:, :3, :3] = corrected[:, :3, :3] / s[:, None, None]
    return torch.where(has_kf[:, None, None], corrected, traj)
