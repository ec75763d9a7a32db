"""Host-facing pose-graph back-end: ties the long-term keyframe DB
(models/keyframe_db.py) and the Sim(3) pose graph (models/pose_graph.py) to
the live VO front-end — port of vo_tpu/models/backend.py.

The front-end steps frame by frame; the back-end consumes a sparse keyframe
stream, one call bundle every `every` frames, off the per-frame path, and
produces a globally consistent trajectory at the end (or whenever
`optimize()` is called):

    caller chunk loop --> on_keyframe(image, pose, table, frame)
                              |- make_entry        (patches + gdesc)
                              |- cull if full      (graph + db compaction)
                              |- add_node / add_entry
                              |- query_loop_topk   (gdesc product)
                              '- verify_loop       (match + P3P RANSAC, the
                                                    top-k candidates as lanes)
    end of run        --> optimize() -> corrected trajectory

Loop-closure feedback into the live map is deliberately NOT done (classic
VO/SLAM split: the front-end stays drift-local, the back-end owns global
consistency).

Randomness: where the reference holds a `jax.random` key (PRNGKey(7)) and
splits it per keyframe and per candidate, the back-end holds one
`torch.Generator` seeded 7 on its device (`key`) and, for every keyframe
that has candidates, draws one seed per candidate from it; each candidate's
RANSAC samples from a generator of its own made from that seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vo_tpu_torch.models.feature_table import STATE_TRIANGULATED
from vo_tpu_torch.models.keyframe_db import (
    KeyframeDB,
    add_entry,
    cull_entry,
    empty_db,
    make_entry,
    query_loop_topk,
    verify_loop,
)
from vo_tpu_torch.models.pose_graph import (
    PoseGraph,
    add_loop_edge,
    add_node,
    chain_span_scores,
    correct_trajectory,
    cull_node,
    empty_pose_graph,
    pg_optimize,
)


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    nodes: int = 256  # pose-graph / DB capacity
    loop_edges: int = 32
    obs_per_entry: int = 256
    patch_radius: int = 8  # 17x17 patches: repetitive-texture discrimination
    grid: int = 16
    min_frame_gap: int = 100  # place recognition: ignore recent frames
    min_similarity: float = 0.85
    # Candidates verified per keyframe, in one pass (retrieval is cheap and
    # geometric verification is the real filter).
    topk: int = 4
    # Verification gate: genuine revisits of the loop circuit score 11-38
    # P3P inliers, the best FALSE candidate 10.
    min_inliers: int = 18
    ratio: float = 0.8
    inlier_threshold_px: float = 2.0
    search_radius_px: float = 120.0  # verification spatial gate (same-lane)
    pg_iters: int = 12
    pg_damping: float = 1e-4
    seq_weight: float = 1.0


class PoseGraphBackend:
    """Stateful host wrapper; all compute inside is fixed-shape tensor work
    on the device of `K`."""

    def __init__(self, K: torch.Tensor, cfg: BackendConfig = BackendConfig()):
        self.cfg = cfg
        self.K = K
        dev = K.device
        self.graph: PoseGraph = empty_pose_graph(
            cfg.nodes, cfg.loop_edges, cfg.seq_weight, device=dev)
        self.db: KeyframeDB = empty_db(
            cfg.nodes, cfg.obs_per_entry, cfg.patch_radius, cfg.grid, device=dev)
        self.key = torch.Generator(device=dev).manual_seed(7)
        self.loops: list[dict] = []  # accepted loop constraints (telemetry)
        self.rejected: list[dict] = []  # candidates that failed verification
        self.n_culled = 0

    def _candidate_samplers(self) -> list:
        """One generator per candidate, seeded from the back-end's own."""
        dev = self.K.device
        seeds = torch.randint(0, 2**62, (self.cfg.topk,), generator=self.key,
                              device=dev, dtype=torch.int64).tolist()
        return [torch.Generator(device=dev).manual_seed(s) for s in seeds]

    def on_keyframe(self, image, pose, table, frame: int) -> dict | None:
        """Register a pose-graph keyframe. Returns loop info if one was
        accepted (dict), else None."""
        c = self.cfg
        dev = self.K.device
        pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        entry = make_entry(
            torch.as_tensor(image, device=dev), table.xy, table.landmark, table.score,
            table.state >= STATE_TRIANGULATED, pose, frame,
            obs_per_entry=c.obs_per_entry, patch_radius=c.patch_radius, grid=c.grid,
        )
        # Cull to make room BEFORE the add so node id == n_nodes is stable.
        if int(self.graph.n_nodes) >= c.nodes:
            scores = chain_span_scores(self.graph)
            victim = torch.argmin(scores)
            if np.isfinite(float(scores[victim])):
                self.graph = cull_node(self.graph, victim)
                self.db = cull_entry(self.db, victim)
                self.n_culled += 1
        node_id = int(self.graph.n_nodes)
        self.graph = add_node(self.graph, pose, frame)
        # Place recognition against everything stored so far: top-k
        # candidates, all geometrically verified in one pass.
        cand = query_loop_topk(
            self.db, entry, k=c.topk, min_frame_gap=c.min_frame_gap,
            min_similarity=c.min_similarity,
        )
        info = None
        found = cand.found.cpu().numpy()
        if found.any():
            res = verify_loop(
                self._candidate_samplers(), self.db, cand.idx, entry, self.K,
                ratio=c.ratio, inlier_threshold_px=c.inlier_threshold_px,
                min_inliers=c.min_inliers, search_radius_px=c.search_radius_px,
            )
            ok = res.ok.cpu().numpy() & found
            inl = res.num_inliers.cpu().numpy()
            idx = cand.idx.cpu().numpy()
            sim = cand.similarity.cpu().numpy()
            if ok.any():
                best = int(np.argmax(np.where(ok, inl, -1)))
                self.graph = add_loop_edge(
                    self.graph, int(idx[best]), node_id, res.rel[best])
                info = dict(
                    frame=frame, node=node_id,
                    matched_node=int(idx[best]),
                    matched_frame=int(self.db.frame[int(idx[best])]),
                    similarity=float(sim[best]),
                    inliers=int(inl[best]),
                )
                self.loops.append(info)
            else:
                # Telemetry: the best-similarity candidate that failed.
                self.rejected.append(dict(
                    frame=frame,
                    matched_frame=int(self.db.frame[int(idx[0])]),
                    similarity=float(sim[0]),
                    inliers=int(inl[0]),
                ))
        self.db = add_entry(self.db, entry)
        return info

    def optimize(self) -> PoseGraph:
        """Run graph GN; node poses update in place. Returns the graph."""
        before = self.graph.node_pose
        self.graph, errs = pg_optimize(
            self.graph, iters=self.cfg.pg_iters, damping=self.cfg.pg_damping)
        self._pre_opt_pose = before
        self._errs = errs.cpu().numpy()
        return self.graph

    def correct(self, traj: np.ndarray, frame_ids: np.ndarray) -> np.ndarray:
        """Re-anchor a full per-frame trajectory to the optimized keyframes.
        Call after optimize()."""
        if not hasattr(self, "_pre_opt_pose"):
            raise RuntimeError("call optimize() first")
        dev = self.K.device
        out = correct_trajectory(
            torch.as_tensor(np.asarray(traj, np.float32), device=dev),
            torch.as_tensor(np.asarray(frame_ids, np.int32), device=dev),
            self.graph.node_frame, self._pre_opt_pose,
            self.graph.node_pose, self.graph.node_valid,
        )
        return out.cpu().numpy()

    @property
    def n_nodes(self) -> int:
        return int(self.graph.n_nodes)

    @property
    def n_loops(self) -> int:
        return len(self.loops)


def backend_from_numpy(graph, db, K, cfg: BackendConfig, device, key=None,
                       loops=(), rejected=(), n_culled: int = 0) -> PoseGraphBackend:
    """Build a PoseGraphBackend from arrays: `graph` and `db` are mappings
    or NamedTuples (e.g. the JAX package's `PoseGraph` and `KeyframeDB`) of
    arrays with the port's field names. Floats become f32, integers int32.
    The JAX PRNG key has no counterpart: `key` is the port's generator
    (default: a fresh one seeded 7, as a new back-end has)."""
    from vo_tpu_torch.models.pipeline import _fields, _to_tensor

    be = PoseGraphBackend(_to_tensor(K, device), cfg)
    be.graph = PoseGraph(**{k: _to_tensor(v, device) for k, v in _fields(graph).items()})
    be.db = KeyframeDB(**{k: _to_tensor(v, device) for k, v in _fields(db).items()})
    if key is not None:
        be.key = key
    be.loops = list(loops)
    be.rejected = list(rejected)
    be.n_culled = int(n_culled)
    return be
