"""Scale-out: lockstep multi-sequence VO, device meshes over torch.distributed,
and the sharded solvers (distributed GN, BA, pose graph, sequence-parallel
BA)."""

from vo_tpu_torch.parallel.dist_ba import demo_window, distributed_ba_refine, shard_window
from vo_tpu_torch.parallel.dist_gn import distributed_refine_pose
from vo_tpu_torch.parallel.dist_pg import distributed_pg_optimize
from vo_tpu_torch.parallel.mesh import make_mesh
from vo_tpu_torch.parallel.multiseq import (
    batched_vo_step,
    make_sharded_rollout,
    replicate_state,
    shard_batched_state,
)
from vo_tpu_torch.parallel.window_blocks import seqpar_ba_refine, shard_window_blocks

__all__ = [
    "make_mesh",
    "batched_vo_step",
    "replicate_state",
    "distributed_ba_refine",
    "shard_window",
    "distributed_refine_pose",
    "demo_window",
    "distributed_pg_optimize",
    "seqpar_ba_refine",
    "shard_window_blocks",
    "shard_batched_state",
    "make_sharded_rollout",
]
