"""Data-parallel multi-sequence VO — port of vo_tpu/parallel/multiseq.py.

Throughput scaling for an inherently sequential problem (frame t+1 needs
pose t): run B independent sequences in lockstep, one step over a batched
VOState. Latency per sequence is unchanged; the step's eager dispatch cost
is paid once for B lanes instead of B times.

Where the reference wraps `vo_step` in `jax.vmap`, the port's `vo_step`
takes the lane axis itself (models/pipeline.py): every leaf of the state
carries a leading B, and the two kernels run once per call over all lanes
(K1b, K2b) — there is no loop over lanes in the step's tensor work. Only the
RANSAC draws are made lane by lane, each from the lane's own samplers (its
PnP stream and its recovery stream), so lane b of a batched rollout is the
single rollout of lane b.

Over ranks (`shard_batched_state`, `make_sharded_rollout`) the lanes are
split over the mesh "data" axis: a rank holds its lanes and rolls them with
`batched_vo_rollout`. Lanes are independent, so no collective runs inside
the step; outputs are gathered only for reporting (`gather_lanes`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from vo_tpu_torch.models.pipeline import (
    StepOutput,
    VOState,
    map_state,
    recovery_stream,
    vo_rollout,
    vo_step,
)
from vo_tpu_torch.ops.ransac import Sampler, is_lane_samplers
from vo_tpu_torch.parallel.mesh import all_gather, axis_index, axis_size, local_rows
from vo_tpu_torch.utils.config import VOConfig


def replicate_state(state: VOState, batch: int, samplers: Sequence[Sampler]) -> VOState:
    """Tile a single-sequence VOState into a batched one (leading axis B).
    `samplers` are the B independent RANSAC samplers of the lanes (where the
    reference splits the state's key B ways); each lane's recovery stream is
    `recovery_stream` of its sampler."""
    samplers = list(samplers)
    if len(samplers) != batch:
        raise ValueError(f"{batch} lanes need {batch} samplers, got {len(samplers)}")
    return map_state(lambda x: x[None].expand((batch,) + x.shape).contiguous(), state,
                     rng=samplers, rec_rng=recovery_stream(samplers))


def stack_states(states: Sequence[VOState]) -> VOState:
    """Stack single-sequence VOStates (each bootstrapped on its own) into one
    batched state; lane b keeps state b's two samplers."""
    states = list(states)
    if any(is_lane_samplers(s.rng) for s in states):
        raise ValueError("stack_states takes single-sequence states")
    return map_state(lambda *xs: torch.stack(xs), *states, rng=[s.rng for s in states],
                     rec_rng=[s.rec_rng for s in states])


def batched_vo_step(
    states: VOState, images: torch.Tensor, Ks: torch.Tensor, cfg: VOConfig
) -> tuple[VOState, StepOutput]:
    """One lockstep step: states, images (B, H, W) and Ks (B, 3, 3) carry a
    leading lane axis. On the card the detection of all lanes is one launch
    of the corner kernel and each patch gather one launch of the gather
    kernel."""
    if not is_lane_samplers(states.rng):
        raise ValueError("batched_vo_step needs a batched state (replicate_state / stack_states)")
    b = len(states.rng)
    if images.ndim != 3 or images.shape[0] != b or Ks.shape != (b, 3, 3):
        raise ValueError(
            f"{b} lanes need images (B, H, W) and Ks (B, 3, 3), got "
            f"{tuple(images.shape)} and {tuple(Ks.shape)}")
    return vo_step(states, images, Ks, cfg)


def batched_vo_rollout(
    states: VOState, images: torch.Tensor, Ks: torch.Tensor, cfg: VOConfig,
    graph: bool = True, spans: bool = True,
) -> tuple[VOState, StepOutput]:
    """`vo_rollout` over a stacked (N, B, H, W) frame block: N sequential
    frames of B independent sequences in lockstep, after checking the
    shapes. Returns the final batched state and the per-frame StepOutputs
    stacked to (N, B, ...). On CUDA lanes the step replays as CUDA graphs
    (models/graphed.py), with its spans unless `spans=False`; `graph=False`
    and the CPU run the eager loop."""
    if not is_lane_samplers(states.rng):
        raise ValueError("batched_vo_rollout needs a batched state (replicate_state / "
                         "stack_states)")
    b = len(states.rng)
    if images.ndim != 4 or images.shape[1] != b or Ks.shape != (b, 3, 3):
        raise ValueError(
            f"{b} lanes need images (N, B, H, W) and Ks (B, 3, 3), got "
            f"{tuple(images.shape)} and {tuple(Ks.shape)}")
    return vo_rollout(states, images, Ks, cfg, graph, spans)


def shard_batched_state(states: VOState, mesh) -> VOState:
    """This rank's lanes of a batched VOState given whole on every rank: the
    lane axis is split over the mesh "data" axis in equal blocks, and each
    lane keeps its own samplers."""
    n, i = axis_size(mesh, "data"), axis_index(mesh, "data")
    b = len(states.rng)
    if b % n:
        raise ValueError(f"{b} lanes do not split over {n} ranks of 'data'")
    per = b // n
    mine = slice(i * per, (i + 1) * per)
    return map_state(lambda x: local_rows(x, mesh, "data"), states,
                     rng=list(states.rng[mine]), rec_rng=list(states.rec_rng[mine]))


def make_sharded_rollout(mesh, cfg: VOConfig):
    """The rollout of a rank's lanes (`shard_batched_state`), the deployment
    shape for lanes over several cards or hosts. Returns rollout(states,
    images, Ks) with this rank's lanes: images (N, B_local, H, W), Ks
    (B_local, 3, 3); it gives the rank's final state and StepOutputs.

    The JAX package shard_maps the step so that XLA inserts no per-frame
    collective (its LK loop condition and top_k would otherwise synchronise
    the hosts every frame). Here each rank runs `batched_vo_rollout` on its
    own lanes, so the step contains no collective by construction; a lane's
    result is its result in one batch. `mesh` is the rank's placement."""
    del mesh  # the lanes were placed by shard_batched_state

    def rollout(states: VOState, images: torch.Tensor, Ks: torch.Tensor):
        return batched_vo_rollout(states, images, Ks, cfg)

    return rollout


def gather_lanes(outs: StepOutput, mesh) -> StepOutput:
    """Every rank's StepOutputs (N, B_local, ...) as (N, B, ...) in lane
    order, on every rank: for reporting, outside the step."""
    return StepOutput(*(all_gather(f, mesh, "data", dim=1) for f in outs))
