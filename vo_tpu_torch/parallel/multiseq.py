"""Data-parallel multi-sequence VO — port of vo_tpu/parallel/multiseq.py.

Throughput scaling for an inherently sequential problem (frame t+1 needs
pose t): run B independent sequences in lockstep, one step over a batched
VOState. Latency per sequence is unchanged; the step's eager dispatch cost
is paid once for B lanes instead of B times.

Where the reference wraps `vo_step` in `jax.vmap`, the port's `vo_step`
takes the lane axis itself (models/pipeline.py): every leaf of the state
carries a leading B, and the two kernels run once per call over all lanes
(K1b, K2b) — there is no loop over lanes in the step's tensor work. Only the
RANSAC draws are made lane by lane, each from the lane's own sampler, so
lane b of a batched rollout is the single rollout of lane b.

The mesh placements of the reference (`shard_batched_state`,
`make_sharded_rollout`) wait for the distributed port.
"""

from __future__ import annotations

from typing import Sequence

import torch

from vo_tpu_torch.models.pipeline import StepOutput, VOState, map_state, vo_step
from vo_tpu_torch.ops.ransac import Sampler, is_lane_samplers
from vo_tpu_torch.utils.config import VOConfig

_NOT_PORTED = (
    "{name} is not ported yet (ROADMAP Queue 1, item 15: the mesh and "
    "multi-host placements go with the torch.distributed port); on one card "
    "a batched state needs no placement"
)


def replicate_state(state: VOState, batch: int, samplers: Sequence[Sampler]) -> VOState:
    """Tile a single-sequence VOState into a batched one (leading axis B).
    `samplers` are the B independent RANSAC samplers of the lanes (where the
    reference splits the state's key B ways)."""
    samplers = list(samplers)
    if len(samplers) != batch:
        raise ValueError(f"{batch} lanes need {batch} samplers, got {len(samplers)}")
    return map_state(
        lambda x: x[None].expand((batch,) + x.shape).contiguous(), state, rng=samplers)


def stack_states(states: Sequence[VOState]) -> VOState:
    """Stack single-sequence VOStates (each bootstrapped on its own) into one
    batched state; lane b keeps state b's sampler."""
    states = list(states)
    if any(is_lane_samplers(s.rng) for s in states):
        raise ValueError("stack_states takes single-sequence states")
    return map_state(lambda *xs: torch.stack(xs), *states, rng=[s.rng for s in states])


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
    states: VOState, images: torch.Tensor, Ks: torch.Tensor, cfg: VOConfig
) -> tuple[VOState, StepOutput]:
    """Run `batched_vo_step` over a stacked (N, B, H, W) frame block: N
    sequential frames of B independent sequences in lockstep. Returns the
    final batched state and the per-frame StepOutputs stacked to (N, B, ...)."""
    outs = []
    for block in images:
        states, out = batched_vo_step(states, block, Ks, cfg)
        outs.append(out)
    return states, StepOutput(*(torch.stack(f) for f in zip(*outs)))


def shard_batched_state(states: VOState, mesh) -> VOState:
    raise NotImplementedError(_NOT_PORTED.format(name="shard_batched_state"))


def make_sharded_rollout(mesh, cfg: VOConfig):
    raise NotImplementedError(_NOT_PORTED.format(name="make_sharded_rollout"))
