"""Fixed-budget, fully-batched RANSAC — port of vo_tpu/ops/ransac.py.

All hypotheses are sampled up front (Gumbel-top-k: uniform sampling without
replacement over valid slots), solved in one batched call, scored with one
batched error reduction, and the winner picked by argmax (first maximum).

Randomness: where the reference takes a `jax.random` key, the port takes a
*sampler* — a `torch.Generator` (the draws happen on its device), or a
callable with `sample_indices`' remaining arguments that returns (H, s)
indices drawn elsewhere. The tests use the latter to replay the JAX
package's exact draws.

Lanes: data with a leading lane axis (B, N, ...) runs B independent RANSACs
in one pass — (B, H, s) indices, (B, H, N) errors scored per lane, the
chunked running best per lane. The sampler of a batch is a SEQUENCE of B
samplers, one per lane (as the reference gives each lane its own key), and
lane b draws from the b-th alone: what a lane draws never depends on its
neighbours. `IDLE` stands in for the sampler of a lane whose result the
caller will discard: it draws nothing.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Sequence, Union

import torch

from vo_tpu_torch.ops.harris import top_k

# torch.Generator, or (num_hypotheses, num_points, sample_size, valid) -> (H, s).
Sampler = Union[torch.Generator, Callable[..., torch.Tensor]]
# One sampler, or one per lane of a batch.
Samplers = Union[Sampler, Sequence[Sampler]]


def IDLE(num_hypotheses, num_points, sample_size, valid=None) -> torch.Tensor:
    """The sampler of a lane that is computed but not used: the first
    `sample_size` slots for every hypothesis, and no random draw."""
    return torch.arange(sample_size).expand(num_hypotheses, sample_size)


def is_lane_samplers(key) -> bool:
    return isinstance(key, (list, tuple))


def num_iterations(
    confidence: float, outlier_ratio: float, sample_size: int, max_iterations: int = 4096
) -> int:
    """Static hypothesis budget k = log(1-conf) / log(1-(1-eps)^s)."""
    p_good = (1.0 - outlier_ratio) ** sample_size
    if p_good <= 1e-12:
        return max_iterations
    k = math.log(max(1.0 - confidence, 1e-12)) / math.log(max(1.0 - p_good, 1e-12))
    return int(min(max(math.ceil(k), 1), max_iterations))


class RansacResult(NamedTuple):
    model: Any  # best model (tensor or tuple of tensors)
    inliers: torch.Tensor  # (..., N) bool inlier mask of the best model
    num_inliers: torch.Tensor  # (...) int
    errors: torch.Tensor  # (..., N) residuals of the best model


def _map(fn, tree):
    """Apply fn to a tensor or to each tensor of a tuple (the port's pytrees)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(fn(x) for x in tree)
    return fn(tree)


def _map2(fn, a, b):
    if isinstance(a, (tuple, list)):
        return type(a)(fn(x, y) for x, y in zip(a, b))
    return fn(a, b)


def sample_indices(
    key: Samplers,
    num_hypotheses: int,
    num_points: int,
    sample_size: int,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """(H, s) int64 indices, each row distinct and drawn only from valid
    slots (Gumbel-top-k on the generator's device). A sequence of B samplers
    with `valid` (B, N) gives (B, H, s): lane b from sampler b alone."""
    if is_lane_samplers(key):
        return torch.stack([
            sample_indices(k, num_hypotheses, num_points, sample_size,
                           None if valid is None else valid[b])
            for b, k in enumerate(key)
        ])
    if callable(key):
        idx = key(num_hypotheses, num_points, sample_size, valid)
        dev = valid.device if valid is not None else None
        return torch.as_tensor(idx, device=dev).long()
    dev = key.device
    logits = (
        torch.zeros((num_points,), dtype=torch.float32, device=dev)
        if valid is None
        else torch.where(valid.to(dev), 0.0, -float("inf"))
    )
    u = torch.rand((num_hypotheses, num_points), generator=key, device=dev)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u))
    _, idx = top_k(logits[None, :] + g, sample_size)
    return idx


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (*lead, N, *tail) gathered at idx (*lead, C, s) -> (*lead, C, s, *tail)."""
    lead = idx.ndim - 2
    tail = x.shape[lead + 1:]
    flat = idx.reshape(idx.shape[:lead] + (-1,) + (1,) * len(tail))
    out = torch.take_along_dim(x, flat, dim=lead)
    return out.reshape(idx.shape + tail)


def pick(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """x (*lead, C, *tail) at best (*lead) -> (*lead, *tail)."""
    lead = best.ndim
    idx = best.reshape(best.shape + (1,) * (x.ndim - lead))
    return torch.take_along_dim(x, idx, dim=lead).squeeze(lead)


def lane_by_lane(fn, *xs: torch.Tensor, core: int) -> torch.Tensor:
    """fn(*xs) computed one lane at a time: the leading dims of xs beyond
    their last `core` ones are flattened to lanes, fn runs on each lane as a
    (1, ...) slice, and the results are stacked back. A batched einsum or
    matmul picks its kernel by the batch shape, so a reduction that must
    round in a lane of B as in the single run of that lane (a batch of one)
    runs as that single run's call. Without leading dims, fn(*xs)."""
    lead = xs[0].shape[:-core]
    if not lead:
        return fn(*xs)
    flat = [x.reshape((-1,) + x.shape[len(lead):]) for x in xs]
    out = torch.cat([fn(*(x[i:i + 1] for x in flat)) for i in range(flat[0].shape[0])])
    return out.reshape(lead + out.shape[1:])


def where_lane(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with a per-lane condition (*lead) against (*lead, *tail)."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - cond.ndim)), a, b)


def ransac(
    key: Samplers,
    data: Any,
    num_points: int,
    sample_size: int,
    num_hypotheses: int,
    model_fn: Callable[[Any], tuple[Any, torch.Tensor]],
    error_fn: Callable[[Any, Any], torch.Tensor],
    inlier_threshold: float,
    valid: torch.Tensor | None = None,
    chunk_size: int = 1024,
) -> RansacResult:
    """Fixed-budget RANSAC.

    data: tensor or tuple of tensors with leading axis N, or (B, N) with a
    lane axis (then `key` is a sequence of B samplers and `valid` (B, N)).
    model_fn maps BATCHED minimal samples (leaves (..., C, s, ...)) to
    (models (..., C, ...), ok (..., C) bool); error_fn maps (models
    (..., C, ...), data) to (..., C, N) residuals — the batch axis the
    reference adds with vmap is written out. Inliers are error < threshold
    (restricted to `valid`). Budgets above `chunk_size` run as blocks
    carrying the running best, so the (H, N) error matrix never
    materializes.
    """

    def _score_block(idx_block):
        samples = _map(lambda x: _rows(x, idx_block), data)
        models, ok = model_fn(samples)
        errors = error_fn(models, data)  # (..., C, N)
        inlier_mask = errors < inlier_threshold
        if valid is not None:
            inlier_mask = inlier_mask & valid[..., None, :]
        scores = inlier_mask.sum(dim=-1) * ok.to(torch.int64)
        return models, scores, errors, inlier_mask

    if num_hypotheses <= chunk_size:
        idx = sample_indices(key, num_hypotheses, num_points, sample_size, valid)
        models, scores, errors, inlier_mask = _score_block(idx)
        best = torch.argmax(scores, dim=-1)
        return RansacResult(
            model=_map(lambda x: pick(x, best), models),
            inliers=pick(inlier_mask, best),
            num_inliers=pick(scores, best),
            errors=pick(errors, best),
        )

    n_chunks = -(-num_hypotheses // chunk_size)
    idx = sample_indices(key, n_chunks * chunk_size, num_points, sample_size, valid)
    idx = idx.reshape(idx.shape[:-2] + (n_chunks, chunk_size, sample_size))
    best_score = None
    best_model = None
    for blk in range(n_chunks):
        models, scores, _, _ = _score_block(idx[..., blk, :, :])
        b = torch.argmax(scores, dim=-1)
        blk_score = pick(scores, b)
        blk_model = _map(lambda x: pick(x, b), models)
        if best_score is None:
            best_score, best_model = blk_score, blk_model
            continue
        take_new = blk_score > best_score
        best_model = _map2(lambda n, o: where_lane(take_new, n, o), blk_model, best_model)
        best_score = torch.maximum(best_score, blk_score)
    lead = best_score.ndim
    errors = error_fn(_map(lambda x: x.unsqueeze(lead), best_model), data)[..., 0, :]
    inliers = errors < inlier_threshold
    if valid is not None:
        inliers = inliers & valid
    return RansacResult(
        model=best_model, inliers=inliers, num_inliers=inliers.sum(dim=-1), errors=errors
    )
