"""Fixed-budget, fully-batched RANSAC — port of vo_tpu/ops/ransac.py.

All hypotheses are sampled up front (Gumbel-top-k: uniform sampling without
replacement over valid slots), solved in one batched call, scored with one
batched error reduction, and the winner picked by argmax (first maximum).

Randomness: where the reference takes a `jax.random` key, the port takes a
*sampler* — a `torch.Generator` (the draws happen on its device), or a
callable with `sample_indices`' remaining arguments that returns (H, s)
indices drawn elsewhere. The tests use the latter to replay the JAX
package's exact draws.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Union

import torch

from vo_tpu_torch.ops.harris import top_k

# torch.Generator, or (num_hypotheses, num_points, sample_size, valid) -> (H, s).
Sampler = Union[torch.Generator, Callable[..., torch.Tensor]]


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
    inliers: torch.Tensor  # (N,) bool inlier mask of the best model
    num_inliers: torch.Tensor  # () int
    errors: torch.Tensor  # (N,) residuals of the best model


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
    key: Sampler,
    num_hypotheses: int,
    num_points: int,
    sample_size: int,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """(H, s) int64 indices, each row distinct and drawn only from valid
    slots (Gumbel-top-k on the generator's device)."""
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


def ransac(
    key: Sampler,
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

    data: tensor or tuple of tensors with leading axis N. model_fn maps
    BATCHED minimal samples (leaves (C, s, ...)) to (models (C, ...), ok (C,)
    bool); error_fn maps (models (C, ...), data) to (C, N) residuals — the
    batch axis the reference adds with vmap is written out. Inliers are
    error < threshold (restricted to `valid`). Budgets above `chunk_size`
    run as blocks carrying the running best, so the (H, N) error matrix
    never materializes.
    """

    def _score_block(idx_block):
        c = idx_block.shape[0]
        samples = _map(
            lambda x: x[idx_block.reshape(-1)].reshape((c, sample_size) + x.shape[1:]),
            data,
        )
        models, ok = model_fn(samples)
        errors = error_fn(models, data)  # (C, N)
        inlier_mask = errors < inlier_threshold
        if valid is not None:
            inlier_mask = inlier_mask & valid[None, :]
        scores = inlier_mask.sum(dim=1) * ok.to(torch.int64)
        return models, scores, errors, inlier_mask

    if num_hypotheses <= chunk_size:
        idx = sample_indices(key, num_hypotheses, num_points, sample_size, valid)
        models, scores, errors, inlier_mask = _score_block(idx)
        best = torch.argmax(scores)
        return RansacResult(
            model=_map(lambda x: x[best], models),
            inliers=inlier_mask[best],
            num_inliers=scores[best],
            errors=errors[best],
        )

    n_chunks = -(-num_hypotheses // chunk_size)
    idx = sample_indices(
        key, n_chunks * chunk_size, num_points, sample_size, valid
    ).reshape(n_chunks, chunk_size, sample_size)
    best_score = None
    best_model = None
    for blk in range(n_chunks):
        models, scores, _, _ = _score_block(idx[blk])
        b = torch.argmax(scores)
        blk_score = scores[b]
        blk_model = _map(lambda x: x[b], models)
        if best_score is None:
            best_score, best_model = blk_score, blk_model
            continue
        take_new = blk_score > best_score
        best_model = _map2(lambda n, o: torch.where(take_new, n, o), blk_model, best_model)
        best_score = torch.maximum(best_score, blk_score)
    errors = error_fn(_map(lambda x: x[None], best_model), data)[0]
    inliers = errors < inlier_threshold
    if valid is not None:
        inliers = inliers & valid
    return RansacResult(
        model=best_model, inliers=inliers, num_inliers=inliers.sum(), errors=errors
    )
