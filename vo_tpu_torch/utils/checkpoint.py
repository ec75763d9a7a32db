"""Checkpoint / resume of the full VO state — port of
vo_tpu/utils/checkpoint.py.

The ENTIRE pipeline state (feature table, poses, pyramid, BA window,
sampler) is a tree of tensors, so a checkpoint is one device->host snapshot
written as a compressed .npz plus a JSON sidecar for the config; resume
rebuilds the tree and continues bit-exactly on the same kind of device (the
step is a function of (state, frame) and of the sampler's stream).

The file format is the reference's v2: keys are the state's KEY PATHS
("state/table/xy", "state/pyramid/0", "_backend/graph/node_pose", ...) plus
`_format_version`, so a checkpoint written by the JAX package loads here,
every leaf but the sampler. The samplers are `torch.Generator`s: their
`get_state()` bytes are stored under "state/rng" (PnP's), "state/rec_rng"
(the recovery's) and "_backend/key" (the back-end's) with the device kind
beside each, and restored with `set_state`. A `jax.random` key found under
"state/rng" cannot be turned into a generator, and a file the JAX package
or an older port wrote has no "state/rec_rng": the caller passes the
sampler to continue with, and no stream is guessed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Any

import numpy as np
import torch

from vo_tpu_torch.models.ba import BAWindow
from vo_tpu_torch.models.feature_table import FeatureTable
from vo_tpu_torch.models.pipeline import VOState, _to_tensor, state_from_numpy
from vo_tpu_torch.ops.ransac import is_lane_samplers
from vo_tpu_torch.utils.config import VOConfig

# Format history:
#   v1: positional leaf_{i} arrays, no version field.
#   v2: keys are key paths (e.g. "state/table/xy"), plus a _format_version
#      field — v1 files load through the positional fallback when the leaf
#      count matches, otherwise fail with a clear message.
_FORMAT_VERSION = 2

_SCALARS_BEFORE_WINDOW = ("frame_idx", "next_uid", "rng")
_SCALARS_AFTER_WINDOW = ("last_kf_idx", "kf_adaptive", "last_speed")


def _leaf_keys(pyramid_levels: int) -> list[str]:
    """The state's leaves by key path, in the order the reference flattens
    them (VOState field order, NamedTuples and the pyramid expanded)."""
    keys = [f"state/table/{f}" for f in FeatureTable._fields]
    keys += ["state/pose", "state/prev_pose"]
    keys += [f"state/pyramid/{i}" for i in range(pyramid_levels)]
    keys += [f"state/{f}" for f in _SCALARS_BEFORE_WINDOW]
    keys += [f"state/window/{f}" for f in BAWindow._fields]
    keys += [f"state/{f}" for f in _SCALARS_AFTER_WINDOW]
    return keys


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _generator_state(gen, what: str) -> np.ndarray:
    if not isinstance(gen, torch.Generator):
        raise TypeError(
            f"{what} is {type(gen).__name__}, not a torch.Generator: only a "
            "generator's state can be written to a checkpoint")
    return gen.get_state().numpy()


def _restore_generator(raw: np.ndarray, kind: str, device: torch.device, what: str):
    if kind != device.type:
        raise ValueError(
            f"{what} was saved from a {kind} generator and cannot continue on "
            f"{device.type}: resume on the same kind of device, or pass a sampler")
    gen = torch.Generator(device=device)
    gen.set_state(torch.from_numpy(np.ascontiguousarray(raw, dtype=np.uint8)))
    return gen


def _flatten(state: VOState) -> dict[str, np.ndarray]:
    if is_lane_samplers(state.rng):
        raise ValueError("a batched state is checkpointed lane by lane")
    arrays = {f"state/table/{k}": _np(v) for k, v in state.table._asdict().items()}
    arrays.update({f"state/window/{k}": _np(v) for k, v in state.window._asdict().items()})
    arrays.update({f"state/pyramid/{i}": _np(p) for i, p in enumerate(state.pyramid)})
    for name in ("pose", "prev_pose", "frame_idx", "next_uid") + _SCALARS_AFTER_WINDOW:
        arrays[f"state/{name}"] = _np(getattr(state, name))
    arrays["state/rng"] = _generator_state(state.rng, "the state's sampler")
    arrays["_rng_device"] = np.asarray(state.rng.device.type)
    arrays["state/rec_rng"] = _generator_state(state.rec_rng, "the recovery's sampler")
    arrays["_rec_rng_device"] = np.asarray(state.rec_rng.device.type)
    return arrays


def save_checkpoint(
    path: str,
    state: VOState,
    cfg: VOConfig,
    trajectory: list[np.ndarray] | None = None,
    frame_ids: list[int] | None = None,
    backend: Any = None,
) -> None:
    """Write state + config (+ trajectory so far, + pose-graph back-end) to
    `path` (.npz). `backend` is an optional models.backend.PoseGraphBackend;
    its graph, keyframe DB, generator and accepted-loop bookkeeping are
    serialized so a resumed run can close loops whose first visit happened
    before the restart."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = _flatten(state)
    arrays["_format_version"] = np.asarray(_FORMAT_VERSION)
    arrays["_pyramid_levels"] = np.asarray(len(state.pyramid))
    if trajectory is not None:
        arrays["_trajectory"] = np.stack(trajectory)
        arrays["_frame_ids"] = np.asarray(frame_ids if frame_ids is not None else [])
    sidecar = _cfg_to_dict(cfg)
    if backend is not None:
        for name, tree in (("graph", backend.graph), ("db", backend.db)):
            for field, x in tree._asdict().items():
                arrays[f"_backend/{name}/{field}"] = _np(x)
        arrays["_backend/key"] = _generator_state(backend.key, "the back-end's generator")
        arrays["_backend/key_device"] = np.asarray(backend.key.device.type)
        arrays["_backend/K"] = _np(backend.K)
        sidecar["_backend"] = dict(
            cfg=dataclasses.asdict(backend.cfg),
            loops=backend.loops,
            rejected=backend.rejected,
            n_culled=backend.n_culled,
        )
    np.savez_compressed(path, **arrays)
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=1)


def load_backend(path: str, device="cuda", key=None):
    """Reconstruct the PoseGraphBackend stored by `save_checkpoint` on
    `device`, or None if the checkpoint ran without one. `key` replaces the
    stored generator (needed for a file the JAX package wrote)."""
    from vo_tpu_torch.models.backend import BackendConfig, backend_from_numpy
    from vo_tpu_torch.models.keyframe_db import KeyframeDB
    from vo_tpu_torch.models.pose_graph import PoseGraph

    with open(path + ".json") as f:
        sidecar = json.load(f)
    if "_backend" not in sidecar:
        return None
    device = torch.device(device)
    data = np.load(path)
    meta = sidecar["_backend"]
    if key is None:
        if "_backend/key_device" not in data:
            raise ValueError(
                f"checkpoint {path} holds a jax.random key for its back-end, which "
                "is no torch.Generator: pass `key`")
        key = _restore_generator(data["_backend/key"], str(data["_backend/key_device"]),
                                 device, "the back-end's generator")
    return backend_from_numpy(
        {f: data[f"_backend/graph/{f}"] for f in PoseGraph._fields},
        {f: data[f"_backend/db/{f}"] for f in KeyframeDB._fields},
        data["_backend/K"], BackendConfig(**meta["cfg"]), device, key=key,
        loops=meta["loops"], rejected=meta["rejected"], n_culled=meta["n_culled"],
    )


def load_checkpoint(path: str, device="cuda", rng=None,
                    rec_rng=None) -> tuple[VOState, VOConfig, Any, Any]:
    """Read (state, cfg, trajectory, frame_ids) back from `path`, the state
    on `device`. `rng` and `rec_rng` replace the stored samplers (PnP's and
    the recovery's); they are needed for a file the JAX package wrote (its
    PRNG key is no generator), and `rec_rng` for a file written before the
    recovery had a stream of its own."""
    device = torch.device(device)
    with open(path + ".json") as f:
        cfg = _cfg_from_dict(json.load(f))
    data = np.load(path)
    n_pyr = int(data["_pyramid_levels"])
    keys = _leaf_keys(n_pyr)
    version = int(data["_format_version"]) if "_format_version" in data else 1
    if version >= 2:
        # Key-path format: missing fields fail by NAME, and fields this
        # version no longer has are ignored (forward compatible).
        missing = [k for k in keys if k not in data]
        if missing:
            raise KeyError(
                f"checkpoint {path} (format v{version}) is missing state "
                f"fields {missing} — written by an older version; re-run or "
                f"migrate it"
            )
        leaves = {k: data[k] for k in keys}
    else:  # v1 fallback: positional leaves, valid only if the count matches
        n_leaves = len(keys)
        if f"leaf_{n_leaves - 1}" not in data or f"leaf_{n_leaves}" in data:
            raise KeyError(
                f"checkpoint {path} is v1 (positional) and its leaf count "
                f"does not match this version's VOState — re-run from scratch"
            )
        leaves = {k: data[f"leaf_{i}"] for i, k in enumerate(keys)}
    if rng is None:
        if "_rng_device" not in data:
            raise ValueError(
                f"checkpoint {path} holds a jax.random key, which is no "
                "torch.Generator: pass the sampler to continue with as `rng`")
        rng = _restore_generator(leaves["state/rng"], str(data["_rng_device"]), device,
                                 "the state's sampler")
    if rec_rng is None:
        if "state/rec_rng" not in data:
            raise KeyError(
                f"checkpoint {path} has no 'state/rec_rng' (the recovery's stream): it "
                "was written by the JAX package or before the recovery drew from a "
                "stream of its own; pass the sampler to continue with as `rec_rng`")
        rec_rng = _restore_generator(data["state/rec_rng"], str(data["_rec_rng_device"]),
                                     device, "the recovery's sampler")
    tree = {k[len("state/"):]: v for k, v in leaves.items()
            if k.count("/") == 1 and k != "state/rng"}
    tree["table"] = {f: leaves[f"state/table/{f}"] for f in FeatureTable._fields}
    tree["window"] = {f: leaves[f"state/window/{f}"] for f in BAWindow._fields}
    tree["pyramid"] = [leaves[f"state/pyramid/{i}"] for i in range(n_pyr)]
    state = state_from_numpy(tree, device, rng, rec_rng)
    traj = data["_trajectory"] if "_trajectory" in data else None
    fids = data["_frame_ids"] if "_frame_ids" in data else None
    return state, cfg, traj, fids


def _cfg_to_dict(cfg: VOConfig) -> dict:
    return dataclasses.asdict(cfg)


def _cfg_from_dict(d: dict) -> VOConfig:
    """Rebuild VOConfig from its asdict()/JSON form by dataclass
    introspection, so every field — present and future — round-trips (a
    field missing from an OLD checkpoint keeps its current default rather
    than raising)."""
    hints = typing.get_type_hints(VOConfig)
    kw = {}
    for f in dataclasses.fields(VOConfig):
        if f.name not in d:
            continue  # older checkpoint: keep this version's default
        v = d[f.name]
        t = hints[f.name]
        if dataclasses.is_dataclass(t):
            known = {g.name for g in dataclasses.fields(t)}
            kw[f.name] = t(
                **{
                    k: (tuple(x) if isinstance(x, list) else x)
                    for k, x in v.items()
                    if k in known
                }
            )
        elif t is tuple or isinstance(f.default, tuple):
            kw[f.name] = tuple(v)  # JSON stores tuples as lists
        else:
            kw[f.name] = v
    return VOConfig(**kw)
