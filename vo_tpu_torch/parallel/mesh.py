"""Device meshes over torch.distributed — port of vo_tpu/parallel/mesh.py.

The JAX package expresses scale-out as a `jax.sharding.Mesh` with named axes
and `shard_map` programs whose collectives are `psum` / `all_gather`. The
port keeps the mesh and its axis names and follows PyTorch's idiom for the
rest: one process per rank holds its shard (what `shard_map` calls the local
view), and the collectives are explicit calls on the axis's process group.

Axes:
  "data"  — independent work (sequences / lanes);
  "model" — sharded map state (landmark rows of distributed BA, observation
            rows of distributed GN, edges of the pose graph, keyframe blocks
            of sequence-parallel BA).

A rank's device is `cuda:{local_rank % torch.cuda.device_count()}` unless the
caller asks for the CPU. The backend is NCCL on the card and Gloo on the CPU;
ranks that share one card (NCCL refuses two ranks on one GPU) use Gloo on
CUDA tensors, which carries `all_reduce` and `broadcast`. Every gather below
is therefore an all-reduce: exact, since each element is one rank's value
plus zeros.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "model")
# A rank that waits this long for its peers raises instead of hanging.
TIMEOUT = datetime.timedelta(seconds=300)


def free_port() -> int:
    """A TCP port on localhost that is free now (for a cluster's rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when asked (`device="cpu"`), else
    `cuda:{local_rank % device_count}` (LOCAL_RANK, or the global rank of an
    initialized group)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def default_backend(device: torch.device, world_size: int) -> str:
    """NCCL when every rank has a card of its own, else Gloo (NCCL refuses
    two ranks on one GPU). Callers print what they chose."""
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_cluster(init_method: str, world_size: int, rank: int, device,
                 backend: str | None = None) -> str:
    """Join a process group of `world_size` ranks at `init_method`
    (`tcp://host:port`); returns the backend. Sets this rank's CUDA device
    first, so NCCL binds to it."""
    dev = rank_device(device)
    backend = backend or default_backend(dev, world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=TIMEOUT)
    return backend


def make_mesh(n_data: int | None = None, n_model: int = 1, device=None) -> DeviceMesh:
    """A ("data", "model") DeviceMesh over every rank; all ranks on "data" by
    default. With no process group yet (no launcher), a single-rank group is
    set up on a free port: NCCL on the card, Gloo on the CPU."""
    dev = rank_device(device)
    if not dist.is_initialized():
        init_cluster(f"tcp://localhost:{free_port()}", 1, 0, dev)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks, "
                         f"the group has {world}")
    return init_device_mesh(dev.type, (n_data, n_model), mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis` (jax.lax.axis_index)."""
    return mesh.get_local_rank(axis)


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum of x over the ranks of `axis` (jax.lax.psum): a new tensor, equal
    on every rank of the axis."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return y


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The blocks of every rank of `axis` concatenated along `dim` in axis
    order (jax.lax.all_gather(..., tiled=True)). An all-reduce of a
    zero-filled (ranks, ...) buffer that holds only this rank's block."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    dtype = torch.uint8 if x.dtype == torch.bool else x.dtype
    buf = torch.zeros((n,) + tuple(x.shape), dtype=dtype, device=x.device)
    buf[i] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    dim = dim % max(x.ndim, 1)
    out = buf.movedim(0, dim).reshape(x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:])
    return out.to(x.dtype)


def broadcast(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The first rank's x along `axis`, on every rank of it: replicated state
    is sent, not recomputed by each rank."""
    group = mesh.get_group(axis)
    y = x.to(torch.uint8) if x.dtype == torch.bool else x.clone(
        memory_format=torch.contiguous_format)
    dist.broadcast(y, src=dist.get_global_rank(group, 0), group=group)
    return y.to(x.dtype)


def local_rows(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The rows of x along `dim` that this rank holds when `dim` is sharded
    over `axis` (equal blocks in axis order)."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} rows do not split over {n} ranks of {axis!r}")
    m = x.shape[dim] // n
    return x.narrow(dim, i * m, m).contiguous()
