"""Rank bodies of the distributed tests of the port (tests/test_torch_dist.py).

`spawn(world, inputs)` starts `world` processes that join one Gloo group on
the CPU and run every distributed function of vo_tpu_torch.parallel on the
numpy `inputs` the test built; each rank returns its results as numpy
arrays. This module imports no jax and nothing of vo_tpu: the spawned ranks
import it.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np


def spawn(world: int, inputs: dict, timeout: float = 300) -> list[dict]:
    """Run `run_all` on `world` Gloo ranks; returns each rank's results. A
    rank that fails or outlives `timeout` kills the cluster and raises."""
    from vo_tpu_torch.parallel.mesh import free_port

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(rank, world, port, inputs, tmp))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.1))
            errors = [(Path(tmp) / f"{r}.err").read_text() for r in range(world)
                      if (Path(tmp) / f"{r}.err").exists()]
            if errors:
                raise RuntimeError("\n".join(errors))
            if any(p.is_alive() or p.exitcode != 0 for p in procs):
                raise RuntimeError(f"ranks exited {[p.exitcode for p in procs]} "
                                   f"within {timeout} s")
            return [pickle.loads((Path(tmp) / f"{r}.pkl").read_bytes()) for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()


def _rank_main(rank: int, world: int, port: int, inputs: dict, tmp: str) -> None:
    import torch
    import torch.distributed as dist

    from vo_tpu_torch.parallel.mesh import init_cluster

    torch.set_num_threads(1)
    try:
        init_cluster(f"tcp://localhost:{port}", world, rank, "cpu", "gloo")
        out = run_all(rank, world, inputs)
        (Path(tmp) / f"{rank}.pkl").write_bytes(pickle.dumps(out))
    except BaseException:
        (Path(tmp) / f"{rank}.err").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def single_rank_main() -> None:
    """make_mesh with no process group and no launcher: a one-rank Gloo
    group on the CPU, in which distributed BA is ba_refine bit for bit.
    Exits non-zero on any failure."""
    import torch
    import torch.distributed as dist

    from vo_tpu_torch.models.ba import ba_refine
    from vo_tpu_torch.parallel.dist_ba import demo_window, distributed_ba_refine, shard_window
    from vo_tpu_torch.parallel.mesh import axis_size, make_mesh

    torch.set_num_threads(1)
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert axis_size(mesh, "data") == 1 and axis_size(mesh, "model") == 1
    win = demo_window(32, 4)
    K = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    out, errs = distributed_ba_refine(mesh, shard_window(win, mesh), K)
    ref, ref_errs = ba_refine(win, K)
    assert torch.equal(errs, ref_errs)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    try:
        make_mesh(n_data=2, device="cpu")
        raise AssertionError("a 2 x 1 mesh over one rank was accepted")
    except ValueError:
        pass
    dist.destroy_process_group()


def _np(x):
    if isinstance(x, tuple):
        return type(x)(*(_np(v) for v in x)) if hasattr(x, "_fields") else tuple(map(_np, x))
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def run_all(rank: int, world: int, inputs: dict) -> dict:
    """Every body this rank takes part in, by name."""
    out = {"mesh": mesh_body(world), "gn": gn_body(world, inputs["gn"]),
           "ba": ba_body(world, inputs["ba"]), "pg": pg_body(world, inputs["pg"]),
           "seqpar": seqpar_body(world, inputs["seqpar"])}
    for cap, lanes in inputs.get("rollout", {}).items():
        out[f"rollout_{cap}"] = rollout_body(world, lanes, cap)
    return out


def mesh_body(world: int) -> dict:
    """The mesh helpers on a (world / 2, 2) mesh: coordinates, psum,
    all_gather, broadcast and local rows along each axis."""
    import torch

    from vo_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(n_data=world // 2, n_model=2, device="cpu")
    rank = torch.distributed.get_rank()
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    out = {"shape": tuple(mesh.mesh.shape), "names": mesh.mesh_dim_names, "rank": rank}
    for axis in M.AXES:
        out[axis] = dict(
            size=M.axis_size(mesh, axis), index=M.axis_index(mesh, axis),
            psum=_np(M.psum(x, mesh, axis)),
            gather0=_np(M.all_gather(x, mesh, axis, 0)),
            gather1=_np(M.all_gather(x > 13, mesh, axis, 1)),
            bcast=_np(M.broadcast(x, mesh, axis)),
            rows=_np(M.local_rows(torch.arange(8 * world).reshape(4 * world, 2), mesh, axis)),
        )
    return out


def gn_body(world: int, d: dict) -> dict:
    import torch

    from vo_tpu_torch.parallel.dist_gn import distributed_refine_pose
    from vo_tpu_torch.parallel.mesh import local_rows, make_mesh

    mesh = make_mesh(n_data=1, n_model=world, device="cpu")
    X, uv, w = (local_rows(torch.from_numpy(d[k]), mesh, "model") for k in ("X", "uv", "w"))
    T = distributed_refine_pose(mesh, torch.from_numpy(d["T0"]), X, uv, w,
                                torch.from_numpy(d["K"]), iters=d["iters"])
    return {"T": _np(T)}


def _window(arrays):
    import torch

    from vo_tpu_torch.models.ba import BAWindow

    return BAWindow(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))


def ba_body(world: int, d: dict) -> dict:
    import torch

    from vo_tpu_torch.parallel.dist_ba import distributed_ba_refine, shard_window
    from vo_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=1, n_model=world, device="cpu")
    out, errs = distributed_ba_refine(mesh, shard_window(_window(d["window"]), mesh),
                                      torch.from_numpy(d["K"]), iters=d["iters"])
    return {"window": _np(out), "errs": _np(errs)}


def pg_body(world: int, d: dict) -> dict:
    import torch

    from vo_tpu_torch.models.pose_graph import PoseGraph
    from vo_tpu_torch.parallel.dist_pg import distributed_pg_optimize
    from vo_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=1, n_model=world, device="cpu")
    graph = PoseGraph(*(torch.from_numpy(np.ascontiguousarray(a)) for a in d["graph"]))
    out, errs = distributed_pg_optimize(mesh, graph, iters=d["iters"], damping=d["damping"])
    return {"node_pose": _np(out.node_pose), "errs": _np(errs)}


def seqpar_body(world: int, d: dict) -> dict:
    import torch

    from vo_tpu_torch.parallel.mesh import make_mesh
    from vo_tpu_torch.parallel.window_blocks import (
        gather_window_blocks,
        seqpar_ba_refine,
        shard_window_blocks,
    )

    mesh = make_mesh(n_data=1, n_model=world, device="cpu")
    out, errs = seqpar_ba_refine(mesh, shard_window_blocks(_window(d["window"]), mesh),
                                 torch.from_numpy(d["K"]), iters=d["iters"])
    return {"window": _np(gather_window_blocks(out, mesh)), "errs": _np(errs)}


def rollout_body(world: int, d: dict, capacity: int) -> dict:
    """Every lane bootstrapped alone with its sampler seeded from its global
    lane index, stacked, this rank's lanes rolled with the sharded rollout,
    the outputs gathered over "data"."""
    import torch

    from vo_tpu_torch.parallel.mesh import local_rows, make_mesh
    from vo_tpu_torch.parallel.multiseq import (
        gather_lanes,
        make_sharded_rollout,
        shard_batched_state,
    )

    mesh = make_mesh(n_data=world, n_model=1, device="cpu")
    states, images, Ks, cfg = lane_inputs(d, capacity)
    rollout = make_sharded_rollout(mesh, cfg)
    final, outs = rollout(shard_batched_state(states, mesh),
                          local_rows(images, mesh, "data", 1), local_rows(Ks, mesh, "data"))
    return {"outs": _np(gather_lanes(outs, mesh)), "uid": _np(final.table.uid)}


def lane_inputs(d: dict, capacity: int):
    """(stacked states, images (N, B, H, W), Ks (B, 3, 3), config) of the
    lanes in `d`: lane b is bootstrapped on its own frames 0 and 2 with the
    sampler seed 7 + b."""
    import torch

    from vo_tpu_torch.models.pipeline import bootstrap
    from vo_tpu_torch.parallel.multiseq import stack_states
    from vo_tpu_torch.utils.config import DetectorConfig, KLTConfig, VOConfig

    cfg = VOConfig(capacity=capacity, detector=DetectorConfig(border=8, nms_radius=4),
                   klt=KLTConfig(pyramid_levels=2, radius=4))
    frames = torch.from_numpy(d["frames"])  # (B, F, H, W)
    K = torch.from_numpy(d["K"])
    states = stack_states([
        bootstrap(f[0], f[2], K, cfg, torch.Generator().manual_seed(7 + b))[0]
        for b, f in enumerate(frames)])
    return states, frames[:, 3:].transpose(0, 1).contiguous(), K.expand(
        frames.shape[0], 3, 3).contiguous(), cfg
