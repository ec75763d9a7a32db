"""The distributed layer of the port (vo_tpu_torch.parallel: mesh, dist_gn,
dist_ba, dist_pg, window_blocks, the sharded rollout) against the JAX
package's sharded solvers, at 2 and 4 ranks.

The ranks are spawned processes joined in one Gloo group on the CPU
(tests/torch_dist_ranks.py, which imports no jax); the JAX side runs here on
the conftest's virtual CPU mesh, on the same numpy inputs. Tolerances are the
JAX package's own (tests/test_parallel.py, tests/test_window_blocks.py).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from vo_tpu.geom.lie import se3_exp as jse3_exp
from vo_tpu.models import ba as jba
from vo_tpu.models import pose_graph as jpg
from vo_tpu.parallel import dist_ba as jdist_ba
from vo_tpu.parallel.dist_gn import distributed_refine_pose as jdist_gn
from vo_tpu.parallel.dist_pg import distributed_pg_optimize as jdist_pg
from vo_tpu.parallel.mesh import make_mesh as jmake_mesh
from vo_tpu.parallel.window_blocks import seqpar_ba_refine as jseqpar
from vo_tpu.parallel.window_blocks import shard_window_blocks as jshard_blocks

from vo_tpu_torch.models import ba as tba
from vo_tpu_torch.parallel import dist_ba as tdist_ba
from vo_tpu_torch.parallel import multiseq as tmulti

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402

torch.set_num_threads(1)

K_GN = np.array([[500.0, 0, 160], [0, 500, 120], [0, 0, 1]], np.float32)
K_BA = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
K_LANES = np.array([[80.0, 0, 48.0], [0, 80.0, 36.0], [0, 0, 1.0]], np.float32)
WORLDS = [2, 4]
ROLLOUT_CAPACITIES = [64, 256]
LANES = 4  # the rollout: 2 ranks x 2 lanes against one batch of 4


def _gn_inputs():
    """tests/test_parallel.py's observation set, from a numpy seed."""
    rng = np.random.default_rng(2023)
    n = 128
    X = rng.uniform([-5, -3, 8], [5, 3, 30], (n, 3)).astype(np.float32)
    xi = np.array([0.3, -0.1, 0.2, 0.05, -0.08, 0.1], np.float32)
    T_true = np.asarray(jse3_exp(jnp.asarray(xi)))
    Xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv_h = Xc @ K_GN.T
    uv = (uv_h[:, :2] / uv_h[:, 2:]).astype(np.float32)
    T0 = np.asarray(jse3_exp(jnp.asarray(xi + rng.normal(0, 0.03, 6).astype(np.float32))))
    return dict(X=X, uv=uv, w=np.ones(n, np.float32), T0=T0, T_true=T_true, K=K_GN, iters=8)


def _pg_graph():
    """tests/test_parallel.py's 24-node chain with one loop edge (JAX)."""
    rng = np.random.default_rng(11)
    n = 24
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        c, s = np.cos(2 * np.pi / n), np.sin(2 * np.pi / n)
        d = np.eye(4, dtype=np.float32)
        d[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        d[:3, 3] = [0, 0, 1.0]
        poses.append(poses[-1] @ d)
    gt = np.stack(poses)
    g = jpg.empty_pose_graph(num_nodes=n + 4, num_loop_edges=8)
    cur = jnp.asarray(gt[0])
    g = jpg.add_node(g, cur, 0)
    for k in range(1, n):
        rel = np.linalg.inv(gt[k - 1]) @ gt[k]
        noise = 0.01 * rng.standard_normal(6).astype(np.float32)
        rel = rel @ np.asarray(jse3_exp(jnp.asarray(noise)))
        cur = cur @ jnp.asarray(rel)
        g = jpg.add_node(g, cur, k)
    return jpg.add_loop_edge(g, jnp.int32(0), jnp.int32(n - 1),
                             jnp.asarray(np.linalg.inv(gt[0]) @ gt[n - 1]))


def _lane_frames(seed: int, n: int = 8, dx: int = 2) -> np.ndarray:
    """The rolled random image of tests/test_torch_multiseq.py."""
    base = 127.0 + 40.0 * np.random.default_rng(seed).standard_normal((72, 96))
    return np.stack([np.roll(base, (i, dx * i), axis=(0, 1)) for i in range(n)]
                    ).astype(np.float32)


def _as_numpy(tree):
    return tuple(np.asarray(x) for x in tree)


@functools.cache
def _inputs(world: int) -> dict:
    d = {
        "gn": _gn_inputs(),
        "ba": dict(window=_as_numpy(jdist_ba.demo_window(96, 4)), K=K_BA, iters=4),
        "pg": dict(graph=_as_numpy(_pg_graph()), iters=6, damping=1e-5),
        "seqpar": dict(window=_as_numpy(jdist_ba.demo_window(96, 12)), K=K_BA, iters=4),
    }
    if world == 2:
        lanes = dict(frames=np.stack([_lane_frames(b) for b in range(LANES)]), K=K_LANES)
        d["rollout"] = {cap: lanes for cap in ROLLOUT_CAPACITIES}
    return d


@functools.cache
def _cluster(world: int) -> list:
    """Every rank's results of every body, from ONE spawned cluster a size."""
    return ranks.spawn(world, _inputs(world), timeout=300)


def _jmesh(world: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:world]).reshape(1, world), ("data", "model"))


def _rows(parts, dim=0):
    return np.concatenate(parts, axis=dim)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_mesh_collectives(world):
    got = _cluster(world)
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r for r in range(world)]
    for r, res in enumerate(got):
        m = res["mesh"]
        assert m["shape"] == (world // 2, 2) and tuple(m["names"]) == ("data", "model")
        coords = {"data": r // 2, "model": r % 2}
        for axis in ("data", "model"):
            a = m[axis]
            members = [q for q in range(world)
                       if all(coords[o] == {"data": q // 2, "model": q % 2}[o]
                              for o in ("data", "model") if o != axis)]
            assert a["size"] == len(members) and a["index"] == coords[axis]
            np.testing.assert_array_equal(a["psum"], sum(x[q] for q in members))
            np.testing.assert_array_equal(a["gather0"], _rows([x[q] for q in members]))
            np.testing.assert_array_equal(a["gather1"], _rows([x[q] > 13 for q in members], 1))
            np.testing.assert_array_equal(a["bcast"], x[members[0]])
            rows = np.arange(8 * world).reshape(4 * world, 2)
            n = 4 * world // a["size"]
            np.testing.assert_array_equal(a["rows"], rows[a["index"] * n:(a["index"] + 1) * n])


def test_make_mesh_sets_up_one_rank_without_a_launcher():
    """make_mesh at world size 1 with no process group: it sets one up
    itself (Gloo on the CPU); at one rank distributed BA is ba_refine bit for
    bit (the same sums in the same order)."""
    import multiprocessing

    p = multiprocessing.get_context("spawn").Process(target=ranks.single_rank_main)
    p.start()
    p.join(120)
    if p.is_alive():
        p.kill()
        p.join()
    assert p.exitcode == 0


# ---------------------------------------------------------------------------
# the sharded solvers against the JAX package's, at 2 and 4 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_distributed_refine_pose_matches_jax(world):
    d = _inputs(world)["gn"]
    want = np.asarray(jdist_gn(
        jmake_mesh(n_data=1, n_model=world), jnp.asarray(d["T0"]), jnp.asarray(d["X"]),
        jnp.asarray(d["uv"]), jnp.asarray(d["w"]), jnp.asarray(d["K"]), iters=d["iters"]))
    for res in _cluster(world):
        np.testing.assert_allclose(res["gn"]["T"], want, atol=1e-3)
        np.testing.assert_allclose(res["gn"]["T"], d["T_true"], atol=2e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_ba_matches_jax(world):
    d = _inputs(world)["ba"]
    mesh = _jmesh(world)
    win = jba.BAWindow(*(jnp.asarray(a) for a in d["window"]))
    want, want_errs = jdist_ba.distributed_ba_refine(
        mesh, jdist_ba.shard_window(win, mesh), jnp.asarray(d["K"]), iters=d["iters"])
    got = _cluster(world)
    landmarks = _rows([res["ba"]["window"].landmark for res in got])
    np.testing.assert_allclose(landmarks, np.asarray(want.landmark), rtol=1e-2, atol=5e-3)
    for res in got:
        np.testing.assert_allclose(res["ba"]["errs"], np.asarray(want_errs),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(res["ba"]["window"].kf_pose, np.asarray(want.kf_pose),
                                   rtol=1e-3, atol=2e-3)
    assert float(want_errs[-1]) < 0.7 * float(want_errs[0])  # GN did real work


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_pg_optimize_matches_jax(world):
    d = _inputs(world)["pg"]
    g = jpg.PoseGraph(*(jnp.asarray(a) for a in d["graph"]))
    want, want_errs = jdist_pg(jmake_mesh(n_data=1, n_model=world), g, iters=d["iters"],
                               damping=d["damping"])
    for res in _cluster(world):
        np.testing.assert_allclose(res["pg"]["node_pose"], np.asarray(want.node_pose),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(res["pg"]["errs"], np.asarray(want_errs),
                                   rtol=1e-4, atol=1e-7)
        assert res["pg"]["errs"][-1] < res["pg"]["errs"][0]


@pytest.mark.parametrize("world", WORLDS)
def test_seqpar_ba_matches_jax(world):
    d = _inputs(world)["seqpar"]
    mesh = jmake_mesh(n_data=1, n_model=world)
    win = jba.BAWindow(*(jnp.asarray(a) for a in d["window"]))
    want, want_errs = jseqpar(mesh, jshard_blocks(win, mesh), jnp.asarray(d["K"]),
                              iters=d["iters"])
    assert float(want_errs[-1]) < float(want_errs[0])
    for res in _cluster(world):
        got = res["seqpar"]["window"]
        np.testing.assert_allclose(res["seqpar"]["errs"], np.asarray(want_errs),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got.kf_pose, np.asarray(want.kf_pose), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got.landmark, np.asarray(want.landmark),
                                   rtol=2e-3, atol=2e-3)


def test_seqpar_shard_count_invariance():
    """The same composed window on 2 and on 4 ranks, and on one device
    (ba_refine): the same answer."""
    d = _inputs(2)["seqpar"]
    ref, _ = tba.ba_refine(tba.BAWindow(*(torch.from_numpy(a) for a in d["window"])),
                           torch.from_numpy(d["K"]), iters=d["iters"])
    two, four = _cluster(2)[0]["seqpar"]["window"], _cluster(4)[0]["seqpar"]["window"]
    np.testing.assert_allclose(two.kf_pose, four.kf_pose, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(two.kf_pose, ref.kf_pose.numpy(), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(four.kf_pose, ref.kf_pose.numpy(), rtol=5e-4, atol=5e-4)


# ---------------------------------------------------------------------------
# the copied numpy window, and the hook's default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(96, 4), (64, 12, None, 7), (50, 6, K_GN, 3, 0.0, 0.15, 0.2)])
def test_demo_window_equals_the_reference(args):
    want = jdist_ba.demo_window(*args)
    got = tdist_ba.demo_window(*args)
    for name, a, b in zip(want._fields, got, want):
        assert a.numpy().dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_ba_reduce_fn_none_is_the_single_device_solver():
    """reduce_fn=None and an identity reduce_fn give the same bits, with and
    without a lane axis; the error trace matches the JAX solver's."""
    win = tdist_ba.demo_window(40, 5, seed=3)
    K = torch.from_numpy(K_BA)
    a, ea = tba.ba_refine(win, K, iters=3)
    b, eb = tba.ba_refine(win, K, iters=3, reduce_fn=lambda x: x)
    assert torch.equal(ea, eb) and all(torch.equal(x, y) for x, y in zip(a, b))
    lanes = tba.BAWindow(*(torch.stack([f, f]) for f in win))
    c, ec = tba.ba_refine(lanes, K.expand(2, 3, 3), iters=3, reduce_fn=lambda x: x)
    assert torch.equal(ec[1], ea) and all(torch.equal(x[1], y) for x, y in zip(c, a))
    _, want = jba.ba_refine(jdist_ba.demo_window(40, 5, seed=3), jnp.asarray(K_BA), iters=3)
    np.testing.assert_allclose(ea.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the sharded rollout: a lane's result does not depend on the rank count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", ROLLOUT_CAPACITIES)
def test_sharded_rollout_lanes_equal_one_batch(capacity):
    """Lane b of 2 ranks x 2 lanes equals lane b of one batch of 4, bit for
    bit: no collective in the step, and no kernel chosen by the batch size."""
    d = _inputs(2)["rollout"][capacity]
    states, images, Ks, cfg = ranks.lane_inputs(d, capacity)
    final, want = tmulti.batched_vo_rollout(states, images, Ks, cfg)
    # Most steps localize; lane 2 loses its pose and runs the recovery.
    assert int(want.pose_ok.sum()) >= want.pose_ok.numel() // 2
    for res in _cluster(2):
        got = res[f"rollout_{capacity}"]
        for name, a, b in zip(want._fields, got["outs"], want):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    uid = _rows([res[f"rollout_{capacity}"]["uid"] for res in _cluster(2)])
    np.testing.assert_array_equal(uid, final.table.uid.numpy())
