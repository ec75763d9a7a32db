"""The loop-closure back-end of the port against the JAX package: Sim(3),
the pose graph, the keyframe database and the host-facing back-end, on the
same numpy inputs. RANSAC draws are the JAX package's own, replayed through
the port's callable sampler."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vo_tpu.geom import lie as jlie
from vo_tpu.models import backend as jbackend
from vo_tpu.models import keyframe_db as jdb
from vo_tpu.models import pose_graph as jpg
from vo_tpu.ops import ransac as jransac

from vo_tpu_torch.geom import lie as tlie
from vo_tpu_torch.models import backend as tbackend
from vo_tpu_torch.models import keyframe_db as tdb
from vo_tpu_torch.models import pose_graph as tpg
from vo_tpu_torch.models.pipeline import _to_tensor

torch.set_num_threads(1)


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def T(x):
    return _to_tensor(x, "cpu")


def to_torch(tree, cls):
    """A JAX NamedTuple of arrays as the port's NamedTuple of tensors."""
    return cls(**{k: T(v) for k, v in tree._asdict().items()})


def assert_trees_equal(got, want, exact=True, atol=0.0):
    assert got._fields == want._fields
    for name in got._fields:
        g, w = N(getattr(got, name)), N(getattr(want, name))
        if exact or g.dtype.kind in "bi":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def _twists(seed):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 1.0, (40, 7)).astype(np.float32)
    xi[:, 3:6] *= 0.8
    xi[:, 6] *= 0.3
    xi[:8, 3:6] *= 1e-5  # the small-angle series
    xi[4:12, 6] *= 1e-5  # the small-lambda series
    xi[12] = 0.0
    return xi


@pytest.mark.parametrize("seed", [0, 1])
def test_sim3_exp_log_inverse(seed):
    """sim3_exp, sim3_log, sim3_inverse against the JAX package, 1e-5, and
    the round trip log(exp(xi)) = xi in the port alone, 1e-4."""
    xi = _twists(seed)
    S_j = np.asarray(jlie.sim3_exp(jnp.asarray(xi)))
    S_t = tlie.sim3_exp(T(xi))
    np.testing.assert_allclose(N(S_t), S_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(N(tlie.sim3_log(T(S_j))), np.asarray(jlie.sim3_log(jnp.asarray(S_j))),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(N(tlie.sim3_inverse(T(S_j))),
                               np.asarray(jlie.sim3_inverse(jnp.asarray(S_j))),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(N(tlie.sim3_log(S_t)), xi, atol=1e-4)
    eye = N(S_t @ tlie.sim3_inverse(S_t))
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(4), eye.shape), atol=1e-5)


def test_sim3_is_batched_over_leading_dims():
    xi = _twists(3).reshape(5, 8, 7)
    S = tlie.sim3_exp(T(xi))
    assert S.shape == (5, 8, 4, 4)
    np.testing.assert_array_equal(N(S[2]), N(tlie.sim3_exp(T(xi[2]))))
    np.testing.assert_array_equal(N(tlie.sim3_log(S)[3]), N(tlie.sim3_log(S[3])))
    M = np.random.default_rng(0).normal(size=(6, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(N(tlie.det3(T(M))), np.linalg.det(M), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Pose graph
# ---------------------------------------------------------------------------

def _gt_chain(n, step=1.0, yaw_per=0.05):
    """Ground-truth w_T_c chain driving forward with constant yaw rate (as
    tests/test_pose_graph.py)."""
    poses = [np.eye(4, dtype=np.float32)]
    c, s = np.cos(yaw_per), np.sin(yaw_per)
    d = np.eye(4, dtype=np.float32)
    d[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    d[:3, 3] = [0, 0, step]
    for _ in range(n - 1):
        poses.append(poses[-1] @ d)
    return np.stack(poses)


def _planted(kind):
    """The planted chains of tests/test_pose_graph.py as lists of node poses
    and loop edges (numpy), to be built by either package."""
    if kind == "drift":
        rng = np.random.default_rng(2023)
        n = 30
        gt = _gt_chain(n, yaw_per=2 * np.pi / n)
        noise = 0.01 * rng.standard_normal((n, 6)).astype(np.float32)
        cur, nodes = gt[0], [gt[0]]
        for k in range(1, n):
            rel = np.linalg.inv(gt[k - 1]) @ gt[k]
            rel = rel @ np.asarray(jlie.se3_exp(jnp.asarray(noise[k])))
            cur = (cur @ rel).astype(np.float32)
            nodes.append(cur)
        loops = [(0, n - 1, (np.linalg.inv(gt[0]) @ gt[n - 1]).astype(np.float32))]
        return nodes, loops, 8
    n = 40
    gt = _gt_chain(n, yaw_per=2 * np.pi / n)
    scale = np.linspace(1.4, 0.8, n).astype(np.float32)
    cur, nodes = gt[0], [gt[0]]
    for k in range(1, n):
        rel = (np.linalg.inv(gt[k - 1]) @ gt[k]).astype(np.float32)
        rel[:3, 3] *= scale[k]
        cur = (cur @ rel).astype(np.float32)
        nodes.append(cur)
    Z = (np.linalg.inv(gt[0]) @ gt[n - 1]).astype(np.float32)
    Z[:3, :3] *= 1.0 / scale[n - 1]
    return nodes, [(0, n - 1, Z)], 4


def _build(mod, asarray, nodes, loops, n_edges, spare=3):
    g = mod.empty_pose_graph(len(nodes) + spare, n_edges)
    for k, p in enumerate(nodes):
        g = mod.add_node(g, asarray(p), 3 * k)
    for i, j, rel in loops:
        g = mod.add_loop_edge(g, asarray(np.int32(i)), asarray(np.int32(j)), asarray(rel))
    return g


@pytest.mark.parametrize("kind", ["drift", "scale"])
def test_graph_building_is_exact(kind):
    """add_node / add_loop_edge field by field: integers and masks exact,
    the measured chain constraints to 1e-6 (one 4x4 product each)."""
    nodes, loops, n_edges = _planted(kind)
    gj = _build(jpg, jnp.asarray, nodes, loops, n_edges)
    gt_ = _build(tpg, T, nodes, loops, n_edges)
    assert_trees_equal(gt_, gj, exact=False, atol=1e-6)
    assert int(gt_.n_nodes) == len(nodes) and gt_.capacity == len(nodes) + 3
    np.testing.assert_allclose(N(tpg.node_se3(gt_)), np.asarray(jpg.node_se3(gj)), atol=1e-6)
    # A full edge store and a self-loop are masked no-ops.
    full = gt_
    for _ in range(n_edges + 1):
        full = tpg.add_loop_edge(full, 1, 5, torch.eye(4))
    assert int(full.loop_valid.sum()) == n_edges
    same = tpg.add_loop_edge(gt_, 4, 4, torch.eye(4))
    assert_trees_equal(same, gt_)


def test_add_node_when_full_is_a_no_op():
    g = tpg.empty_pose_graph(3, 2)
    gj = jpg.empty_pose_graph(3, 2)
    for k in range(5):
        pose = _gt_chain(6)[k]
        g = tpg.add_node(g, T(pose), k)
        gj = jpg.add_node(gj, jnp.asarray(pose), k)
    assert_trees_equal(g, gj, exact=False, atol=1e-6)
    assert int(g.n_nodes) == 3


@pytest.mark.parametrize("victim", [0, 1, 7, 28, 29, 33])
def test_cull_node_and_span_scores_are_exact(victim):
    """cull_node and chain_span_scores from the same graph: every field
    exact but the merged constraint (one 4x4 product, 1e-6); protected and
    invalid victims are no-ops in both."""
    nodes, loops, n_edges = _planted("drift")
    loops = loops + [(3, 20, np.eye(4, dtype=np.float32))]
    gj = _build(jpg, jnp.asarray, nodes, loops, n_edges)
    g = to_torch(gj, tpg.PoseGraph)
    sj, st = np.asarray(jpg.chain_span_scores(gj)), N(tpg.chain_span_scores(g))
    np.testing.assert_array_equal(np.isinf(st), np.isinf(sj))
    np.testing.assert_allclose(st[np.isfinite(sj)], sj[np.isfinite(sj)], rtol=1e-6)
    assert np.isinf(st[[0, 3, 20, 29]]).all() and int(np.argmin(st)) == int(np.argmin(sj))
    cj = jpg.cull_node(gj, jnp.int32(victim))
    ct = tpg.cull_node(g, victim)
    assert_trees_equal(ct, cj, exact=False, atol=1e-6)
    assert int(ct.n_nodes) == (29 if 0 < victim < 29 else 30)


@pytest.mark.parametrize("kind", ["drift", "scale"])
def test_edge_terms_and_normal_system(kind):
    """_edge_terms (residuals 1e-5, Jacobians 1e-4) and scatter_edge_terms
    (H, g 1e-3 relative to their scale: sums over shared nodes in another
    order) on a planted graph."""
    nodes, loops, n_edges = _planted(kind)
    gj = _build(jpg, jnp.asarray, nodes, loops, n_edges)
    g = to_torch(gj, tpg.PoseGraph)
    ej, et = jpg.build_edges(gj), tpg.build_edges(g)
    for a, b in zip(et, ej):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    a_idx, b_idx, z, w, valid = et
    poses_j = gj.node_pose.reshape(-1, 4, 4)
    poses_t = g.node_pose.reshape(-1, 4, 4)
    rj, Jaj, Jbj = jax.vmap(jpg._edge_terms)(poses_j[ej[0]], poses_j[ej[1]], ej[2])
    rt, Jat, Jbt = tpg._edge_terms(poses_t[a_idx], poses_t[b_idx], z)
    np.testing.assert_allclose(N(rt), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(N(Jat), np.asarray(Jaj), atol=1e-4)
    np.testing.assert_allclose(N(Jbt), np.asarray(Jbj), atol=1e-4)
    outs_j = jpg.scatter_edge_terms(poses_j, *ej, gj.capacity)
    outs_t = tpg.scatter_edge_terms(poses_t, *et, g.capacity)
    for got, want in zip(outs_t, outs_j):
        want = np.asarray(want)
        np.testing.assert_allclose(N(got), want, atol=1e-3 * max(1.0, np.abs(want).max()))
    delta_j = jpg.regularize_and_solve(*outs_j[:3], gj.capacity, jnp.int32(0), 1e-4,
                                       jnp.zeros(gj.capacity))
    delta_t = tpg.regularize_and_solve(*outs_t[:3], g.capacity, torch.tensor(0), 1e-4,
                                       torch.zeros(g.capacity))
    np.testing.assert_allclose(N(delta_t), np.asarray(delta_j), atol=2e-4)


@pytest.mark.parametrize("kind,scale", [("drift", True), ("scale", True), ("scale", False)])
def test_pg_optimize_on_planted_chains(kind, scale):
    """10 Gauss-Newton iterations from the same graph: node poses 1e-4
    (relative to the 13 m circuit), the residual trace 1e-4 relative."""
    nodes, loops, n_edges = _planted(kind)
    gj = _build(jpg, jnp.asarray, nodes, loops, n_edges)
    g = to_torch(gj, tpg.PoseGraph)
    oj, errs_j = jpg.pg_optimize(gj, iters=10, damping=1e-5, optimize_scale=scale)
    ot, errs_t = tpg.pg_optimize(g, iters=10, damping=1e-5, optimize_scale=scale)
    errs_j = np.asarray(errs_j)
    np.testing.assert_allclose(N(errs_t), errs_j, rtol=1e-4, atol=1e-4 * errs_j[0])
    assert float(errs_t[-1]) < float(errs_t[0])
    assert not np.array_equal(N(ot.node_pose), N(g.node_pose))  # the step was accepted
    np.testing.assert_allclose(N(ot.node_pose), np.asarray(oj.node_pose), atol=1e-4 * 13.0)
    # The gauge node did not move.
    np.testing.assert_allclose(N(ot.node_pose[0]), nodes[0].reshape(16), atol=1e-5)


def test_pg_optimize_rejects_a_non_spd_system():
    """A NaN constraint makes the Cholesky fail: no exception, the step is
    NaN and the graph comes back as it was (as in the JAX package)."""
    nodes, loops, n_edges = _planted("drift")
    g = _build(tpg, T, nodes, loops, n_edges)
    bad = g.rel_prev.clone()
    bad[5, 3] = float("nan")
    g = g._replace(rel_prev=bad)
    out, errs = tpg.pg_optimize(g, iters=3)
    np.testing.assert_array_equal(N(out.node_pose), N(g.node_pose))
    gj = _build(jpg, jnp.asarray, nodes, loops, n_edges)
    gj = gj._replace(rel_prev=jnp.asarray(N(bad)))
    oj, _ = jpg.pg_optimize(gj, iters=3)
    np.testing.assert_array_equal(np.asarray(oj.node_pose), np.asarray(gj.node_pose))


def test_correct_trajectory():
    """Per-frame re-anchoring, interpolated between keyframes: 1e-4."""
    nodes, loops, n_edges = _planted("scale")
    gj = _build(jpg, jnp.asarray, nodes, loops, n_edges)
    oj, _ = jpg.pg_optimize(gj, iters=10, damping=1e-5)
    n_frames = 3 * len(nodes) + 5
    rng = np.random.default_rng(5)
    traj = np.stack([nodes[min(f // 3, len(nodes) - 1)] for f in range(n_frames)])
    traj[:, :3, 3] += rng.normal(0, 0.05, (n_frames, 3)).astype(np.float32)
    fids = np.arange(n_frames, dtype=np.int32) - 2  # two frames before the first keyframe
    want = jpg.correct_trajectory(jnp.asarray(traj), jnp.asarray(fids), gj.node_frame,
                                  gj.node_pose, oj.node_pose, gj.node_valid)
    got = tpg.correct_trajectory(T(traj), T(fids), T(gj.node_frame), T(gj.node_pose),
                                 T(oj.node_pose), T(gj.node_valid))
    np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(N(got[:2]), traj[:2])  # before the first keyframe
    assert np.abs(N(got) - traj).max() > 0.1  # the correction is not the identity


# ---------------------------------------------------------------------------
# Keyframe database
# ---------------------------------------------------------------------------

K_CAM = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
H, W = 240, 320


def _textured_image(rng, h=H, w=W):
    """Smooth random texture so patches are discriminative."""
    img = rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32)
    return np.clip(np.asarray(jax.image.resize(jnp.asarray(img), (h, w), "cubic")), 0, 255)


def _pose(tx=0.0, tz=0.0, yaw=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    P[:3, 3] = [tx, 0.0, tz]
    return P


def _project(T_wc, pts):
    T_cw = np.linalg.inv(T_wc)
    pc = pts @ T_cw[:3, :3].T + T_cw[:3, 3]
    uv = pc[:, :2] / pc[:, 2:3]
    return (uv @ K_CAM[:2, :2].T + K_CAM[:2, 2]).astype(np.float32), pc[:, 2]


def _entry_inputs(rng, pose, npts=96):
    """Planted landmarks in front of `pose` and their projections."""
    pts = np.stack([rng.uniform(-6, 6, npts), rng.uniform(-3, 3, npts),
                    rng.uniform(8, 25, npts)], -1).astype(np.float32)
    pts_w = (pts @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
    uv, _ = _project(pose, pts_w)
    inside = (uv[:, 0] > 10) & (uv[:, 0] < W - 10) & (uv[:, 1] > 10) & (uv[:, 1] < H - 10)
    xy = np.where(inside[:, None], uv, np.array([W / 2, H / 2], np.float32)).astype(np.float32)
    score = rng.uniform(1, 2, npts).astype(np.float32)
    score[::7] = 1.5  # ties in the top-k
    return xy, pts_w, score, inside


def _entries(rng, img, pose, frame, m=64):
    xy, lm, score, inside = _entry_inputs(rng, pose)
    kw = dict(obs_per_entry=m, patch_radius=4)
    ej = jdb.make_entry(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(lm), jnp.asarray(score),
                        jnp.asarray(inside), jnp.asarray(pose), frame, **kw)
    et = tdb.make_entry(T(img), T(xy), T(lm), T(score), T(inside), T(pose), frame, **kw)
    return ej, et


@pytest.mark.parametrize("shape", [(240, 320), (480, 640), (100, 130), (16, 16), (12, 20)])
def test_global_descriptor(shape):
    """The anti-aliased thumbnail descriptor against jax.image.resize's, on a
    random image: 1e-5 (shrinking by whole and by fractional factors, the
    identity, and a size that is enlarged)."""
    rng = np.random.default_rng(shape[0])
    img = rng.uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jdb.global_descriptor(jnp.asarray(img)))
    got = N(tdb.global_descriptor(T(img)))
    assert got.shape == (256,)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(float(got @ got) - 1.0) < 1e-5
    got2 = N(tdb.global_descriptor(T(0.6 * img + 30.0)))
    assert float(got @ got2) > 0.9999  # brightness/contrast invariance


def test_make_add_cull_query():
    """make_entry, add_entry, cull_entry and query_loop(_topk): the same
    rows, indices and masks, values 1e-5."""
    rng_j, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    imgs = [_textured_image(rng_j) for _ in range(5)]
    [_textured_image(rng_t) for _ in range(5)]  # keep both streams in step
    dbj, dbt = jdb.empty_db(8, obs_per_entry=64), tdb.empty_db(8, obs_per_entry=64)
    for i, im in enumerate(imgs):
        ej, _ = _entries(rng_j, im, _pose(tz=3.0 * i), i * 10)
        _, et = _entries(rng_t, im, _pose(tz=3.0 * i), i * 10)
        assert_trees_equal(et, ej, exact=False, atol=1e-5)
        np.testing.assert_array_equal(N(et.obs_xy), np.asarray(ej.obs_xy))  # the same slots
        dbj, dbt = jdb.add_entry(dbj, ej), tdb.add_entry(dbt, et)
    assert_trees_equal(dbt, dbj, exact=False, atol=1e-5)
    assert int(dbt.n_entries) == 5 and dbt.capacity == 8

    rj, _ = _entries(rng_j, imgs[1], _pose(tz=3.0), 500)
    _, rt = _entries(rng_t, imgs[1], _pose(tz=3.0), 500)
    cj, ct = jdb.query_loop(dbj, rj, min_frame_gap=100), tdb.query_loop(dbt, rt, min_frame_gap=100)
    assert int(ct.idx) == int(cj.idx) == 1 and bool(ct.found) and bool(cj.found)
    assert abs(float(ct.similarity) - float(cj.similarity)) < 1e-5
    assert not bool(tdb.query_loop(dbt, rt, min_frame_gap=10_000).found)
    # Top-k over 5 valid and 3 empty rows: ties at -inf go to the lower row.
    kj = jdb.query_loop_topk(dbj, rj, k=7, min_frame_gap=100)
    kt = tdb.query_loop_topk(dbt, rt, k=7, min_frame_gap=100)
    np.testing.assert_array_equal(N(kt.idx), np.asarray(kj.idx))
    np.testing.assert_array_equal(N(kt.found), np.asarray(kj.found))
    np.testing.assert_allclose(N(kt.similarity)[:5], np.asarray(kj.similarity)[:5], atol=1e-5)
    assert np.isinf(N(kt.similarity)[5:]).all()

    for victim in (2, 0, 6):
        cj_, ct_ = jdb.cull_entry(dbj, jnp.int32(victim)), tdb.cull_entry(dbt, victim)
        assert_trees_equal(ct_, cj_, exact=False, atol=1e-5)
    assert N(tdb.cull_entry(dbt, 2).frame)[:4].tolist() == [0, 10, 30, 40]
    # A full database turns an append away.
    full = dbt
    for _ in range(5):
        full = tdb.add_entry(full, rt)
    assert int(full.n_entries) == 8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_umeyama_sim(seed):
    """Weighted Umeyama against the JAX package: 1e-4, a reflection case,
    the degenerate case (identity), and a batch of two equal to its lanes."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 3, (50, 3)).astype(np.float32)
    S = np.asarray(jlie.sim3_exp(jnp.asarray(rng.normal(0, 0.4, 7).astype(np.float32))))
    Y = (X @ S[:3, :3].T + S[:3, 3] + rng.normal(0, 0.01, X.shape)).astype(np.float32)
    w = (rng.uniform(size=50) > 0.3).astype(np.float32)
    want = np.asarray(jdb._umeyama_sim(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(w)))
    got = N(tdb._umeyama_sim(T(X), T(Y), T(w)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, S, atol=2e-2)
    Ym = Y * np.array([1, 1, -1], np.float32)  # a mirrored target: det(U Vt) < 0
    np.testing.assert_allclose(N(tdb._umeyama_sim(T(X), T(Ym), T(w))),
                               np.asarray(jdb._umeyama_sim(jnp.asarray(X), jnp.asarray(Ym),
                                                           jnp.asarray(w))), atol=1e-4)
    few = np.zeros(50, np.float32)
    few[:2] = 1.0
    np.testing.assert_array_equal(N(tdb._umeyama_sim(T(X), T(Y), T(few))), np.eye(4))
    both = tdb._umeyama_sim(T(np.stack([X, X])), T(np.stack([Y, Ym])), T(np.stack([w, w])))
    np.testing.assert_allclose(N(both[0]), got, atol=1e-6)


def _two_visits(seed=11):
    """The planted revisit of tests/test_keyframe_db.py: an old entry, and a
    new keyframe that sees the same landmarks from a slightly moved pose."""
    rng = np.random.default_rng(seed)
    img = _textured_image(rng)
    old_pose, new_pose = _pose(), _pose(tx=0.4, tz=1.0, yaw=0.05)
    old_j, old_t = _entries(rng, img, old_pose, 0)
    lm = np.asarray(old_j.obs_lm)
    uv, z = _project(new_pose, lm)
    inside = ((uv[:, 0] > 10) & (uv[:, 0] < W - 10) & (uv[:, 1] > 10) & (uv[:, 1] < H - 10)
              & np.asarray(old_j.obs_valid) & (z > 0))
    desc = np.where(inside[:, None], np.asarray(old_j.obs_desc), 0.0).astype(np.float32)
    fields = dict(pose=new_pose.reshape(16), frame=np.int32(300),
                  gdesc=np.asarray(old_j.gdesc), obs_xy=uv, obs_lm=lm, obs_desc=desc,
                  obs_valid=inside)
    new_j = jdb.KeyframeEntry(**{k: jnp.asarray(v) for k, v in fields.items()})
    new_t = tdb.KeyframeEntry(**{k: T(v) for k, v in fields.items()})
    return (old_j, old_t), (new_j, new_t), old_pose, new_pose


def _replay(keys):
    keys = list(keys)

    def sampler(h, n, s, valid):
        v = None if valid is None else jnp.asarray(valid.numpy())
        return np.asarray(jransac.sample_indices(keys.pop(0), h, n, s, v))

    return sampler


def test_verify_loop_with_replayed_draws():
    """verify_loop with the JAX package's own RANSAC draws: the same verdict
    and inlier count, the Sim(3) edge to 1e-3, and the planted pose."""
    (old_j, old_t), (new_j, new_t), old_pose, new_pose = _two_visits()
    dbj = jdb.add_entry(jdb.empty_db(4, obs_per_entry=64), old_j)
    dbt = tdb.add_entry(tdb.empty_db(4, obs_per_entry=64), old_t)
    key = jax.random.PRNGKey(0)
    want = jdb.verify_loop(key, dbj, jnp.int32(0), new_j, jnp.asarray(K_CAM), min_inliers=15)
    got = tdb.verify_loop(_replay([key]), dbt, 0, new_t, T(K_CAM), min_inliers=15)
    assert bool(got.ok) and bool(want.ok)
    assert int(got.num_inliers) == int(want.num_inliers)
    np.testing.assert_allclose(N(got.rel), np.asarray(want.rel), atol=1e-3)
    np.testing.assert_allclose(N(got.rel), np.linalg.inv(old_pose) @ new_pose, atol=5e-2)
    # An unrelated scene does not verify.
    rng = np.random.default_rng(13)
    _, other = _entries(rng, _textured_image(rng), _pose(tz=50.0), 400)
    assert not bool(tdb.verify_loop(torch.Generator().manual_seed(0), dbt, 0, other,
                                    T(K_CAM)).ok)


def test_verify_loop_candidates_are_lanes():
    """Several candidates in one pass, one sampler each: candidate c equals
    its own single verification with the same draws."""
    (old_j, old_t), (_, new_t), _, _ = _two_visits()
    rng = np.random.default_rng(3)
    _, other = _entries(rng, _textured_image(rng), _pose(tz=9.0), 40)
    dbt = tdb.empty_db(4, obs_per_entry=64)
    for e in (other, old_t, other):
        dbt = tdb.add_entry(dbt, e)
    keys = [jax.random.PRNGKey(i) for i in range(3)]
    batch = tdb.verify_loop([_replay([k]) for k in keys], dbt, torch.tensor([0, 1, 2]), new_t,
                            T(K_CAM), min_inliers=15)
    assert N(batch.ok).tolist() == [False, True, False]
    assert batch.rel.shape == (3, 4, 4)
    for c in range(3):
        one = tdb.verify_loop(_replay([keys[c]]), dbt, c, new_t, T(K_CAM), min_inliers=15)
        assert bool(one.ok) == bool(batch.ok[c])
        assert int(one.num_inliers) == int(batch.num_inliers[c])
        np.testing.assert_allclose(N(one.rel), N(batch.rel[c]), atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_depth_weights(seed):
    """The loop edge's pair weights: zero off the inliers, proportional to
    1 / (z_old^4 + z_new^4) on them, summing to the inliers' count, lanes
    alike; exact pairs give the planted edge, as under equal weights."""
    rng = np.random.default_rng(seed)
    S = np.asarray(jlie.sim3_exp(jnp.asarray(rng.normal(0, 0.4, 7).astype(np.float32))))
    cam = np.stack([rng.uniform(-8, 8, 50), rng.uniform(-3, 3, 50), rng.uniform(4, 40, 50)], -1)
    X = cam.astype(np.float32)
    Y = (cam @ S[:3, :3].T + S[:3, 3]).astype(np.float32)
    w = (rng.uniform(size=50) > 0.3).astype(np.float32)
    got = N(tdb._depth_weights(T(Y), T(X), T(w)))
    want = w / (Y[:, 2].astype(np.float64) ** 4 + X[:, 2].astype(np.float64) ** 4)
    np.testing.assert_allclose(got, want * w.sum() / want.sum(), rtol=1e-5)
    assert got.sum() == pytest.approx(w.sum(), rel=1e-5) and (got[w == 0] == 0).all()
    both = N(tdb._depth_weights(T(np.stack([Y, Y])), T(np.stack([X, X])), T(np.stack([w, w]))))
    np.testing.assert_allclose(both[1], got, rtol=1e-6)
    edge = N(tdb._umeyama_sim(T(X), T(Y), T(got)))
    np.testing.assert_allclose(edge, S, atol=2e-4)
    np.testing.assert_allclose(edge, N(tdb._umeyama_sim(T(X), T(Y), T(w))), atol=2e-4)


def test_depth_weighted_edge_beats_equal_weights():
    """Pairs whose depths err as depth squared, along each camera's ray (as
    triangulated landmarks do): the depth-weighed edge's translation is
    nearer the planted one than the JAX package's equal-weight edge, on
    every one of 20 seeded draws and by 5x on their mean."""
    rng = np.random.default_rng(0)
    errs = []
    for _ in range(20):
        S = np.asarray(jlie.sim3_exp(jnp.asarray(np.r_[
            rng.normal(0, 0.5, 3), rng.normal(0, 0.05, 3), rng.normal(0, 0.2)].astype(np.float32))))
        cam = np.stack([rng.uniform(-8, 8, 40), rng.uniform(-3, 3, 40), rng.uniform(4, 40, 40)], -1)
        X, Y = cam.copy(), cam @ S[:3, :3].T + S[:3, 3]
        for P in (X, Y):
            P *= 1 + rng.normal(0, 0.004, (40, 1)) * P[:, 2:3]
        X, Y, w = X.astype(np.float32), Y.astype(np.float32), np.ones(40, np.float32)
        equal = np.asarray(jdb._umeyama_sim(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(w)))
        weighed = N(tdb._umeyama_sim(T(X), T(Y), tdb._depth_weights(T(Y), T(X), T(w))))
        errs.append([np.linalg.norm(e[:3, 3] - S[:3, 3]) for e in (equal, weighed)])
    errs = np.asarray(errs)
    assert (errs[:, 1] < errs[:, 0]).all()
    assert errs[:, 1].mean() * 5 < errs[:, 0].mean()


@pytest.mark.parametrize("yaw_deg, ok", [(0.0, True), (20.0, True), (45.0, False),
                                         (180.0, False)])
def test_verify_loop_checks_the_odometry(yaw_deg, ok, monkeypatch):
    """The planted revisit with the new keyframe's odometry turned about
    the vertical by `yaw_deg`: P3P finds the same pose and inliers on the
    JAX package's draws, and the candidate verifies only while the
    odometry's orientation stays within 30 degrees of P3P's."""
    (_, old_t), (new_j, new_t), _, new_pose = _two_visits()
    c, s = np.cos(np.radians(yaw_deg)), np.sin(np.radians(yaw_deg))
    turn = np.eye(4, dtype=np.float32)
    turn[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    turned = new_t._replace(pose=T((new_pose @ turn).reshape(16)))
    dbt = tdb.add_entry(tdb.empty_db(4, obs_per_entry=64), old_t)
    key = jax.random.PRNGKey(0)
    base = tdb.verify_loop(_replay([key]), dbt, 0, new_t, T(K_CAM), min_inliers=15)
    got = tdb.verify_loop(_replay([key]), dbt, 0, turned, T(K_CAM), min_inliers=15)
    assert bool(base.ok)
    assert bool(got.ok) == ok
    assert int(got.num_inliers) == int(base.num_inliers)
    if yaw_deg < 180.0:  # a wider limit lets the same turn through
        monkeypatch.setattr(tdb, "MAX_ODOMETRY_DEG", yaw_deg + 1.0)
        loose = tdb.verify_loop(_replay([key]), dbt, 0, turned, T(K_CAM), min_inliers=15)
        assert bool(loose.ok)


# ---------------------------------------------------------------------------
# The host-facing back-end
# ---------------------------------------------------------------------------

def test_backend_config_defaults():
    import dataclasses

    assert dataclasses.asdict(tbackend.BackendConfig()) == dataclasses.asdict(
        jbackend.BackendConfig())


def _plane_world(seed=5, shift_px=10):
    """A fronto-parallel plane of landmarks 20 m ahead, seen from two poses a
    sideways step apart: every projection moves by `shift_px` whole pixels,
    so the second view is the first image rolled, and patches re-extracted
    at the new projections match the stored ones."""
    rng = np.random.default_rng(seed)
    img0 = _textured_image(rng)
    z = 20.0
    tx = shift_px * z / K_CAM[0, 0]
    n = 128
    lm = np.stack([rng.uniform(-5, 5, n), rng.uniform(-4, 4, n), np.full(n, z)],
                  -1).astype(np.float32)
    views = []
    for pose, img in ((_pose(), img0), (_pose(tx=tx), np.roll(img0, -shift_px, axis=1))):
        uv, _ = _project(pose, lm)
        ok = (uv[:, 0] > 30) & (uv[:, 0] < W - 30) & (uv[:, 1] > 30) & (uv[:, 1] < H - 30)
        views.append((img, pose, np.round(uv), ok))
    score = rng.uniform(1, 2, n).astype(np.float32)
    return lm, score, views


def test_on_keyframe_accepts_the_same_loop():
    """PoseGraphBackend.on_keyframe over a two-visit scene, each package on
    its own RANSAC draws: both register two nodes, accept the one loop
    between them with the planted relative pose, and optimize."""
    lm, score, views = _plane_world()
    kw = dict(nodes=8, loop_edges=4, obs_per_entry=64, patch_radius=4, min_frame_gap=100,
              min_similarity=0.3, min_inliers=15)
    bj = jbackend.PoseGraphBackend(jnp.asarray(K_CAM), jbackend.BackendConfig(**kw))
    bt = tbackend.PoseGraphBackend(T(K_CAM), tbackend.BackendConfig(**kw))
    infos = []
    for frame, (img, pose, uv, ok) in zip((0, 300), views):
        state = np.where(ok, 2, 0).astype(np.int32)
        tj = types.SimpleNamespace(xy=jnp.asarray(uv), landmark=jnp.asarray(lm),
                                   score=jnp.asarray(score), state=jnp.asarray(state))
        tt = types.SimpleNamespace(xy=T(uv), landmark=T(lm), score=T(score), state=T(state))
        infos.append((bj.on_keyframe(img, pose, tj, frame), bt.on_keyframe(T(img), pose, tt, frame)))
    assert infos[0] == (None, None)
    ij, it = infos[1]
    assert ij is not None and it is not None
    for key in ("frame", "node", "matched_node", "matched_frame"):
        assert it[key] == ij[key], key
    assert abs(it["similarity"] - ij["similarity"]) < 1e-4
    assert it["inliers"] >= 15 and abs(it["inliers"] - ij["inliers"]) <= 3
    assert bt.n_nodes == bj.n_nodes == 2 and bt.n_loops == bj.n_loops == 1
    assert bt.rejected == [] and bt.n_culled == 0
    rel = np.linalg.inv(views[0][1]) @ views[1][1]
    np.testing.assert_allclose(N(bt.graph.loop_rel[0]).reshape(4, 4), rel, atol=5e-2)
    np.testing.assert_array_equal(N(bt.graph.loop_ij[0]), [0, 1])
    bt.optimize()
    traj = np.stack([v[1] for v in views])
    out = bt.correct(traj, np.array([0, 300]))
    assert out.shape == (2, 4, 4) and np.isfinite(out).all()
    np.testing.assert_allclose(out, traj, atol=5e-2)


def test_on_keyframe_rejects_a_revisit_the_odometry_turned():
    """The two-visit scene with the second keyframe's odometry heading the
    other way: the back-end registers both nodes, adds no loop edge, and
    logs the candidate as rejected with its inliers."""
    lm, score, views = _plane_world()
    kw = dict(nodes=8, loop_edges=4, obs_per_entry=64, patch_radius=4, min_frame_gap=100,
              min_similarity=0.3, min_inliers=15)
    bt = tbackend.PoseGraphBackend(T(K_CAM), tbackend.BackendConfig(**kw))
    infos = []
    for frame, (img, pose, uv, ok) in zip((0, 300), views):
        if frame:
            pose = pose @ _pose(yaw=np.pi)
        state = np.where(ok, 2, 0).astype(np.int32)
        tt = types.SimpleNamespace(xy=T(uv), landmark=T(lm), score=T(score), state=T(state))
        infos.append(bt.on_keyframe(T(img), pose, tt, frame))
    assert infos == [None, None]
    assert bt.n_nodes == 2 and bt.n_loops == 0 and not bool(N(bt.graph.loop_valid).any())
    assert [(r["frame"], r["matched_frame"]) for r in bt.rejected] == [(300, 0)]
    assert bt.rejected[0]["inliers"] >= 15


def test_backend_culls_when_full():
    """At capacity the node with the least chain span goes, from graph and
    database alike, and the newest keyframe takes the freed row."""
    lm, score, views = _plane_world()
    img, _, uv, ok = views[0]
    bt = tbackend.PoseGraphBackend(T(K_CAM), tbackend.BackendConfig(
        nodes=4, loop_edges=2, obs_per_entry=64, patch_radius=4, min_frame_gap=1000))
    tt = types.SimpleNamespace(xy=T(uv), landmark=T(lm), score=T(score),
                               state=T(np.where(ok, 2, 0).astype(np.int32)))
    steps = [0.0, 1.0, 1.1, 2.0, 3.0, 4.0]  # node 2 sits closest to its neighbours
    for k, tz in enumerate(steps):
        bt.on_keyframe(T(img), _pose(tz=tz), tt, 10 * k)
    assert bt.n_nodes == 4 and bt.n_culled == 2
    assert N(bt.graph.node_frame).tolist() == N(bt.db.frame).tolist()
    assert N(bt.graph.node_frame).tolist()[0] == 0 and 20 not in N(bt.graph.node_frame).tolist()
    assert N(bt.graph.node_frame).tolist()[-1] == 50
