"""Checkpoint / resume of the port: a bit-exact round trip and continued
stepping, the config's survival, the back-end's round trip, and files the
JAX package wrote loading in the port (the same v2 key paths)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vo_tpu.models import backend as jbackend
from vo_tpu.models import pipeline as jpipe
from vo_tpu.ops import ransac as jransac
from vo_tpu.utils import checkpoint as jckpt
from vo_tpu.utils.config import VOConfig as JaxConfig

from vo_tpu_torch.data import synthetic as tsyn
from vo_tpu_torch.models import pipeline as tpipe
from vo_tpu_torch.models.backend import BackendConfig, PoseGraphBackend
from vo_tpu_torch.utils import checkpoint as tckpt
from vo_tpu_torch.utils.config import RecoveryConfig, VOConfig

torch.set_num_threads(1)

SPEC = dataclasses.replace(tsyn.DEFAULT_SPEC, width=160, height=120, focal=104.0)
CAPACITY = 128


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def seq():
    return tsyn.render_sequence(SPEC, torch.device("cpu"), 10)


def _leaves(state):
    out = {f"table/{k}": v for k, v in state.table._asdict().items()}
    out.update({f"window/{k}": v for k, v in state.window._asdict().items()})
    out.update({f"pyramid/{i}": p for i, p in enumerate(state.pyramid)})
    out.update({k: getattr(state, k) for k in ("pose", "prev_pose", "frame_idx", "next_uid",
                                               "last_kf_idx", "kf_adaptive", "last_speed")})
    return out


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(N(la[k]), N(lb[k]), err_msg=k)


@pytest.mark.parametrize("tracker", ["klt", "harris"])
def test_checkpoint_roundtrip_and_resume(tmp_path, seq, tracker):
    """save -> load gives every leaf back bit for bit, the sampler's stream
    included: the next 3 steps of the restored state equal the
    uninterrupted run's, poses and table."""
    cfg = VOConfig(capacity=CAPACITY, tracker=tracker)
    state, _ = tpipe.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                               torch.Generator().manual_seed(0))
    state, _ = tpipe.vo_step(state, seq.frames[3], seq.K, cfg)
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(path, state, cfg, trajectory=[np.eye(4)], frame_ids=[0])
    state2, cfg2, traj, fids = tckpt.load_checkpoint(path, "cpu")
    assert cfg2 == cfg and traj.shape == (1, 4, 4) and fids.tolist() == [0]
    _assert_states_equal(state2, state)
    assert torch.equal(state2.rng.get_state(), state.rng.get_state())
    assert state2.rng is not state.rng

    s1, s2 = state, state2
    for i in (4, 5, 6):
        s1, o1 = tpipe.vo_step(s1, seq.frames[i], seq.K, cfg)
        s2, o2 = tpipe.vo_step(s2, seq.frames[i], seq.K, cfg2)
        np.testing.assert_array_equal(N(o1.pose), N(o2.pose))
    _assert_states_equal(s2, s1)


def test_checkpoint_preserves_tracker_mode(tmp_path, seq):
    cfg = VOConfig(capacity=CAPACITY, tracker="sift")
    state, _ = tpipe.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                               torch.Generator().manual_seed(0))
    path = str(tmp_path / "s.npz")
    tckpt.save_checkpoint(path, state, cfg)
    state2, cfg2, traj, fids = tckpt.load_checkpoint(path, "cpu")
    assert cfg2.tracker == "sift" and traj is None and fids is None
    assert state2.table.desc.shape == state.table.desc.shape == (CAPACITY, 128)
    assert len(state2.pyramid) == 1


def test_checkpoint_preserves_nondefault_dist_and_recovery(tmp_path, seq):
    """Every config field round-trips through the JSON sidecar, the lens
    model and the recovery tuning included, and stays hashable."""
    cfg = VOConfig(
        capacity=CAPACITY,
        dist=(-0.28, 0.08, 0.001, -0.002, 0.01),
        recovery=RecoveryConfig(enabled=False, min_inliers=17),
    )
    state, _ = tpipe.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                               torch.Generator().manual_seed(0))
    path = str(tmp_path / "d.npz")
    tckpt.save_checkpoint(path, state, cfg)
    _, cfg2, _, _ = tckpt.load_checkpoint(path, "cpu")
    assert cfg2.dist == cfg.dist and cfg2.recovery == cfg.recovery and cfg2 == cfg
    hash(cfg2)
    # The sidecar is the reference's: its own reader rebuilds the same tree.
    with open(path + ".json") as f:
        side = json.load(f)
    assert dataclasses.asdict(jckpt._cfg_from_dict(side)) == dataclasses.asdict(cfg)
    # A field an older file lacks keeps this version's default.
    del side["recovery"]
    assert tckpt._cfg_from_dict(side).recovery == RecoveryConfig()


def test_a_sampler_that_is_no_generator_cannot_be_saved(tmp_path, seq):
    cfg = VOConfig(capacity=CAPACITY)
    state, _ = tpipe.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                               torch.Generator().manual_seed(0))
    replaying = state._replace(rng=lambda h, n, s, valid: None)
    with pytest.raises(TypeError, match="torch.Generator"):
        tckpt.save_checkpoint(str(tmp_path / "x.npz"), replaying, cfg)
    lanes = state._replace(rng=[state.rng, state.rng])
    with pytest.raises(ValueError, match="lane by lane"):
        tckpt.save_checkpoint(str(tmp_path / "y.npz"), lanes, cfg)


def _rewrite(path, drop=(), rename=None):
    data = dict(np.load(path))
    for k in drop:
        del data[k]
    if rename is not None:
        data = rename(data)
    np.savez_compressed(path, **data)


def test_v2_file_without_new_fields_fails_by_name(tmp_path, seq):
    """A v2 file that predates `last_speed` and `miss` fails with a KeyError
    that names them (ported as the reference behaves)."""
    cfg = VOConfig(capacity=CAPACITY)
    state, _ = tpipe.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                               torch.Generator().manual_seed(0))
    path = str(tmp_path / "old.npz")
    tckpt.save_checkpoint(path, state, cfg)
    _rewrite(path, drop=("state/last_speed", "state/table/miss"))
    with pytest.raises(KeyError) as exc:
        tckpt.load_checkpoint(path, "cpu")
    assert "state/last_speed" in str(exc.value) and "state/table/miss" in str(exc.value)


def test_v1_positional_file_loads_when_the_count_matches(tmp_path, seq):
    cfg = VOConfig(capacity=CAPACITY)
    state, _ = tpipe.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                               torch.Generator().manual_seed(0))
    path = str(tmp_path / "v1.npz")
    tckpt.save_checkpoint(path, state, cfg)
    keys = tckpt._leaf_keys(len(state.pyramid))

    def positional(data):
        out = {f"leaf_{i}": data[k] for i, k in enumerate(keys)}
        out.update({k: data[k] for k in ("_pyramid_levels", "_rng_device")})
        return out

    _rewrite(path, rename=positional)
    state2, _, _, _ = tckpt.load_checkpoint(path, "cpu")
    _assert_states_equal(state2, state)
    _rewrite(path, drop=(f"leaf_{len(keys) - 1}",))
    with pytest.raises(KeyError, match="v1"):
        tckpt.load_checkpoint(path, "cpu")


# ---------------------------------------------------------------------------
# Files the JAX package wrote
# ---------------------------------------------------------------------------

def _replay(keys):
    keys = list(keys)

    def sampler(h, n, s, valid):
        v = None if valid is None else jnp.asarray(valid.numpy())
        return np.asarray(jransac.sample_indices(keys.pop(0), h, n, s, v))

    return sampler


def test_a_jax_checkpoint_loads_in_the_port(tmp_path, seq):
    """A checkpoint written by the JAX package's save_checkpoint loads here:
    the same key paths, every leaf but the sampler equal; without a sampler
    it says why it cannot continue; and one step from it, with the JAX
    step's draws replayed, matches the JAX step (pose 1e-4, lifecycle states
    and uids exact)."""
    frames = [jnp.asarray(N(f)) for f in seq.frames]
    K = jnp.asarray(N(seq.K))
    jcfg = JaxConfig(capacity=CAPACITY)
    jstate, _ = jpipe.bootstrap(frames[0], frames[2], K, jcfg, jax.random.PRNGKey(0))
    jstate, _ = jpipe.vo_step(jstate, frames[3], K, jcfg)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jstate, jcfg, trajectory=[np.eye(4)], frame_ids=[0])

    with pytest.raises(ValueError, match="jax.random key"):
        tckpt.load_checkpoint(path, "cpu")
    _, k_pnp, k_rec = jax.random.split(jstate.rng, 3)
    state, cfg, traj, fids = tckpt.load_checkpoint(path, "cpu", rng=_replay([k_pnp, k_rec]))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_states_equal(state, tpipe.state_from_numpy(jstate, "cpu", None))
    assert traj.shape == (1, 4, 4)
    # The port writes the keys the JAX package wrote (but the sampler's device).
    own = str(tmp_path / "own.npz")
    tckpt.save_checkpoint(own, state._replace(rng=torch.Generator()), cfg,
                          trajectory=[np.eye(4)], frame_ids=[0])
    assert set(np.load(own).files) - {"_rng_device"} == set(np.load(path).files)

    jnext, jout = jpipe.vo_step(jstate, frames[4], K, jcfg)
    nxt, out = tpipe.vo_step(state, seq.frames[4], seq.K, cfg)
    assert bool(out.pose_ok) == bool(jout.pose_ok)
    np.testing.assert_allclose(N(out.pose), np.asarray(jout.pose), atol=1e-4)
    np.testing.assert_array_equal(N(nxt.table.state), np.asarray(jnext.table.state))
    np.testing.assert_array_equal(N(nxt.table.uid), np.asarray(jnext.table.uid))
    assert int(nxt.last_kf_idx) == int(jnext.last_kf_idx)


def _fill_backend(be, seq, as_image, as_pose, table):
    for f in (0, 4, 8):
        be.on_keyframe(as_image(seq.frames[f]), as_pose(seq.gt_poses[f]), table, f)


def _port_backend(seq, state):
    be = PoseGraphBackend(seq.K, BackendConfig(nodes=8, loop_edges=4, obs_per_entry=32,
                                               grid=8, min_frame_gap=2))
    _fill_backend(be, seq, lambda f: f, lambda p: torch.from_numpy(p), state.table)
    return be


def test_backend_roundtrip(tmp_path, seq):
    """save_checkpoint(backend=...) -> load_backend is exact: every graph
    and DB array, the generator's state, K, the config and the loop
    telemetry survive, and the restored back-end goes on as the original."""
    cfg = VOConfig(capacity=CAPACITY)
    state, _ = tpipe.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                               torch.Generator().manual_seed(0))
    state = state._replace(table=state.table._replace(
        state=torch.full_like(state.table.state, 2)))  # every slot offers an observation
    be = _port_backend(seq, state)
    assert be.n_nodes == 3 and len(be.rejected) + be.n_loops >= 1  # the sampler was drawn from
    be.loops.append(dict(frame=8, node=2, matched_node=0, matched_frame=0,
                         similarity=0.97, inliers=25))
    be.n_culled = 1
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(path, state, cfg, backend=be)

    state2, cfg2, _, _ = tckpt.load_checkpoint(path, "cpu")
    assert cfg2 == cfg
    _assert_states_equal(state2, state)
    be2 = tckpt.load_backend(path, "cpu")
    assert be2.cfg == be.cfg and be2.loops == be.loops and be2.rejected == be.rejected
    assert be2.n_culled == 1 and be2.n_nodes == 3
    for a, b in zip(tuple(be.graph) + tuple(be.db) + (be.K,),
                    tuple(be2.graph) + tuple(be2.db) + (be2.K,)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(N(a), N(b))
    assert torch.equal(be2.key.get_state(), be.key.get_state())
    for b in (be, be2):
        b.on_keyframe(seq.frames[9], torch.from_numpy(seq.gt_poses[9]), state.table, 9)
    assert be2.rejected == be.rejected and be2.loops == be.loops
    np.testing.assert_array_equal(N(be2.graph.node_pose), N(be.graph.node_pose))


def test_checkpoint_without_backend_loads_none(tmp_path, seq):
    cfg = VOConfig(capacity=CAPACITY)
    state, _ = tpipe.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                               torch.Generator().manual_seed(0))
    path = str(tmp_path / "plain.npz")
    tckpt.save_checkpoint(path, state, cfg)
    assert tckpt.load_backend(path, "cpu") is None


def test_a_jax_backend_checkpoint_loads_in_the_port(tmp_path, seq):
    """The back-end the JAX package saved (graph, database, K, config, loop
    telemetry under the same keys) loads in the port, given a generator."""
    frames = [jnp.asarray(N(f)) for f in seq.frames]
    K = jnp.asarray(N(seq.K))
    jcfg = JaxConfig(capacity=CAPACITY)
    jstate, _ = jpipe.bootstrap(frames[0], frames[2], K, jcfg, jax.random.PRNGKey(0))
    jtable = jstate.table._replace(state=jnp.full_like(jstate.table.state, 2))
    jbe = jbackend.PoseGraphBackend(K, jbackend.BackendConfig(
        nodes=8, loop_edges=4, obs_per_entry=32, grid=8, min_frame_gap=2))
    _fill_backend(jbe, seq, lambda f: jnp.asarray(N(f)), lambda p: p, jtable)
    path = str(tmp_path / "jbe.npz")
    jckpt.save_checkpoint(path, jstate, jcfg, backend=jbe)

    with pytest.raises(ValueError, match="pass `key`"):
        tckpt.load_backend(path, "cpu")
    gen = torch.Generator().manual_seed(7)
    be = tckpt.load_backend(path, "cpu", key=gen)
    assert be.key is gen and be.n_nodes == jbe.n_nodes == 3
    assert dataclasses.asdict(be.cfg) == dataclasses.asdict(jbe.cfg)
    assert be.rejected == jbe.rejected and be.loops == jbe.loops
    for name in be.graph._fields:
        np.testing.assert_array_equal(N(getattr(be.graph, name)),
                                      np.asarray(getattr(jbe.graph, name)), err_msg=name)
    for name in be.db._fields:
        np.testing.assert_array_equal(N(getattr(be.db, name)),
                                      np.asarray(getattr(jbe.db, name)), err_msg=name)
    # The same database gives the port's own keyframe the JAX package's rows.
    state = tpipe.state_from_numpy(jstate._replace(table=jtable), "cpu", torch.Generator())
    own = _port_backend(seq, state)
    np.testing.assert_array_equal(N(own.db.frame), N(be.db.frame))
    np.testing.assert_allclose(N(own.db.gdesc), N(be.db.gdesc), atol=1e-5)
    np.testing.assert_array_equal(N(own.db.obs_xy), N(be.db.obs_xy))
