"""The captured rollout (vo_tpu_torch/models/graphed.py) on the CPU, through
its stand-in for CUDA graph capture (`graphed.StandIn`: "capture" runs a
segment once, "replay" runs it again on the same static buffers), at 160x120
(focal 104), capacity 128, 12 steps of the city:

  * the runner equals the eager `vo_rollout` bit for bit, one lane and
    three lanes with one of them lost, over recovery and BA frames, and with
    a lane lost on some frames of the chunk and not on others; the frames
    on which R ran, counted on the device, are the eager step's;
  * a captured rollout makes no host read (the eager branch is never
    called, no sync is counted); the warm-up runs R and C and gives their
    results slots;
  * the caller's state is not written; a chunk's outputs are not static
    buffers (the next chunk leaves them as they were);
  * a second rollout under the same key captures nothing; launch counts
    accumulate per replay exactly as the eager path counts them;
  * the two pieces that make the step capturable: `inverse` (inv_ex) equals
    torch.linalg.inv bit for bit, and the uniforms drawn ahead (`Drawn`)
    give the generator's indices and leave it where the eager draw does;
  * from a JAX state, the runner's frames against the JAX package's jitted
    `vo_rollout` on replayed draws;
  * the one step schedule (`pipeline.run_step`) over both device
    predicates; the check of counted launches against a graph's kernel
    nodes; the executor a rollout reports, from what ran; a runner kept per
    frame dtype.

The CUDA graphs themselves against the eager rollout are tested on the card
in tests/test_torch_cuda.py (which imports no jax, so it runs there).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vo_tpu.models import pipeline as jpipe
from vo_tpu.utils.config import VOConfig as JaxConfig

from test_torch_pipeline import CAPACITY as DOT_CAPACITY
from test_torch_pipeline import K_DOTS, _replay, dot_world  # noqa: F401  (fixture)
from vo_tpu_torch.data import synthetic as tsyn
from vo_tpu_torch.geom.points import inverse
from vo_tpu_torch.models import graphed
from vo_tpu_torch.models import pipeline as tpipe
from vo_tpu_torch.ops import kernels
from vo_tpu_torch.ops import klt as tklt
from vo_tpu_torch.ops.ransac import Drawn, draw_uniforms, sample_indices
from vo_tpu_torch.parallel import multiseq as tmulti
from vo_tpu_torch.utils.cache import RunnerCache, runner_key
from vo_tpu_torch.utils.config import BAConfig, VOConfig

# Several pytest-xdist workers share the cores (see test_torch_frontend.py).
torch.set_num_threads(1)

SMALL = dict(width=160, height=120, focal=104.0)
CAPACITY = 128
FRAMES = 15  # bootstrap on frames 0 and 2, then 12 steps
CFG = VOConfig(capacity=CAPACITY)


@pytest.fixture(scope="module")
def city():
    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, **SMALL)
    seq = tsyn.render_sequence(spec, "cpu", FRAMES)
    return seq.frames, seq.K


def _boot(frames, K, seed, cfg=CFG):
    state, _ = tpipe.bootstrap(frames[0], frames[2], K, cfg,
                               torch.Generator().manual_seed(seed))
    return state


def _gens(state):
    return tpipe.generators(state)


def _captured(state, images, K, cfg=CFG, cache=None):
    """The runner's rollout (a cache of its own unless one is given) and the
    runner."""
    cache = RunnerCache() if cache is None else cache
    out = graphed.graphed_rollout(state, images, K, cfg, cache=cache,
                                  capture=graphed.StandIn())
    return out, graphed.runner_for(state, images, K, cfg, cache)


def _lanes(frames, K, noise=slice(3, None)):
    """Three lanes: two of the city with their own seeds, and one that sees
    noise on the frames `noise` after its bootstrap, so that its PnP fails
    and R runs there."""
    lost = frames.clone()
    lost[noise] = torch.from_numpy(
        np.random.default_rng(99).uniform(0, 255, lost[noise].shape).astype(np.float32))
    states = [_boot(frames, K, 2023), _boot(frames, K, 2024), _boot(lost, K, 2025)]
    images = torch.stack([frames[3:], frames[3:], lost[3:]], dim=1)
    return tmulti.stack_states(states), images, K.expand(3, 3, 3).contiguous()


@pytest.mark.parametrize("lanes", [1, 3])
def test_runner_equals_the_eager_rollout(city, lanes):
    """Every StepOutput field, every leaf of the final state and every
    lane's generator, bit for bit, over frames where R runs and C replays."""
    frames, K = city
    if lanes == 1:
        state, images, Ks = _boot(frames, K, 2023), frames[3:], K
        eager_roll = tpipe.vo_rollout
    else:
        state, images, Ks = _lanes(frames, K)
        eager_roll = tmulti.batched_vo_rollout
    saved = [g.get_state() for g in _gens(state)]
    final_e, eager = eager_roll(state, images, Ks, CFG)
    after = [g.get_state() for g in _gens(state)]
    for g, s in zip(_gens(state), saved):
        g.set_state(s)
    (final_g, got), runner = _captured(state, images, Ks)
    for name, a, b in zip(eager._fields, eager, got):
        assert torch.equal(a, b), name
    assert len(graphed._leaves(final_e)) == len(graphed._leaves(final_g)) > 20
    for a, b in zip(graphed._leaves(final_e), graphed._leaves(final_g)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, g.get_state()) for a, g in zip(after, _gens(state)))
    assert final_g.rng is state.rng and final_g.rec_rng is state.rec_rng
    # The run covered both branches.
    assert runner.stats.recoveries >= 1 and runner.stats.keyframes >= 1
    assert runner.stats.frames == images.shape[0] and runner.stats.syncs == 0
    assert set(runner.branches) == {"R", "C"}
    if lanes == 3:  # the noise lane lost every frame; the city lanes did not
        assert not bool(got.pose_ok[:, 2].any()) and bool(got.pose_ok[:, :2].any(dim=0).all())


def test_the_callers_state_is_not_written(city):
    frames, K = city
    state = _boot(frames, K, 2023)
    before = [t.clone() for t in graphed._leaves(state)]
    (final, _), runner = _captured(state, frames[3:], K)
    assert all(torch.equal(a, b) for a, b in zip(before, graphed._leaves(state)))
    # Nothing handed back is a static buffer of the runner.
    static = {graphed._storage(t) for t in graphed._leaves(runner.state)}
    assert not static & {graphed._storage(t) for t in graphed._leaves(final)}


def test_chunk_outputs_survive_the_next_chunk(city):
    """Two chunks through one runner: the first chunk's outputs and final
    state are as they were after the second, and the two chunks together
    are the eager rollout of all frames."""
    frames, K = city
    state = _boot(frames, K, 2023)
    rewind = tpipe.rewinder(state)
    _, whole = tpipe.vo_rollout(state, frames[3:], K, CFG)
    rewind()
    cache = RunnerCache()
    (mid, first), _ = _captured(state, frames[3:9], K, cache=cache)
    kept = [t.clone() for t in first] + [t.clone() for t in graphed._leaves(mid)]
    (_, second), _ = _captured(mid, frames[9:], K, cache=cache)
    now = list(first) + graphed._leaves(mid)
    assert all(torch.equal(a, b) for a, b in zip(kept, now))
    for a, b, w in zip(first, second, whole):
        assert torch.equal(torch.cat([a, b]), w)


def test_a_second_rollout_under_the_same_key_captures_nothing(city):
    frames, K = city
    cache = RunnerCache()
    for seed in (2023, 2024):
        _captured(_boot(frames, K, seed), frames[3:6], K, cache=cache)
    assert cache.captures == 1 and len(cache) == 1
    # Another configuration is another key; without BA there is no C.
    cfg = VOConfig(capacity=CAPACITY, ba=BAConfig(enabled=False))
    _, runner = _captured(_boot(frames, K, 2023, cfg), frames[3:6], K, cfg, cache)
    assert cache.captures == 2 and len(cache) == 2
    assert set(runner.branches) == {"R"} and runner.stats.keyframes == 0


def test_launch_counts_accumulate_per_replay(city, monkeypatch):
    """The wrappers count when Python calls them, which for a graph is at
    capture. With the wrappers counting as on the card, the captured
    rollout counts what the eager one does: 1 corner kernel, 4 gather
    launches and 4 LK solve launches a step, nothing for the warm-up or the
    capture."""
    frames, K = city
    real_pairs, real_k1 = tklt.extract_patch_pairs, kernels.corner_response_nms
    real_solve = tklt.lk_solve

    def pairs(prev, *a, **kw):
        kernels.launch_counts["extract_patches"] += 1
        return real_pairs(prev, *a, **kw)

    def solve(*a, **kw):
        kernels.launch_counts["lk_solve"] += 1
        return real_solve(*a, **kw)

    def k1(img, *a, **kw):
        kernels.launch_counts["corner_response_nms"] += 1
        return real_k1(img, *a, **kw)

    monkeypatch.setattr(tklt, "extract_patch_pairs", pairs)
    monkeypatch.setattr(tklt, "lk_solve", solve)
    monkeypatch.setattr(kernels, "corner_response_nms", k1)
    steps = 6
    counts = []
    cache = RunnerCache()
    for run in ("eager", "graphs (capture)", "graphs (cached)"):
        state = _boot(frames, K, 2023)
        kernels.reset_launch_counts()
        if run == "eager":
            tpipe.vo_rollout(state, frames[3:3 + steps], K, CFG)
        else:
            _captured(state, frames[3:3 + steps], K, cache=cache)
        counts.append(dict(kernels.launch_counts))
    want = {"corner_response_nms": steps, "extract_patches": 4 * steps,
            "corner_response_nms_batched": 0, "extract_patches_batched": 0,
            "lk_solve": 4 * steps, "lk_solve_batched": 0}
    assert counts == [want] * 3
    _, runner = _captured(_boot(frames, K, 2023), frames[3:4], K, cache=cache)
    assert runner.launches == {"extract_patches": 4, "corner_response_nms": 1, "lk_solve": 4}


@pytest.mark.parametrize("shape", [(3, 3), (1, 3, 3), (6, 3, 3), (5, 4, 4)])
def test_inverse_is_inv_bit_for_bit(shape):
    rng = np.random.default_rng(7)
    M = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    M = M + 3.0 * torch.eye(shape[-1])
    assert torch.equal(inverse(M), torch.linalg.inv(M))


@pytest.mark.parametrize("valid", [None, "mask"])
def test_drawn_uniforms_give_the_generators_indices(valid):
    """`Drawn` over uniforms drawn ahead by `draw_uniforms` gives the indices
    `sample_indices` draws from the generator, and leaves the generator
    where that draw leaves it; lane by lane as well."""
    h, n, s = 256, 128, 4
    mask = None if valid is None else torch.from_numpy(
        np.random.default_rng(3).uniform(size=(2, n)) < 0.6)
    eager = [torch.Generator().manual_seed(11 + b) for b in range(2)]
    ahead = [torch.Generator().manual_seed(11 + b) for b in range(2)]
    want = sample_indices(eager, h, n, s, mask)
    drawn = [Drawn(draw_uniforms(g, h, n)) for g in ahead]
    got = sample_indices(drawn, h, n, s, mask)
    assert torch.equal(got, want) and got.shape == (2, h, s)
    assert all(torch.equal(a.get_state(), b.get_state()) for a, b in zip(eager, ahead))
    with pytest.raises(ValueError, match="drawn as"):
        drawn[0](h // 2, n, s)


def test_runner_frames_match_the_jax_rollout(dot_world):  # noqa: F811
    """From the JAX package's bootstrapped state carried across by
    state_from_numpy, four frames of the runner against the JAX package's
    jitted `vo_rollout` (a lax.scan) with the JAX draws replayed: poses
    within 1e-4, lifecycle states, uids and next_uid exact (the tolerances
    of test_one_step_from_a_jax_state)."""
    imgs, _ = dot_world
    n = 4
    jcfg, K = JaxConfig(capacity=DOT_CAPACITY), jnp.asarray(K_DOTS)
    jstate, _ = jpipe.bootstrap(jnp.asarray(imgs[0]), jnp.asarray(imgs[2]), K, jcfg,
                                jax.random.PRNGKey(1))
    jfinal, want = jpipe.vo_rollout(jstate, jnp.asarray(imgs[3:3 + n]), K, jcfg)
    assert bool(np.asarray(want.pose_ok).all())  # no recovery draw to replay
    keys, rec_keys, key = [], [], jstate.rng
    for _ in range(n):  # vo_step's split: (next key, PnP's key, recovery's key)
        key, k_pnp, k_rec = jax.random.split(key, 3)
        keys.append(k_pnp)
        rec_keys.append(k_rec)
    state = tpipe.state_from_numpy(jstate, "cpu", _replay(keys), _replay(rec_keys))
    (final, got), runner = _captured(state, torch.from_numpy(imgs[3:3 + n]),
                                     torch.from_numpy(K_DOTS), VOConfig(capacity=DOT_CAPACITY))
    assert runner.stats.keyframes >= 1
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-4)
    np.testing.assert_array_equal(got.pose_ok.numpy(), np.asarray(want.pose_ok))
    np.testing.assert_array_equal(final.table.state.numpy(), np.asarray(jfinal.table.state))
    np.testing.assert_array_equal(final.table.uid.numpy(), np.asarray(jfinal.table.uid))
    assert int(final.next_uid) == int(jfinal.next_uid)
    assert int(final.last_kf_idx) == int(jfinal.last_kf_idx)


def test_a_captured_runner_needs_generators_on_the_card(city):
    """A replaying sampler runs inside segment A, which only the stand-in
    runs again: a runner that captures on the card refuses it."""
    frames, K = city
    state = _boot(frames, K, 2023)
    runner = graphed.runner_for(state, frames[3:5], K, CFG, RunnerCache(), graphed.StandIn())
    runner.capture = type("NoRerun", (graphed.StandIn,), {"reruns_python": False})()
    with pytest.raises(ValueError, match="torch.Generators"):
        runner(state._replace(rng=lambda *a: None), frames[3:5], K)


@pytest.mark.parametrize("lost,push", [(False, False), (True, False), (False, True),
                                       (True, True)])
def test_the_step_schedule(lost, push):
    """`pipeline.run_step`, the one schedule that `vo_step` and the runner
    both walk: A (its front end, then PnP), R under the device predicate "a
    lane lost its pose", B1, eigh, B2, C under "a lane pushes", D; each
    segment gets the results of the ones before it, and a mark falls on
    every boundary, R's and C's inside their branches. The predicates come
    in as tensors and the schedule itself reads nothing: what a branch does
    with its predicate is the caller's (`eager_branch` reads it; the runner
    makes an IF node of it)."""
    calls, branches = [], []

    def seg(name, result):
        def run(*args):
            calls.append((name, args))
            return result
        return run

    def mark(boundary):
        calls.append(("mark", boundary))

    def branch(name, pred, run, skipped):
        # The runner's way: the predicate is a device tensor over all lanes,
        # handed on as it is (here the device's part is played by reading it).
        assert torch.is_tensor(pred) and pred.dtype == torch.bool and pred.ndim == 0
        branches.append((name, bool(pred)))
        return run() if bool(pred) else skipped

    tracked = SimpleNamespace(pose_ok=torch.tensor([True, not lost]))
    mapped = SimpleNamespace(push=torch.tensor([False, push]))
    segments = tpipe.Segments(
        track=seg("A", "f"), localize=seg("PnP", tracked), recover=seg("R", "a'"),
        locate=seg("B1", "g"), eigh=seg("eigh", "v"), map=seg("B2", mapped),
        keyframe=seg("C", "b'"), finish=seg("D", "out"))
    assert tpipe.run_step(segments, branch, CFG, mark) == "out"
    a = "a'" if lost else tracked
    b = "b'" if push else mapped

    def marked(name, call):
        return [("mark", f"{name}.start"), call, ("mark", f"{name}.end")]

    want = [("mark", "start"), ("A", ()), ("mark", "track"), ("PnP", ("f",)),
            ("mark", "localize")] + marked("R", ("R", (tracked,))) * lost + [
        ("B1", (a,)), ("mark", "locate"), ("eigh", ("g",)), ("mark", "eigh"),
        ("B2", (a, "g", "v")), ("mark", "map")] + marked("C", ("C", (a, mapped))) * push + [
        ("D", (a, b)), ("mark", "end")]
    assert calls == want and branches == [("R", lost), ("C", push)]
    assert [c[1] for c in want if c[0] == "mark"] == [
        x for x in tpipe.BOUNDARIES if not (x[0] == "R" and not lost)
        and not (x[0] == "C" and not push)]
    # The eager step's branch gives the same calls; its default mark is none.
    calls.clear()
    assert tpipe.run_step(segments, tpipe.eager_branch, CFG, mark) == "out" and calls == want
    calls.clear()
    tpipe.run_step(segments, tpipe.eager_branch, CFG)
    assert calls == [c for c in want if c[0] != "mark"]
    # Without recovery and BA there is no branch, and R and C never run.
    calls.clear()
    branches.clear()
    off = VOConfig(capacity=CAPACITY, ba=BAConfig(enabled=False),
                   recovery=dataclasses.replace(CFG.recovery, enabled=False))
    tpipe.run_step(segments, branch, off)
    assert [c[0] for c in calls] == ["A", "PnP", "B1", "eigh", "B2", "D"] and branches == []


def test_a_lane_lost_on_some_frames_of_the_chunk(city, monkeypatch):
    """Three lanes; the third sees noise on frames 5-8 only, so R runs on
    some frames of the chunk and not on others, and a frame without R must
    find A's fallback pose as A wrote it. The runner equals the eager
    rollout in every StepOutput field, the final state and the generators,
    and the frames on which R ran, counted on the device, are the eager
    step's."""
    frames, K = city
    state, images, Ks = _lanes(frames, K, noise=slice(5, 9))
    rewind = tpipe.rewinder(state)
    taken = []

    def counting(name, pred, run, skipped):
        taken.append((name, bool(pred)))
        return tpipe_branch(name, pred, run, skipped)

    tpipe_branch = tpipe.eager_branch
    monkeypatch.setattr(tpipe, "eager_branch", counting)
    final_e, eager = tmulti.batched_vo_rollout(state, images, Ks, CFG)
    monkeypatch.setattr(tpipe, "eager_branch", tpipe_branch)
    after = [g.get_state() for g in _gens(state)]
    rewind()
    (final_g, got), runner = _captured(state, images, Ks)
    for name, a, b in zip(eager._fields, eager, got):
        assert torch.equal(a, b), name
    for a, b in zip(graphed._leaves(final_e), graphed._leaves(final_g)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, g.get_state()) for a, g in zip(after, _gens(state)))
    lost = [ran for name, ran in taken if name == "R"]
    assert any(lost) and not all(lost)  # the lost pattern changes inside the chunk
    assert runner.stats.recoveries == sum(lost)
    assert runner.stats.keyframes == sum(ran for name, ran in taken if name == "C")
    assert not bool(got.pose_ok[2:6, 2].any()) and bool(got.pose_ok[-3:, 2].all())


def test_a_captured_rollout_reads_nothing(city, monkeypatch):
    """Over N frames the runner never takes the eager branch (which reads
    its predicate on the host), and counts no host sync."""
    frames, K = city
    state, images, Ks = _lanes(frames, K)

    def read(*args):
        raise AssertionError("the captured rollout read a predicate on the host")

    monkeypatch.setattr(tpipe, "eager_branch", read)
    (_, got), runner = _captured(state, images, Ks)
    assert got.pose.shape[0] == images.shape[0] == runner.stats.frames
    assert runner.stats.syncs == 0 and runner.stats.recoveries == images.shape[0]


def test_the_warm_up_gives_r_and_c_their_slots(city, monkeypatch):
    """No lane of the scratch state is lost, yet the warm-up runs R and C
    once each (outside capture), so both have their results' slots before
    the frame's graph is captured: A's (R rewrites its fallback pose), B2's
    (C rewrites it) and the step's outputs."""
    frames, K = city
    ran = []
    for name in ("step_recover", "step_keyframe"):
        real = getattr(graphed, name)

        def wrapped(*args, real=real, name=name):
            ran.append(name)
            return real(*args)

        monkeypatch.setattr(graphed, name, wrapped)
    state = _boot(frames, K, 2023)
    runner = graphed.GraphedRollout(CFG, tmulti.stack_states([state]), frames[3:4],
                                    K.reshape(1, 3, 3), graphed.StandIn())
    # The warm-up ran each branch once, first; the stand-in's captures run
    # Python again after it.
    assert ran[:2] == ["step_recover", "step_keyframe"]
    assert set(runner._slots) == {"A", "B2", "out"}
    slot_fb = runner._slots["A"].pose_fb
    assert runner.a.pose_fb is slot_fb and set(runner.branches) == {"R", "C"}
    assert runner.stats.recoveries == 0 and runner.stats.keyframes == 0


def test_a_runner_per_branch_shape(city):
    """What decides the frame graph's shape is in the runner's key: the
    recovery off (no IF node for R) and BA off (none for C) are runners of
    their own."""
    frames, K = city
    cache = RunnerCache()
    shapes = {}
    for rec in (True, False):
        for ba in (True, False):
            cfg = VOConfig(capacity=CAPACITY, ba=BAConfig(enabled=ba),
                           recovery=dataclasses.replace(CFG.recovery, enabled=rec))
            _, runner = _captured(_boot(frames, K, 2023, cfg), frames[3:4], K, cfg, cache)
            shapes[(rec, ba)] = set(runner.branches)
    assert cache.captures == len(cache) == 4
    assert shapes == {(True, True): {"R", "C"}, (True, False): {"R"},
                      (False, True): {"C"}, (False, False): set()}


def test_check_recorded_holds_counts_to_the_graph():
    """On the card every captured graph's counted launches are held against
    its kernel nodes, by the kernel's symbol in the node's function name."""
    names = ["void at::native::vectorized_elementwise_kernel<4>(...)",
             "_ZN12_GLOBAL__N_117corner_nms_kernelILi7ELi8EEEvPKfPfiiifii",
             "_ZN12_GLOBAL__N_119patch_gather_kernelENS_9GatherJobES0_iiii"] + [
             "_ZN12_GLOBAL__N_119patch_gather_kernelENS_9GatherJobES0_iiii"] * 3
    graphed.check_recorded("A", {"extract_patches": 4, "corner_response_nms": 1}, names)
    graphed.check_recorded("A", {"extract_patches_batched": 3, "extract_patches": 1,
                                 "corner_response_nms_batched": 1}, names)
    with pytest.raises(RuntimeError, match="holds 4 patch_gather_kernel nodes"):
        graphed.check_recorded("A", {"extract_patches": 5, "corner_response_nms": 1}, names)
    with pytest.raises(RuntimeError, match="holds 1 corner_nms_kernel"):
        graphed.check_recorded("B2", {"extract_patches": 4}, names)
    graphed.check_recorded("D", {}, names[:1])
    solve = "_ZN12_GLOBAL__N_115lk_solve_kernelENS_7LkLevelE"
    graphed.check_recorded("A", {"extract_patches": 4, "corner_response_nms": 1,
                                 "lk_solve": 4}, names + [solve] * 4)
    with pytest.raises(RuntimeError, match="holds 3 lk_solve_kernel nodes"):
        graphed.check_recorded("A", {"extract_patches": 4, "corner_response_nms": 1,
                                     "lk_solve_batched": 4}, names + [solve] * 3)


def test_rollouts_report_what_ran(city):
    """`executor_since` names what the rollouts since a mark ran, from what
    ran: the eager loop, the runner's replays, both, or nothing."""
    frames, K = city
    mark = dict(tpipe.ROLLED)
    assert tpipe.executor_since(mark) == "none"
    tpipe.vo_rollout(_boot(frames, K, 2023), frames[3:5], K, CFG)
    assert tpipe.executor_since(mark) == "eager"
    graphs = dict(tpipe.ROLLED)
    _captured(_boot(frames, K, 2023), frames[3:5], K)
    assert tpipe.executor_since(graphs) == "graphs"
    assert tpipe.executor_since(mark) == "mixed"
    assert tpipe.ROLLED["graphs"] - graphs["graphs"] == 2


def test_a_runner_is_kept_per_frame_dtype(city):
    """The frame's dtype is part of the key, and a runner refuses frames of
    another dtype instead of casting them into its static frame."""
    frames, K = city
    key = [runner_key(CFG, 1, 120, 160, dtype, "cpu") for dtype in (torch.float32,
                                                                     torch.float64)]
    assert key[0] != key[1]
    _, runner = _captured(_boot(frames, K, 2023), frames[3:5], K)
    with pytest.raises(ValueError, match="torch.float64"):
        runner(_boot(frames, K, 2023), frames[3:5].double(), K)


def test_batched_rollout_checks_its_shapes(city):
    frames, K = city
    states, images, Ks = _lanes(frames, K)
    with pytest.raises(ValueError, match="3 lanes need images"):
        tmulti.batched_vo_rollout(states, images[:, :2], Ks, CFG)
    with pytest.raises(ValueError, match="3 lanes need images"):
        tmulti.batched_vo_rollout(states, images, Ks[:2], CFG)
