"""BA's camera-system solve kernel (csrc/ba_solve.cu, `kernels.ba_solve`)
on the card, against the blocked Cholesky it replaces there
(`ops/linalg.py::spd_solve_blocked`, run on the card too) and a float64
dense solve: random SPD systems at W = 1-6 and 12, systems caught from BA's
step with the 1e8 gauge and dead keyframes, singular and NaN systems, a
lane of six against its single run, the launch count on the device in a
captured rollout, and C's graph. Every test is marked `cuda` and skips where
torch sees no GPU; the file imports neither jax nor vo_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_ba_solve_cuda.py

The kernel and the blocked solve sum a block's terms in other orders, so
they agree to the system's condition in float32, not bit for bit: the
kernel's error against float64 is held to twice the blocked solve's.
"""

import numpy as np
import pytest
import torch

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
C_NODES = 9494  # C's nodes in the frame's graph with the blocked solve (capacity 1024)
C_NODES_NOW = 1700  # held below this with the kernel


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel builds and runs only there)")
    return torch.device("cuda:0")


def _systems(dev, lanes, W, seed, cond=1e3, nb=6):
    rng = np.random.default_rng(seed)
    n = W * nb
    S = []
    for _ in range(lanes):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        A = (Q * np.geomspace(1.0, cond, n)) @ Q.T
        S.append(A.reshape(W, nb, W, nb).transpose(0, 2, 1, 3))
    return (torch.tensor(np.stack(S), dtype=torch.float32, device=dev),
            torch.tensor(rng.normal(size=(lanes, W, nb)), dtype=torch.float32, device=dev))


def _f64_error(x, S, b):
    lanes, W, _, nb, _ = S.shape
    dense = S.double().permute(0, 1, 3, 2, 4).reshape(lanes, W * nb, W * nb)
    want = torch.linalg.solve(dense, b.double().reshape(lanes, W * nb, 1)).reshape(b.shape)
    return float((x.double() - want).abs().max())


def _caught(dev, seeds=(3,), dead=()):
    """The camera systems of BA's step on the demo window, one a seed."""
    from vo_tpu_torch.models import ba
    from vo_tpu_torch.ops.linalg import spd_solve_blocked
    from vo_tpu_torch.parallel.dist_ba import demo_window

    caught = []

    def keep(S, b):
        caught.append((S, b))
        return spd_solve_blocked(S, b)

    Kt = torch.as_tensor(K, device=dev).reshape(1, 3, 3)
    for seed in seeds:
        win = demo_window(1024, num_keyframes=6, seed=seed, device=dev)
        win = ba.BAWindow(*(f[None] for f in win))
        if dead:
            valid = win.kf_valid.clone()
            valid[0, list(dead)] = False
            win = win._replace(kf_valid=valid)
        ba._gn_step(win, Kt, 1e-3, 2.0, solve=keep)
    return caught


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 2, 3, 4, 5, 6, 12])
def test_random_systems_against_float64(dev, W):
    from vo_tpu_torch.ops import kernels
    from vo_tpu_torch.ops.linalg import spd_solve_blocked

    S, b = _systems(dev, 3, W, seed=W)
    x, plain = kernels.ba_solve(S, b), spd_solve_blocked(S, b)
    assert x.shape == b.shape and x.dtype == torch.float32
    assert _f64_error(x, S, b) <= 2 * _f64_error(plain, S, b) + 1e-6
    if W == 1:  # one block: chol_small and the two triangular solves, same roundings
        assert torch.equal(x, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dead", [(), (4, 5)], ids=["gauge", "dead_keyframes"])
def test_systems_caught_from_the_gn_step(dev, dead):
    from vo_tpu_torch.ops import kernels
    from vo_tpu_torch.ops.linalg import spd_solve_blocked

    for S, b in _caught(dev, (3, 4, 5), dead):
        x = kernels.ba_solve(S, b)
        assert _f64_error(x, S, b) <= 2 * _f64_error(spd_solve_blocked(S, b), S, b) + 1e-6


@pytest.mark.cuda
def test_solve_ok_as_the_blocked_solve_on_singular_and_nan_systems(dev):
    from vo_tpu_torch.ops import kernels
    from vo_tpu_torch.ops.linalg import spd_solve_blocked

    S, b = _systems(dev, 5, 6, seed=5)
    S[1, 2, 2, 0, 0] = float("nan")
    S[2, 3], S[2, :, 3] = 0.0, 0.0
    b[2, 3] = 1e19  # floored pivots: 1e19 / 1e-10 / 1e-10 overflows
    S[3, 1], S[3, :, 1], b[3, 1] = 0.0, 0.0, 0.0  # floored pivots, finite x
    b[4, 0, 0] = float("nan")
    ok = torch.isfinite(kernels.ba_solve(S, b)).flatten(-2).all(-1)
    assert ok.tolist() == [True, False, False, True, False]
    assert torch.equal(ok, torch.isfinite(spd_solve_blocked(S, b)).flatten(-2).all(-1))


@pytest.mark.cuda
def test_a_lane_of_six_is_its_single_run(dev):
    from vo_tpu_torch.ops import kernels

    systems = _caught(dev, (3, 4, 5, 6, 7, 8))
    S = torch.cat([s for s, _ in systems])
    b = torch.cat([r for _, r in systems])
    x = kernels.ba_solve(S, b)
    for lane, (s1, b1) in enumerate(systems):
        assert torch.equal(kernels.ba_solve(s1, b1)[0], x[lane])
        assert torch.equal(kernels.ba_solve(s1[0], b1[0]), x[lane])


@pytest.mark.cuda
def test_wrapper_checks_and_eager_count(dev):
    from vo_tpu_torch.ops import kernels

    S, b = _systems(dev, 2, 6, seed=1)
    calls = kernels.device_calls["ba_solve"]
    slots = torch.zeros(len(kernels.DEVICE_COUNTED), dtype=torch.int64, device=dev)
    kernels.ba_solve(S, b)  # eager: counted on the host alone
    with kernels.counting_on_device(slots):
        kernels.ba_solve(S, b)
        kernels.ba_solve(S[0], b[0])
    assert kernels.device_calls["ba_solve"] == calls + 3
    assert slots.tolist() == [2]
    with pytest.raises(TypeError, match="float32"):
        kernels.ba_solve(S.double(), b.double())
    with pytest.raises(ValueError, match="lane axis"):
        kernels.ba_solve(S[None], b[None])
    with pytest.raises(ValueError, match="up to 96"):
        kernels.ba_solve(*_systems(dev, 1, 17, seed=2))
    with pytest.raises(ValueError, match="one CUDA device"):
        kernels.ba_solve(S, b.cpu())


@pytest.mark.cuda
def test_device_count_reads_five_a_c_run_in_a_captured_rollout(dev):
    """The headline's city at 640x480, capacity 1024, 10 steps in one
    captured rollout: the solve's launches, counted by the kernel on the
    device inside C's conditional body, are `ba.iters` for every frame on
    which C ran (the device's count of C, and the steps with a C mark);
    C's graph holds `ba.iters` solve nodes, the frame's none outside its
    bodies, and C's nodes fall below C_NODES_NOW from C_NODES."""
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.models import graphed, pipeline
    from vo_tpu_torch.utils.cache import RunnerCache
    from vo_tpu_torch.utils.config import VOConfig

    seq = synthetic.render_sequence(synthetic.DEFAULT_SPEC, dev, 13)
    cfg = VOConfig(capacity=1024)
    state, _ = pipeline.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                                  torch.Generator(device=dev).manual_seed(2023))
    cache = RunnerCache()
    graphed.graphed_rollout(state, seq.frames[3:], seq.K, cfg, cache=cache)
    runner = cache.runners()[-1]
    nodes = runner.frame.nodes
    iters = cfg.ba.iters
    assert sum("ba_solve_kernel" in n for n in nodes.body_kernels) == iters
    assert not any("ba_solve_kernel" in n for n in nodes.kernels)
    assert runner.stats.graphs["C"] < C_NODES_NOW < C_NODES
    s = graphed.summary(cache)
    assert s["keyframes"] > 0
    assert s["device_launches"] == {"ba_solve": iters * s["keyframes"]}
    assert s["spans"]["branch_steps"]["keyframe"] == s["keyframes"]
