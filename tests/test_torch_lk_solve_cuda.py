"""The LK solve kernel (csrc/lk_solve.cu, `kernels.lk_solve`) against its
plain version on the card: `pyramidal_lk_counted` on its kernel route
against `use_pallas=False` on the same levels, points and guesses, and the
frame graph it leaves. Every test is marked `cuda` and skips where torch
sees no GPU; the file imports neither jax nor vo_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_lk_solve_cuda.py

The two routes sum a window's products in another order, so they agree to a
few ulps a level, and a point whose update sits on the eps test may stop one
iteration apart: hence limits on shares and sums, not bit equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

LEVELS = 4
XY_PX = 1e-3  # tracked by both routes: positions this close
ERR_REL = 1e-4  # and errors this close, relative
# One ulp of the 0-255 intensity scale is 7.6e-6 at 128, so where a window
# matches to a few ulps (a frame against itself) the error itself is a few
# ulps: held to this absolute floor there.
ERR_ABS = 1e-4
STATUS_SHARE = 0.999  # slots whose status agrees
SETTLED_SHARE = 0.5  # of the points both track, those stopped by eps at every level
TRACKED_SHARE = 0.99  # of the points both track, those within XY_PX, settled or not
LIVE_REL = 0.005  # live iterations, summed over levels and points
FRAME_NODES = 16434  # the frame's graph before the kernel, spans off (VOConfig(capacity=1024))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel builds and runs only there)")
    return torch.device("cuda:0")


def _city(dev, shape, frames):
    from vo_tpu_torch.data import synthetic

    h, w = shape
    spec = synthetic.DEFAULT_SPEC
    if (h, w) != (spec.height, spec.width):  # KITTI 05's frame and focal length
        spec = dataclasses.replace(spec, width=w, height=h, focal=707.0912)
    return synthetic.render_sequence(spec, dev, frames)


def _points(dev, rng, frame, k):
    """K points of a frame, half of them its strongest corners (they track
    and converge in a few iterations) and the rest anywhere: flat regions
    that are not conditioned, the frame's corners and edges, and points up
    to 5 px outside it."""
    from vo_tpu_torch.ops import kernels

    h, w = frame.shape
    resp = kernels.corner_response_nms(frame, "shi_tomasi", 7, 0.08, 8)
    top = torch.topk(torch.nan_to_num(resp, neginf=-1.0).flatten(), k // 2).indices
    corners = torch.stack([top % w, top // w], -1).float()
    rest = rng.uniform(-5, [w + 5, h + 5], (k - k // 2, 2)).astype(np.float32)
    rest[:8] = [[0, 0], [w - 1, h - 1], [0, h - 1], [w - 1, 0],
                [-5, 20], [w + 4, 30], [40, -3], [50, h + 2]]
    return torch.cat([corners, torch.as_tensor(rest, device=dev)])


def _guesses(dev, rng, k, h, w):
    """Zero flow for most points; garbage for a quarter: large jumps that do
    not converge, NaN and absurd values that the sanity test drops."""
    g = np.zeros((k, 2), np.float32)
    bad = rng.choice(k, k // 4, replace=False)
    g[bad] = rng.uniform(-0.45, 0.45, (len(bad), 2)) * [w, h]
    g[bad[:8]] = [[np.nan, 0], [np.inf, 1], [1e9, 0], [0, -1e9], [0.3, 0.2], [-0.7, 0.1],
                  [w, 0], [0, h]]
    return torch.as_tensor(g, device=dev)


def _route(p0, p1, xy, flow, use_pallas):
    """`pyramidal_lk_counted` on one route, and each point's live iterations
    at each level (the count the level's solve appended)."""
    from vo_tpu_torch.ops import klt

    levels, real = [], klt.lk_solve

    def keeping(*args, **kwargs):
        out = real(*args, **kwargs)
        levels.append(args[9][-1])
        return out

    klt.lk_solve = keeping
    try:
        track, live = klt.pyramidal_lk_counted(p0, p1, xy, init_flow=flow,
                                               use_pallas=use_pallas)
    finally:
        klt.lk_solve = real
    return track, live, torch.stack(levels).long()


def _both_routes(p0, p1, xy, flow):
    """Both routes, and what the kernel route launched; the plain route
    launches nothing (else the kernel would be held to itself)."""
    from vo_tpu_torch.ops import kernels

    before = dict(kernels.launch_counts)
    got = _route(p0, p1, xy, flow, None)
    torch.cuda.synchronize()
    launched = {n: kernels.launch_counts[n] - before[n] for n in before}
    before = dict(kernels.launch_counts)
    want = _route(p0, p1, xy, flow, False)
    assert kernels.launch_counts == before
    return got, want, launched


def _held(got, want, max_iters=10):
    """Status on 99.9% of the slots; live iterations within 0.5%; positions
    and errors of the points both routes track and both stopped by the eps
    test after the same iterations at every level. A point still moving
    after `max_iters` iterations of a level has no answer up to rounding:
    where the iteration does not contract, a last-bit difference grows each
    iteration (a third of the tracked points on the city). One whose last
    update sits on the eps test may stop an iteration apart, up to eps away
    (a few in 10^5 point-iterations). 99% of all tracked points must still
    agree within XY_PX."""
    (track, live, levels), (ptrack, plive, plevels) = got, want
    assert track.xy.shape == ptrack.xy.shape and live.dtype == plive.dtype == torch.int64
    same = track.status == ptrack.status
    assert float(same.float().mean()) >= STATUS_SHARE, int((~same).sum())
    assert bool((live - plive).abs().sum() <= LIVE_REL * plive.sum()), (live, plive)
    both = (track.status & ptrack.status).flatten()
    levels, plevels = levels.flatten(1), plevels.flatten(1)
    settled = both & (levels == plevels).all(0) & (levels < max_iters).all(0)
    assert int(settled.sum()) >= SETTLED_SHARE * int(both.sum()) > 0
    gap = (track.xy - ptrack.xy).abs().amax(-1).flatten()
    egap = (track.err - ptrack.err).abs().flatten()
    perr = ptrack.err.flatten()
    worst = [(i, float(gap[i]), float(egap[i]), float(perr[i]), levels[:, i].tolist())
             for i in torch.nonzero(settled).flatten()[
                 torch.argsort(egap[settled], descending=True)[:4]].tolist()]
    assert float(gap[settled].max()) <= XY_PX, worst
    assert float((gap[both] <= XY_PX).float().mean()) >= TRACKED_SHARE
    assert bool((egap[settled] <= ERR_REL * perr[settled].abs() + ERR_ABS).all()), worst


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 6])
@pytest.mark.parametrize("shape,k", [((480, 640), 1024), ((370, 1226), 512)])
def test_kernel_route_tracks_as_the_plain_route(dev, shape, k, lanes):
    """One lane or six (each its own pair of frames and points): tracked
    positions, errors, status and live iterations against the plain route;
    one solve launch and one pair launch a level; lane b of the batched call
    is the single call on lane b bit for bit."""
    from vo_tpu_torch.ops import image as timg
    from vo_tpu_torch.ops.klt import pyramidal_lk_counted

    rng = np.random.default_rng(k + lanes)
    frames = _city(dev, shape, lanes + 2).frames
    h, w = shape
    xy = torch.stack([_points(dev, rng, frames[b], k) for b in range(lanes)])
    flow = torch.stack([_guesses(dev, rng, k, h, w) for _ in range(lanes)])
    if lanes == 1:
        xy, flow, prev, nxt = xy[0], flow[0], frames[0], frames[2]
    else:
        prev, nxt = frames[:lanes], frames[2:lanes + 2]
    p0, p1 = timg.build_pyramid(prev, LEVELS), timg.build_pyramid(nxt, LEVELS)
    got, want, launched = _both_routes(p0, p1, xy, flow)
    suffix = "_batched" if lanes > 1 else ""
    assert launched == {**{n: 0 for n in launched}, "lk_solve" + suffix: LEVELS,
                        "extract_patches" + suffix: LEVELS}
    _held(got, want)
    # Each kind of point is there: not conditioned, tracked, run to max_iters.
    track, live, levels = got
    assert 0 < int(track.status.sum()) < track.status.numel()
    assert bool((levels == 10).any()) and bool((levels == 0).any())
    if lanes > 1:
        one, one_live = pyramidal_lk_counted([p[3] for p in p0], [p[3] for p in p1], xy[3],
                                             init_flow=flow[3])
        assert torch.equal(one.xy, track.xy[3]) and torch.equal(one.err, track.err[3])
        assert torch.equal(one.status, track.status[3]) and int(one_live) == int(live[3])


@pytest.mark.cuda
def test_points_on_a_frame_against_itself_stop_after_one_iteration(dev):
    """With the next frame equal to the previous one and no guess, every
    conditioned point's first update is a rounding error: both routes count
    exactly one live iteration a level for it, and track it where it was."""
    from vo_tpu_torch.ops import image as timg

    rng = np.random.default_rng(3)
    frame = _city(dev, (480, 640), 1).frames[0]
    xy = _points(dev, rng, frame, 1024)
    pyr = timg.build_pyramid(frame, LEVELS)
    got, want, _ = _both_routes(pyr, pyr, xy, None)
    (track, live, levels), (_, plive, plevels) = got, want
    assert int(live) == int(plive) > 0
    assert torch.equal(levels, plevels) and int(levels.max()) == 1
    _held(got, want)
    assert float((track.xy - xy)[track.status].abs().max()) <= XY_PX


@pytest.mark.cuda
def test_a_radius_past_48_kb_of_shared_memory_a_point(dev):
    """Radius 24 (patches of 53 and 67, 58.8 KB of shared memory a point)
    takes the shared-memory attribute and one point a block, and tracks as
    the plain route does."""
    from vo_tpu_torch.ops import image as timg
    from vo_tpu_torch.ops.klt import pyramidal_lk_counted

    rng = np.random.default_rng(24)
    frames = _city(dev, (480, 640), 3).frames
    xy = _points(dev, rng, frames[0], 512)
    p0, p1 = timg.build_pyramid(frames[0], 3), timg.build_pyramid(frames[2], 3)
    got, want = (pyramidal_lk_counted(p0, p1, xy, radius=24, use_pallas=route)
                 for route in (None, False))
    (track, live), (ptrack, plive) = got, want
    assert float((track.status == ptrack.status).float().mean()) >= 0.99
    both = track.status & ptrack.status
    assert int(both.sum()) > 0
    assert float(((track.xy - ptrack.xy).abs().amax(-1)[both] <= XY_PX).float().mean()) >= 0.9
    assert abs(int(live) - int(plive)) <= LIVE_REL * int(plive)


@pytest.mark.cuda
def test_wrapper_checks_on_the_card(dev):
    from vo_tpu_torch.ops import kernels

    k, r = 16, 8
    t = torch.zeros((k, 21, 21), device=dev)
    s = torch.zeros((k, 35, 35), device=dev)
    p = torch.zeros((k, 2), device=dev)
    args = (r, 10, 0.03, 1e-4)
    flow, cond, err = kernels.lk_solve(t, s, p, p, p, *args)
    assert flow.shape == (k, 2) and cond.dtype == torch.bool and err.shape == (k,)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.lk_solve(t, s.transpose(1, 2), p, p, p, *args)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lk_solve(t, s, p.cpu(), p, p, *args, use_kernel=True)
    with pytest.raises(TypeError, match="float32"):
        kernels.lk_solve(t, s, p, p.double(), p, *args)
    with pytest.raises(TypeError, match="float32"):
        kernels.lk_solve(t.double(), s, p, p, p, *args)
    flow64, _, _ = kernels.lk_solve(t.double(), s.double(), p.double(), p.double(),
                                    p.double(), *args, use_kernel=False)  # plain, on the card
    assert flow64.dtype == torch.float64


@pytest.mark.cuda
def test_frame_graph_sheds_the_solver_chain(dev):
    """The frame's graph (spans off) holds at least 1,800 fewer nodes than
    the 16,434 it held with the plain solve, four LK solve nodes and still
    four K2 pair nodes a step."""
    from vo_tpu_torch.models import graphed, pipeline
    from vo_tpu_torch.utils.cache import RunnerCache
    from vo_tpu_torch.utils.config import VOConfig

    seq = _city(dev, (480, 640), 7)
    frames, K = seq.frames, seq.K
    cfg = VOConfig(capacity=1024)
    state, _ = pipeline.bootstrap(frames[0], frames[2], K, cfg,
                                  torch.Generator(device=dev).manual_seed(2023))
    runner = graphed.runner_for(state, frames[3:], K, cfg, RunnerCache(), spans=False)
    nodes = runner.frame.nodes
    assert nodes.nodes <= FRAME_NODES - 1800, nodes.nodes
    assert sum("patch_gather_kernel" in n for n in nodes.kernels) == LEVELS
    assert sum("lk_solve_kernel" in n for n in nodes.kernels) == LEVELS
    assert not any("lk_solve_kernel" in n for n in nodes.body_kernels)
    assert runner.launches == {"corner_response_nms": 1, "extract_patches": LEVELS,
                               "lk_solve": LEVELS}
    _, outs = runner(state, frames[3:], K)
    assert bool(torch.isfinite(outs.pose).all())
