"""The matched-detection front-end of the port against the JAX package:
patch descriptors, the gated ratio matcher, subpixel corner refinement,
`_match_track`, and the harris tracker through `bootstrap` and `vo_step`
from a JAX state with the JAX package's own RANSAC draws replayed."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vo_tpu.models import pipeline as jpipe
from vo_tpu.ops import descriptors as jdesc
from vo_tpu.ops import harris as jharris
from vo_tpu.ops import ransac as jransac
from vo_tpu.utils.config import VOConfig as JaxConfig

from vo_tpu_torch.data import synthetic as tsyn
from vo_tpu_torch.models import pipeline as tpipe
from vo_tpu_torch.ops import descriptors as tdesc
from vo_tpu_torch.ops import harris as tharris
from vo_tpu_torch.parallel.multiseq import batched_vo_rollout, stack_states
from vo_tpu_torch.utils.config import VOConfig

torch.set_num_threads(1)

CAPACITY = 256
SPEC = dataclasses.replace(tsyn.DEFAULT_SPEC, width=320, height=240, focal=208.0)


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def frames():
    """The first frames of the headline city at 320x240 (numpy, f32)."""
    rects, tex = tsyn.scene(SPEC)
    poses = tsyn.make_path(SPEC.path, SPEC.num_frames)[:7]
    out = tsyn.render_frames_torch(rects, tex, poses, SPEC.K(), SPEC.width, SPEC.height)
    return out.to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# ops/descriptors.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [4, 9])
def test_extract_patches(frames, radius):
    """Raw patches exact; normalized patches 1e-5 where the patch has
    contrast (a standard deviation of 10 grey levels or more) and 1e-4
    anywhere (the f32 mean of 81-361 grey levels summed in another order,
    divided by a contrast that may be one grey level); keypoints on .5
    (round half to even), beyond the border (clamped), in a batch of two."""
    rng = np.random.default_rng(radius)
    xy = rng.uniform(-5, 330, (200, 2)).astype(np.float32)
    xy[:40] = np.floor(xy[:40]) + 0.5
    img = frames[0]
    raw = tdesc.extract_patches(T(img), T(xy), radius)
    np.testing.assert_array_equal(
        N(raw), np.asarray(jdesc.extract_patches(jnp.asarray(img), jnp.asarray(xy), radius)))
    assert raw.shape == (200, (2 * radius + 1) ** 2)
    nrm = tdesc.extract_patches(T(img), T(xy), radius, normalize=True)
    want = np.asarray(jdesc.extract_patches(jnp.asarray(img), jnp.asarray(xy), radius,
                                            normalize=True))
    np.testing.assert_allclose(N(nrm), want, atol=1e-4)
    textured = N(raw).std(axis=-1) >= 10.0
    assert textured.sum() > 50
    np.testing.assert_allclose(N(nrm)[textured], want[textured], atol=1e-5, rtol=1e-5)
    both = tdesc.extract_patches(T(frames[:2]), T(np.stack([xy, xy[::-1]])), radius,
                                 normalize=True)
    np.testing.assert_array_equal(N(both[0]), N(nrm))
    np.testing.assert_array_equal(
        N(both[1]), N(tdesc.extract_patches(T(frames[1]), T(xy[::-1].copy()), radius,
                                            normalize=True)))


def _descriptor_sets(seed, k1=160, k2=200, d=49):
    rng = np.random.default_rng(seed)
    d2 = rng.normal(size=(k2, d)).astype(np.float32)
    d1 = (d2[rng.permutation(k2)[:k1]] + rng.normal(0, 0.15, (k1, d))).astype(np.float32)
    d2[10] = d2[11]  # exact ties in a row's top-2 and in a column's minimum
    d1[5] = d1[6]
    v1 = rng.uniform(size=k1) > 0.1
    v2 = rng.uniform(size=k2) > 0.1
    v1[20:24] = False  # dead rows
    pair = rng.uniform(size=(k1, k2)) > 0.3
    pair[30] = False  # a row with no candidate at all
    pair[31, :] = False
    pair[31, 7] = True  # a row with one candidate: no second to compare with
    return d1, d2, v1, v2, pair


@pytest.mark.parametrize("seed,gated,mutual", [(0, True, True), (1, False, True),
                                               (2, True, False), (3, False, False)])
def test_match_descriptors(seed, gated, mutual):
    """The same matches (index and validity) as the JAX package, distances
    1e-3 relative: with ties, dead rows and slots, and the pair gate."""
    d1, d2, v1, v2, pair = _descriptor_sets(seed)
    kw = dict(ratio=0.85, mutual=mutual)
    want = jdesc.match_descriptors(
        jnp.asarray(d1), jnp.asarray(d2), valid1=jnp.asarray(v1), valid2=jnp.asarray(v2),
        pair_valid=jnp.asarray(pair) if gated else None, **kw)
    got = tdesc.match_descriptors(T(d1), T(d2), valid1=T(v1), valid2=T(v2),
                                  pair_valid=T(pair) if gated else None, **kw)
    np.testing.assert_array_equal(N(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(N(got.idx), np.asarray(want.idx))
    ok = np.asarray(want.valid)
    assert 20 < ok.sum() < len(ok)
    np.testing.assert_allclose(N(got.dist)[ok], np.asarray(want.dist)[ok], rtol=1e-3)
    assert np.isinf(N(got.dist)[~ok]).all() and (N(got.idx)[~ok] == -1).all()
    assert not N(got.valid)[20:24].any()


def test_match_descriptors_all_dead_and_max_dist():
    d1, d2, v1, v2, _ = _descriptor_sets(4)
    none = tdesc.match_descriptors(T(d1), T(d2), valid1=T(np.zeros_like(v1)), valid2=T(v2))
    assert not bool(none.valid.any()) and bool((none.idx == -1).all())
    want = jdesc.match_descriptors(jnp.asarray(d1), jnp.asarray(d2), max_dist=1.0)
    got = tdesc.match_descriptors(T(d1), T(d2), max_dist=1.0)
    np.testing.assert_array_equal(N(got.idx), np.asarray(want.idx))
    np.testing.assert_array_equal(N(tdesc.ratio_guard(T(np.array([1.0, np.inf], np.float32)))),
                                  [1.0, np.inf])


def test_match_descriptors_lane_equals_single():
    """A lane of a batch equals its unbatched call bit for bit (the product
    runs lane by lane, so no batched kernel can round it another way)."""
    sets = [_descriptor_sets(s, k1=256, k2=256, d=361) for s in (5, 6, 7)]
    stacked = [T(np.stack([s[i] for s in sets])) for i in range(5)]
    batch = tdesc.match_descriptors(stacked[0], stacked[1], valid1=stacked[2],
                                    valid2=stacked[3], pair_valid=stacked[4])
    for b, (d1, d2, v1, v2, pair) in enumerate(sets):
        one = tdesc.match_descriptors(T(d1), T(d2), valid1=T(v1), valid2=T(v2),
                                      pair_valid=T(pair))
        for got, want in zip(batch, one):
            np.testing.assert_array_equal(N(got[b]), N(want))


# ---------------------------------------------------------------------------
# ops/harris.py: subpixel refinement
# ---------------------------------------------------------------------------

def test_refine_corners_subpixel(frames):
    """Refined corners within 1e-3 px of the JAX package's for 99% of the
    points and within 5e-3 px for all (an edge-like window has a nearly
    singular 2x2 system that amplifies the last bit of its sums), from
    Harris detections, border points and a flat patch (no move); a batch of
    two images equals its lanes."""
    img = frames[0].copy()
    img[100:130, 40:70] = 77.0  # a flat window: degenerate system, no move
    det = jharris.detect_keypoints(jnp.asarray(img), 200, mode="harris", nms_radius=5,
                                   border=16, quality_level=2e-4)
    xy = np.asarray(det.xy)
    xy = np.concatenate([xy, [[0, 0], [319, 239], [1.5, 120.25], [55, 115]]]).astype(np.float32)
    want = np.asarray(jharris.refine_corners_subpixel(jnp.asarray(img), jnp.asarray(xy)))
    got = tharris.refine_corners_subpixel(T(img), T(xy))
    np.testing.assert_allclose(N(got), want, atol=5e-3)
    assert (np.abs(N(got) - want).max(axis=-1) <= 1e-3).mean() >= 0.99
    assert np.abs(N(got) - xy).max() <= 4.0 + 1e-6  # clamped to the radius
    assert 0.05 < np.abs(N(got)[:150] - xy[:150]).mean() < 1.5  # it does refine
    np.testing.assert_array_equal(N(got)[-1], xy[-1])
    got3 = tharris.refine_corners_subpixel(T(img), T(xy), radius=3, iters=3)
    want3 = np.asarray(jharris.refine_corners_subpixel(jnp.asarray(img), jnp.asarray(xy),
                                                       radius=3, iters=3))
    np.testing.assert_allclose(N(got3), want3, atol=5e-3)
    assert (np.abs(N(got3) - want3).max(axis=-1) <= 1e-3).mean() >= 0.99
    both = tharris.refine_corners_subpixel(T(np.stack([img, frames[1]])), T(np.stack([xy, xy])))
    np.testing.assert_array_equal(N(both[0]), N(got))
    np.testing.assert_array_equal(N(both[1]), N(tharris.refine_corners_subpixel(T(frames[1]), T(xy))))


# ---------------------------------------------------------------------------
# models/pipeline.py: the harris tracker
# ---------------------------------------------------------------------------

def _detections(frames, i):
    cfg, jcfg = VOConfig(capacity=CAPACITY, tracker="harris"), JaxConfig(
        capacity=CAPACITY, tracker="harris")
    return (tpipe._detect_mode(T(frames[i]), cfg),
            jpipe._detect_mode(jnp.asarray(frames[i]), jcfg))


def test_detect_mode_harris(frames):
    """Harris detections of the tracker: the same slots, positions 2e-3 px
    (refined), patch descriptors 1e-4."""
    dt, dj = _detections(frames, 0)
    np.testing.assert_array_equal(N(dt.valid), np.asarray(dj.valid))
    assert int(dt.valid.sum()) > 100
    np.testing.assert_allclose(N(dt.xy), np.asarray(dj.xy), atol=2e-3)
    np.testing.assert_allclose(N(dt.score), np.asarray(dj.score), rtol=1e-5)
    assert dt.desc.shape == (CAPACITY, 361)
    ok = np.asarray(dj.valid)
    np.testing.assert_allclose(N(dt.desc)[ok], np.asarray(dj.desc)[ok], atol=1e-4)
    np.testing.assert_array_equal(N(dt.sigma), 0.0)


@pytest.mark.parametrize("scaled", [False, True])
def test_match_track(frames, scaled):
    """_match_track on the same detections (the JAX package's, carried
    across): the same status, match index and consumed detections."""
    _, d0 = _detections(frames, 0)
    _, d1 = _detections(frames, 1)
    rng = np.random.default_rng(0)
    scale = rng.integers(1, 4, CAPACITY).astype(np.float32) if scaled else None
    live = np.asarray(d0.valid) & (rng.uniform(size=CAPACITY) > 0.1)
    jtr, jidx, jused = jpipe._match_track(
        d0.desc, d0.xy, jnp.asarray(live), d1, 0.85, 32.0,
        move_scale=None if scale is None else jnp.asarray(scale))
    det1 = tpipe.Detections(*(T(np.asarray(f)) for f in d1))
    ttr, tidx, tused = tpipe._match_track(
        T(np.asarray(d0.desc)), T(np.asarray(d0.xy)), T(live), det1, 0.85, 32.0,
        move_scale=None if scale is None else T(scale))
    np.testing.assert_array_equal(N(ttr.status), np.asarray(jtr.status))
    assert int(ttr.status.sum()) > 50
    np.testing.assert_array_equal(N(tidx), np.asarray(jidx))
    np.testing.assert_array_equal(N(tused), np.asarray(jused))
    np.testing.assert_array_equal(N(ttr.xy), np.asarray(jtr.xy))
    ok = np.asarray(jtr.status)
    np.testing.assert_allclose(N(ttr.err)[ok], np.asarray(jtr.err)[ok], rtol=1e-3)
    assert np.isinf(N(ttr.err)[~ok]).all()
    if not scaled:
        # Lanes: lane 0 of a batch of two equals the unbatched call.
        d0t = T(np.asarray(d0.desc))[None].repeat(2, 1, 1)
        xy0 = T(np.asarray(d0.xy))[None].repeat(2, 1, 1)
        det2 = tpipe.Detections(*(f[None].expand((2,) + f.shape) for f in det1))
        btr, bidx, bused = tpipe._match_track(d0t, xy0, T(np.stack([live, ~live])), det2,
                                              0.85, 32.0)
        np.testing.assert_array_equal(N(btr.status[0]), N(ttr.status))
        np.testing.assert_array_equal(N(bidx[0]), N(tidx))
        np.testing.assert_array_equal(N(bused[0]), N(tused))


@pytest.fixture(scope="module")
def jax_harris_run(frames):
    """The JAX pipeline in harris mode over the first frames."""
    cfg = JaxConfig(capacity=CAPACITY, tracker="harris")
    K = jnp.asarray(SPEC.K())
    key = jax.random.PRNGKey(1)
    state, out = jpipe.bootstrap(jnp.asarray(frames[0]), jnp.asarray(frames[2]), K, cfg, key)
    states, outs = {2: state}, {2: out}
    for i in range(3, 6):
        state, out = jpipe.vo_step(state, jnp.asarray(frames[i]), K, cfg)
        states[i], outs[i] = state, out
    return key, states, outs


def _replay(keys):
    keys = list(keys)

    def sampler(h, n, s, valid):
        v = None if valid is None else jnp.asarray(valid.numpy())
        return np.asarray(jransac.sample_indices(keys.pop(0), h, n, s, v))

    return sampler


def _assert_table_matches(tt, jt):
    np.testing.assert_array_equal(N(tt.state), np.asarray(jt.state))
    np.testing.assert_array_equal(N(tt.uid), np.asarray(jt.uid))
    np.testing.assert_array_equal(N(tt.miss), np.asarray(jt.miss))
    live = np.asarray(jt.state) >= 0
    np.testing.assert_allclose(N(tt.xy)[live], np.asarray(jt.xy)[live], atol=2e-3)
    np.testing.assert_allclose(N(tt.desc)[live], np.asarray(jt.desc)[live], atol=1e-3)
    tri = np.asarray(jt.state) == 2
    np.testing.assert_allclose(N(tt.landmark)[tri], np.asarray(jt.landmark)[tri],
                               rtol=1e-2, atol=1e-2)


def test_harris_bootstrap_from_the_same_draws(frames, jax_harris_run):
    """bootstrap(tracker="harris") with the JAX package's RANSAC draws: the
    same masks and counts, the pose to 1e-3."""
    key, states, outs = jax_harris_run
    _, _, k_ransac = jax.random.split(key, 3)
    cfg = VOConfig(capacity=CAPACITY, tracker="harris")
    st, out = tpipe.bootstrap(T(frames[0]), T(frames[2]), T(SPEC.K()), cfg, _replay([k_ransac]))
    want = outs[2]
    assert bool(out.pose_ok) and bool(want.pose_ok)
    for name in ("num_tracked", "num_triangulated", "num_candidates", "num_pnp_inliers"):
        assert int(getattr(out, name)) == int(getattr(want, name)), name
    np.testing.assert_allclose(N(out.pose), np.asarray(want.pose), atol=1e-3)
    _assert_table_matches(st.table, states[2].table)
    assert len(st.pyramid) == 1 and st.pyramid[0].shape == (240, 320)
    assert st.table.desc.shape == (CAPACITY, 361)


@pytest.mark.parametrize("frame", [3, 4])
def test_harris_step_from_a_jax_state(frames, jax_harris_run, frame):
    """One vo_step(tracker="harris") from the JAX state of the previous
    frame with the JAX step's own draws: the same masks and counts, the
    pose to 1e-3. Frame 4 also pushes a keyframe and runs BA."""
    _, states, outs = jax_harris_run
    prev = states[frame - 1]
    _, k_pnp, k_rec = jax.random.split(prev.rng, 3)
    st = tpipe.state_from_numpy(prev, "cpu", _replay([k_pnp]), _replay([k_rec]))
    cfg = VOConfig(capacity=CAPACITY, tracker="harris")
    st, out = tpipe.vo_step(st, T(frames[frame]), T(SPEC.K()), cfg)
    want, jst = outs[frame], states[frame]
    assert bool(out.pose_ok) == bool(want.pose_ok) is True
    assert int(st.last_kf_idx) == int(jst.last_kf_idx)
    np.testing.assert_allclose(N(out.pose), np.asarray(want.pose), atol=1e-3)
    for name in ("num_tracked", "num_candidates"):
        assert int(getattr(out, name)) == int(getattr(want, name)), name
    for name in ("num_pnp_inliers", "num_triangulated", "num_new_landmarks"):
        assert abs(int(getattr(out, name)) - int(getattr(want, name))) <= 1, name
    assert int(st.next_uid) == int(jst.next_uid)
    _assert_table_matches(st.table, jst.table)
    np.testing.assert_array_equal(N(st.window.kf_valid), np.asarray(jst.window.kf_valid))


def test_two_harris_lanes_equal_two_single_runs(frames):
    """A batch of two harris lanes through batched_vo_rollout equals the two
    single rollouts bit for bit (at capacity 256, as tests/test_torch_multiseq.py
    holds the KLT lanes)."""
    cfg = VOConfig(capacity=256, tracker="harris")
    K = T(SPEC.K())
    clips = [T(frames[:6]), T(frames[1:7])]

    def boot(i):
        return tpipe.bootstrap(clips[i][0], clips[i][2], K, cfg,
                               torch.Generator().manual_seed(10 + i))[0]

    singles = [tpipe.vo_rollout(boot(i), clips[i][3:], K, cfg) for i in range(2)]
    states, outs = batched_vo_rollout(
        stack_states([boot(0), boot(1)]), torch.stack([c[3:] for c in clips], dim=1),
        torch.stack([K, K]), cfg)
    assert outs.pose.shape == (3, 2, 4, 4) and bool(outs.pose_ok.all())
    for b, (st, out) in enumerate(singles):
        for name in out._fields:
            np.testing.assert_array_equal(N(getattr(outs, name)[:, b]), N(getattr(out, name)),
                                          err_msg=name)
        for name in st.table._fields:
            np.testing.assert_array_equal(N(getattr(states.table, name)[b]),
                                          N(getattr(st.table, name)), err_msg=name)


def test_miss_grace_keeps_slots_coasting(frames):
    """With max_miss > 0 a slot that finds no match survives as a coasting
    slot (miss counted, state kept); with 0 it is emptied at once."""
    K = T(SPEC.K())
    base = VOConfig(capacity=CAPACITY, tracker="harris")
    st0, _ = tpipe.bootstrap(T(frames[0]), T(frames[2]), K, base, torch.Generator().manual_seed(3))
    grace = base.replace(descriptor=dataclasses.replace(base.descriptor, max_miss=2))
    blank = torch.full((240, 320), 128.0)  # nothing to detect: every slot misses
    s_grace, o_grace = tpipe.vo_step(st0, blank, K, grace)
    s_none, o_none = tpipe.vo_step(st0, blank, K, base)
    occupied = N(st0.table.state) >= 0
    assert int(o_grace.num_tracked) == int(o_none.num_tracked) == 0
    np.testing.assert_array_equal(N(s_grace.table.state)[occupied], N(st0.table.state)[occupied])
    assert (N(s_grace.table.miss)[occupied] == 1).all()
    assert (N(s_none.table.state) == -1).all()
    assert not bool(o_grace.pose_ok) and not bool(o_grace.frozen)


@pytest.mark.slow
def test_harris_seed_scatter_is_shared_with_jax(frames):
    """The harris tracker's end-to-end ATE follows the RANSAC draw in both
    packages: 300 frames of the city at 320x240 (below the size the mode is
    tuned for, so it scatters widely), three seeds each. The port's readings
    lie inside the band the JAX package's own span, widened by a factor of
    two each way; the readings are printed (run with -s)."""
    from vo_tpu_torch.data.evaluate import ate_rmse, positions_from_poses

    n = 300
    seq = tsyn.render_sequence(SPEC, torch.device("cpu"), n)
    gt = seq.gt_poses[[0, 2] + list(range(3, n))]
    cfg, jcfg = VOConfig(capacity=512, tracker="harris"), JaxConfig(capacity=512,
                                                                    tracker="harris")
    K, jframes = jnp.asarray(N(seq.K)), jnp.asarray(N(seq.frames))
    port, ref = [], []
    for seed in (0, 1, 2):
        st, o = tpipe.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                                torch.Generator().manual_seed(seed))
        _, outs = tpipe.vo_rollout(st, seq.frames[3:], seq.K, cfg)
        est = np.concatenate([np.eye(4)[None], N(o.pose)[None], N(outs.pose)])
        port.append((ate_rmse(positions_from_poses(est), positions_from_poses(gt)),
                     int(outs.pose_ok.sum())))
        js, jo = jpipe.bootstrap(jframes[0], jframes[2], K, jcfg, jax.random.PRNGKey(seed))
        _, jouts = jpipe.vo_rollout(js, jframes[3:], K, jcfg)
        est = np.concatenate([np.eye(4)[None], np.asarray(jo.pose)[None],
                              np.asarray(jouts.pose)])
        ref.append((ate_rmse(positions_from_poses(est), positions_from_poses(gt)),
                    int(np.asarray(jouts.pose_ok).sum())))
    print("harris 320x240, 300 frames, (ATE m, pose_ok of 297): port", port, "jax", ref)
    assert np.isfinite([a for a, _ in port + ref]).all()
    lo, hi = min(a for a, _ in ref) / 2.0, max(a for a, _ in ref) * 2.0
    assert all(lo <= a <= hi for a, _ in port), (port, ref)
