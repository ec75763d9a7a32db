"""The whole slice against the JAX package: the on-device renderer, one
`vo_step` from a JAX state carried across with replayed RANSAC draws, and a
short run of both pipelines on the random-dot world of test_pipeline.py."""

import dataclasses

import numpy as np
import pytest
import scipy.ndimage
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from vo_tpu.data.synthetic import PathSpec, SyntheticSpec, generate
from vo_tpu.models import pipeline as jpipe
from vo_tpu.ops import ransac as jransac
from vo_tpu.utils.config import VOConfig as JaxConfig

from vo_tpu_torch.data import synthetic as tsyn
from vo_tpu_torch.data.evaluate import ate_rmse, positions_from_poses
from vo_tpu_torch.models import pipeline as tpipe
from vo_tpu_torch.utils.config import VOConfig

# Several pytest-xdist workers share the cores: PyTorch's intra-op thread
# pool over the port's many tiny CPU ops would only contend with them.
torch.set_num_threads(1)

H, W, N_FRAMES, CAPACITY = 240, 320, 12, 384
K_DOTS = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)

TINY = SyntheticSpec(
    num_frames=8,
    width=160,
    height=120,
    focal=130.0,
    path=PathSpec(segments=(("straight", 30.0), ("turn", 90.0, 6.0), ("straight", 20.0))),
)


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def render_dots(K, T_cw, pts, h, w, rng):
    """Gaussian blobs at projected 3D points (as tests/test_pipeline.py)."""
    Xc = pts @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = Xc[:, 2]
    uv = Xc @ K.T
    uv = uv[:, :2] / uv[:, 2:]
    img = np.zeros((h, w), np.float32)
    ok = (z > 1.0) & (uv[:, 0] > 2) & (uv[:, 0] < w - 3) & (uv[:, 1] > 2) & (uv[:, 1] < h - 3)
    ij = np.round(uv[ok]).astype(int)
    np.add.at(img, (ij[:, 1], ij[:, 0]), 200.0 + 55.0 * np.cos(np.arange(ok.sum())))
    img = scipy.ndimage.gaussian_filter(img, 1.2)
    img += rng.normal(0, 0.5, img.shape)
    return np.clip(img * 4.0, 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def dot_world():
    rng = np.random.default_rng(2023)
    pts = rng.uniform([-25, -15, 2], [25, 15, 60], (4000, 3)).astype(np.float32)
    gt = []
    for i in range(N_FRAMES):
        yaw = 0.015 * i
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]]
        pose[:3, 3] = [0.1 * i, 0.0, 0.55 * i]
        gt.append(pose)
    imgs = [render_dots(K_DOTS, np.linalg.inv(p), pts, H, W, rng) for p in gt]
    return np.stack(imgs), np.stack(gt)


@pytest.fixture(scope="module")
def jax_run(dot_world):
    """The JAX pipeline over the dot world: every state and output."""
    imgs, _ = dot_world
    cfg = JaxConfig(capacity=CAPACITY)
    K = jnp.asarray(K_DOTS)
    state, out = jpipe.bootstrap(jnp.asarray(imgs[0]), jnp.asarray(imgs[2]), K, cfg,
                                 jax.random.PRNGKey(1))
    states, outs = {2: state}, {2: out}
    for i in range(3, N_FRAMES):
        state, out = jpipe.vo_step(state, jnp.asarray(imgs[i]), K, cfg)
        states[i], outs[i] = state, out
    return states, outs


def _replay(keys):
    """A port sampler that hands out the JAX package's draws for `keys`, one
    key per RANSAC call, in call order."""
    keys = list(keys)

    def sampler(h, n, s, valid):
        key = keys.pop(0)
        v = None if valid is None else jnp.asarray(valid.numpy())
        return np.asarray(jransac.sample_indices(key, h, n, s, v))

    return sampler


def _ate(poses: dict, gt) -> float:
    idx = sorted(poses)
    return ate_rmse(positions_from_poses(np.stack([poses[i] for i in idx])),
                    positions_from_poses(gt[idx]))


def test_renderer_matches_numpy_reference():
    rects = tsyn.build_city(TINY.path, TINY.seed)
    tex = tsyn.make_texture(TINY.seed + 1, size=256, levels=4)
    poses = tsyn.make_path(TINY.path, 40)
    K = TINY.K()
    idx = [0, 20, 39]
    got = N(tsyn.render_frames_torch(rects, tex, poses[idx], K, TINY.width, TINY.height))
    ref = np.stack([tsyn.render_frame(rects, tex, poses[i], K, TINY.width, TINY.height)
                    for i in idx])
    assert got.dtype == np.uint8 and got.shape == ref.shape
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 2, f"max diff {d.max()}"  # the reference's own bound
    assert ref.std(axis=(1, 2)).min() > 10.0


def test_headline_sequence_matches_reference_generate(tmp_path, monkeypatch):
    """The device sequence against the reference's `generate` (JAX renderer,
    written to disk) for a shortened TINY headline: same scene layout, GT
    poses and K; frames within the renderer's 2-grey-level bound."""
    monkeypatch.setattr(tsyn, "DEFAULT_SPEC", TINY)
    seq = tsyn.headline_sequence(torch.device("cpu"), 4)
    spec = dataclasses.replace(TINY, num_frames=4)
    assert seq.spec == spec
    assert seq.frames.shape == (4, 120, 160) and seq.frames.dtype == torch.float32
    out = generate(str(tmp_path), spec, verbose=False)
    ref = np.stack([np.asarray(Image.open(f"{out}/images/img_{i:05d}.png"))
                    for i in range(4)]).astype(np.float32)
    assert np.abs(N(seq.frames) - ref).max() <= 2
    np.testing.assert_allclose(N(seq.K), np.loadtxt(f"{out}/K.txt"), rtol=1e-6)
    gt = np.loadtxt(f"{out}/poses.txt").reshape(4, 3, 4)
    np.testing.assert_allclose(seq.gt_poses[:, :3, :4], gt, atol=1e-6)


@pytest.mark.parametrize("frame,adaptive", [(3, False), (4, False), (3, True)])
def test_one_step_from_a_jax_state(dot_world, jax_run, frame, adaptive):
    """One vo_step from the JAX state of the previous frame, carried across
    by state_from_numpy, with the JAX step's own RANSAC draws replayed.
    Frame 3 runs PnP; frame 4 also pushes a keyframe and runs BA. The
    adaptive case switches the state's keyframe policy to the motion-gated
    one, with the newest keyframe 10 frames back so that it pushes."""
    imgs, _ = dot_world
    states, outs = jax_run
    prev = states[frame - 1]
    if adaptive:
        prev = prev._replace(kf_adaptive=jnp.asarray(True),
                             last_kf_idx=jnp.asarray(frame - 11, jnp.int32))
    _, k_pnp, k_rec = jax.random.split(prev.rng, 3)
    st = tpipe.state_from_numpy(prev, "cpu", _replay([k_pnp]), _replay([k_rec]))
    st, out = tpipe.vo_step(st, torch.from_numpy(imgs[frame]), torch.from_numpy(K_DOTS),
                            VOConfig(capacity=CAPACITY))
    if adaptive:
        jst, want = jpipe.vo_step(prev, jnp.asarray(imgs[frame]), jnp.asarray(K_DOTS),
                                  JaxConfig(capacity=CAPACITY))
        assert int(jst.last_kf_idx) == frame  # the motion gate pushed
    else:
        want, jst = outs[frame], states[frame]
    assert int(st.last_kf_idx) == int(jst.last_kf_idx)
    assert bool(out.pose_ok) == bool(want.pose_ok)
    # Pose 1e-4 (f32 LK/GN/BA sums in another order).
    np.testing.assert_allclose(N(out.pose), N(want.pose), atol=1e-4)
    for name in ("num_tracked", "num_pnp_inliers", "num_triangulated", "num_new_landmarks"):
        assert abs(int(getattr(out, name)) - int(getattr(want, name))) <= 1, name
    # The table: lifecycle states and uids exact, positions 1e-3 px,
    # landmarks 1e-3 relative.
    np.testing.assert_array_equal(N(st.table.state), N(jst.table.state))
    np.testing.assert_array_equal(N(st.table.uid), N(jst.table.uid))
    assert int(st.next_uid) == int(jst.next_uid)
    live = N(jst.table.state) >= 0
    np.testing.assert_allclose(N(st.table.xy)[live], N(jst.table.xy)[live], atol=1e-3)
    tri = N(jst.table.state) == 2
    np.testing.assert_allclose(N(st.table.landmark)[tri], N(jst.table.landmark)[tri],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(N(st.window.kf_valid), N(jst.window.kf_valid))


def test_the_recovery_from_a_jax_state():
    """Frame 3 of the city at 160x120 with PnP's bar out of reach, so that
    both packages fall back to the recovery (8-point RANSAC -> E ->
    cheirality) and take it. The port's recovery draws from its own stream,
    here the JAX step's `k_rec` replayed (PnP from its sibling `k_pnp`):
    the JAX package's pose at the tolerances of
    test_one_step_from_a_jax_state. (On the dot world the 8-point refit is
    too ill-conditioned for those tolerances: F moves by 0.08 between the
    two LAPACKs on the same tracks.)"""
    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, width=160, height=120, focal=104.0)
    seq = tsyn.render_sequence(spec, "cpu", 4)
    imgs, K = N(seq.frames), N(seq.K)
    jcfg = JaxConfig(capacity=128)
    jcfg = dataclasses.replace(jcfg, pnp=dataclasses.replace(jcfg.pnp, min_inliers=10**6))
    cfg = VOConfig(capacity=128)
    cfg = dataclasses.replace(cfg, pnp=dataclasses.replace(cfg.pnp, min_inliers=10**6))
    prev, _ = jpipe.bootstrap(jnp.asarray(imgs[0]), jnp.asarray(imgs[2]), jnp.asarray(K),
                              jcfg, jax.random.PRNGKey(1))
    jst, want = jpipe.vo_step(prev, jnp.asarray(imgs[3]), jnp.asarray(K), jcfg)
    _, k_pnp, k_rec = jax.random.split(prev.rng, 3)
    st = tpipe.state_from_numpy(prev, "cpu", _replay([k_pnp]), _replay([k_rec]))
    st, out = tpipe.vo_step(st, torch.from_numpy(imgs[3]), torch.from_numpy(K), cfg)
    assert not bool(out.pose_ok) and not bool(want.pose_ok)
    # The recovery ran and was taken: the pose is not the constant-velocity
    # guess's.
    cv = N(prev.pose) @ (np.linalg.inv(N(prev.prev_pose)) @ N(prev.pose))
    assert np.abs(N(want.pose) - cv).max() > 0.1
    np.testing.assert_allclose(N(out.pose), N(want.pose), atol=1e-4)
    assert int(out.num_tracked) == int(want.num_tracked)
    np.testing.assert_array_equal(N(st.table.state), N(jst.table.state))
    np.testing.assert_array_equal(N(st.table.uid), N(jst.table.uid))


def test_state_numpy_roundtrip(jax_run):
    states, _ = jax_run
    st = tpipe.state_from_numpy(states[4], "cpu", torch.Generator())
    back = tpipe.state_to_numpy(st)
    again = tpipe.state_to_numpy(tpipe.state_from_numpy(back, "cpu", torch.Generator()))
    for name in ("pose", "last_speed", "frame_idx"):
        np.testing.assert_array_equal(back[name], N(getattr(states[4], name)))
        np.testing.assert_array_equal(again[name], back[name])
    for name in jpipe.FeatureTable._fields:
        np.testing.assert_array_equal(again["table"][name], N(getattr(states[4].table, name)))
    assert back["table"]["state"].dtype == np.int32
    assert len(back["pyramid"]) == len(states[4].pyramid)


def test_dot_world_both_pipelines_track(dot_world, jax_run):
    """A short run of each pipeline on its own random draws: both localize
    every frame and stay within 0.1 m ATE (~6.3 m trajectory, Sim3-aligned)."""
    imgs, gt = dot_world
    states, outs = jax_run
    jposes = {0: np.eye(4, dtype=np.float32)}
    jposes.update({i: N(o.pose) for i, o in outs.items()})
    assert all(bool(o.pose_ok) for o in outs.values())
    assert _ate(jposes, gt) < 0.1

    cfg = VOConfig(capacity=CAPACITY)
    K = torch.from_numpy(K_DOTS)
    frames = torch.from_numpy(imgs)
    st, out = tpipe.bootstrap(frames[0], frames[2], K, cfg, torch.Generator().manual_seed(1))
    assert bool(out.pose_ok)
    st, outs_t = tpipe.vo_rollout(st, frames[3:], K, cfg)
    assert outs_t.pose.shape == (N_FRAMES - 3, 4, 4)
    assert bool(outs_t.pose_ok.all()) and not bool(outs_t.frozen.any())
    tposes = {0: np.eye(4, dtype=np.float32), 2: N(out.pose)}
    tposes.update({i + 3: p for i, p in enumerate(N(outs_t.pose))})
    assert _ate(tposes, gt) < 0.1
    from vo_tpu_torch.models.feature_table import debug_validate

    assert debug_validate(st.table) == []
