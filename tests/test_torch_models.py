"""Parity of the port's models against the JAX package on shared numpy
inputs: the fixed-capacity feature table (exact) and windowed bundle
adjustment (poses 1e-4)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vo_tpu.models import ba as jba
from vo_tpu.models import feature_table as jft

from vo_tpu_torch.models import ba as tba
from vo_tpu_torch.models import feature_table as tft

# Several pytest-xdist workers share the cores: PyTorch's intra-op thread
# pool over the port's many tiny CPU ops would only contend with them.
torch.set_num_threads(1)

K_CAM = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tables(rng, k=64):
    """The same random table in both packages."""
    lanes = dict(
        xy=rng.uniform(0, 300, (k, 2)).astype(np.float32),
        landmark=rng.normal(0, 5, (k, 3)).astype(np.float32),
        state=rng.integers(-1, 3, k).astype(np.int32),
        track_xy=rng.uniform(0, 300, (k, 2)).astype(np.float32),
        track_pose=np.tile(np.eye(4, dtype=np.float32).reshape(1, 16), (k, 1)),
        uid=rng.permutation(1000)[:k].astype(np.int32),
        score=rng.uniform(size=k).astype(np.float32),
        desc=np.zeros((k, 1), np.float32),
        sigma=np.zeros(k, np.float32),
        miss=np.zeros(k, np.int32),
    )
    jt = jft.FeatureTable(**{n: jnp.asarray(v) for n, v in lanes.items()})
    tt = tft.FeatureTable(**{n: torch.from_numpy(v.copy()) for n, v in lanes.items()})
    return jt, tt


def _assert_tables_equal(tt, jt):
    for name in jft.FeatureTable._fields:
        np.testing.assert_array_equal(N(getattr(tt, name)), N(getattr(jt, name)), err_msg=name)


@pytest.mark.parametrize("n_det", [5, 40, 64])
def test_fill_free_slots_exact(rng, n_det):
    jt, tt = _tables(rng)
    det_xy = rng.uniform(0, 300, (n_det, 2)).astype(np.float32)
    det_score = rng.uniform(size=n_det).astype(np.float32)
    det_ok = rng.uniform(size=n_det) > 0.3
    pose = (np.eye(4, dtype=np.float32) * 2.0).reshape(16)
    j2, juid = jft.fill_free_slots(jt, jnp.asarray(det_xy), jnp.asarray(det_score),
                                   jnp.asarray(det_ok), jnp.asarray(pose), jnp.int32(1000))
    t2, tuid = tft.fill_free_slots(tt, torch.from_numpy(det_xy), torch.from_numpy(det_score),
                                   torch.from_numpy(det_ok), torch.from_numpy(pose),
                                   torch.tensor(1000, dtype=torch.int32))
    _assert_tables_equal(t2, j2)
    assert int(tuid) == int(juid)
    assert tft.debug_validate(t2) == jft.debug_validate(j2)


def test_restart_tracks_exact(rng):
    jt, tt = _tables(rng)
    mask = rng.uniform(size=64) > 0.5
    pose = rng.normal(size=16).astype(np.float32)
    j2 = jft.restart_tracks(jt, jnp.asarray(mask), jnp.asarray(pose))
    t2 = tft.restart_tracks(tt, torch.from_numpy(mask), torch.from_numpy(pose))
    _assert_tables_equal(t2, j2)


def test_empty_table_and_validate():
    _assert_tables_equal(tft.empty_table(16, 3), jft.empty_table(16, 3))
    bad = tft.empty_table(4)._replace(state=torch.tensor([0, 0, 2, 7], dtype=torch.int32))
    assert any("state outside" in e for e in tft.debug_validate(bad))


# ---------------------------------------------------------------------------
# Windowed bundle adjustment
# ---------------------------------------------------------------------------

def _world(rng, W=6, L=200):
    pts = np.stack([rng.uniform(-8, 8, L), rng.uniform(-4, 4, L),
                    rng.uniform(12, 40, L)], -1).astype(np.float32)
    poses = []
    for i in range(W):
        a = 0.02 * i
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        T[:3, 3] = [0.1 * i, 0.0, 0.8 * i]
        poses.append(T)
    return np.stack(poses), pts


def _window_arrays(rng, poses, pts, noise=0.5):
    W, L = len(poses), len(pts)
    obs_uv = np.zeros((L, W, 2), np.float32)
    obs_mask = np.zeros((L, W), bool)
    for w in range(W):
        T_cw = np.linalg.inv(poses[w])
        xc = pts @ T_cw[:3, :3].T + T_cw[:3, 3]
        uv = (xc @ K_CAM.T)[:, :2] / xc[:, 2:] + rng.normal(0, noise, (L, 2))
        inside = (xc[:, 2] > 1) & (uv[:, 0] > 0) & (uv[:, 0] < 640) \
            & (uv[:, 1] > 0) & (uv[:, 1] < 480) & (rng.uniform(size=L) > 0.1)
        obs_uv[:, w] = np.where(inside[:, None], uv, 0.0)
        obs_mask[:, w] = inside
    init = poses.copy()
    for w in range(1, W):
        init[w, :3, 3] += rng.normal(0, 0.05, 3)
    return dict(
        kf_pose=init.reshape(W, 16).astype(np.float32),
        kf_valid=np.ones(W, bool),
        obs_uv=obs_uv,
        obs_mask=obs_mask,
        landmark=(pts + rng.normal(0, 0.1, pts.shape)).astype(np.float32),
        lm_uid=np.arange(L, dtype=np.int32),
        lm_valid=obs_mask.sum(axis=1) >= 2,
    )


@pytest.mark.parametrize("dead_oldest", [False, True])
def test_ba_refine(rng, dead_oldest):
    poses, pts = _world(rng)
    arrs = _window_arrays(rng, poses, pts)
    arrs["kf_valid"][0] = not dead_oldest
    jw = jba.BAWindow(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tw = tba.BAWindow(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()})
    jout, jerr = jba.ba_refine(jw, jnp.asarray(K_CAM))
    tout, terr = tba.ba_refine(tw, torch.from_numpy(K_CAM))
    assert float(jerr[-1]) < float(jerr[0])  # the refinement did real work
    # Error trace: 1e-4 relative, 2e-3 where the scale is free to drift
    # (see below; it moves the first GN step's error by ~0.1%).
    np.testing.assert_allclose(N(terr), N(jerr), rtol=2e-3 if dead_oldest else 1e-4)
    # Valid keyframes' poses 1e-4 (f32 Schur sums in another order).
    valid = arrs["kf_valid"]
    np.testing.assert_allclose(N(tout.kf_pose)[valid], N(jout.kf_pose)[valid], atol=1e-4)
    # Landmarks 1e-3 relative. With a dead oldest keyframe the gauge pair is
    # younger and the free monocular scale drifts ~0.3% apart over the GN
    # steps; fix_scale maps the keyframes back onto one scale, while
    # landmarks and the dead keyframe (never refined, never read) keep that
    # residual: landmarks 5e-3 relative there, the dead pose unchecked.
    np.testing.assert_allclose(N(tout.landmark), N(jout.landmark),
                               rtol=5e-3 if dead_oldest else 1e-3, atol=1e-3)


def test_push_keyframe_exact(rng):
    poses, pts = _world(rng)
    arrs = _window_arrays(rng, poses, pts)
    jw = jba.BAWindow(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tw = tba.BAWindow(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()})
    L = len(pts)
    slot_xy = rng.uniform(0, 640, (L, 2)).astype(np.float32)
    slot_uid = np.where(rng.uniform(size=L) > 0.2, np.arange(L), -5).astype(np.int32)
    tri = rng.uniform(size=L) > 0.3
    pose = poses[-1]
    j2 = jba.push_keyframe(jw, jnp.asarray(pose), jnp.asarray(slot_xy), jnp.asarray(pts),
                           jnp.asarray(slot_uid), jnp.asarray(tri))
    t2 = tba.push_keyframe(tw, torch.from_numpy(pose), torch.from_numpy(slot_xy),
                           torch.from_numpy(pts), torch.from_numpy(slot_uid),
                           torch.from_numpy(tri))
    for name in jba.BAWindow._fields:
        np.testing.assert_array_equal(N(getattr(t2, name)), N(getattr(j2, name)),
                                      err_msg=name)
