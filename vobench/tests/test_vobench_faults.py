"""The comparison must catch a broken timed path: each run below skips
the look for a card and drives the rest of a run on the CPU at a small
size, with the program broken underneath, and `correct` must come out
false. The control (the reference in the program's place, in bfloat16)
must fail too. A sound run at the same size is the baseline."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vobench import check, harness, run
from vobench.tests.conftest import tiny_cell

REAL_ROLLOUT = harness.rollout
# At 320x240 one whole pass of 69 frames fits in the window on the CPU.
# Sound runs there read seg_err_med_m 0.015-0.020 m, seg_err_p95_m
# 0.057-0.066 m, lk_gap_px 2.6e-5, k1_gap 2.7e-7 and k1_nms_gap 0; the
# control 0.013, 0.060-0.075, 0.94, 0.061 and 4.7. The limits below sit
# between, as the full-size cell's do between its own readings.
LIMITS = {"nonfinite_poses": 0.0, "seg_err_med_m": 0.05, "seg_err_p95_m": 0.2,
          "lk_gap_px": 0.01, "k1_gap": 1e-3, "k1_nms_gap": 1e-3}
SIZE = dict(frames=72, width=320, height=240, capacity=256, limits=LIMITS)
SECONDS = 12.0
SEED = 4_000_000_001


@pytest.fixture(autouse=True)
def frame_cache(tmp_path_factory, monkeypatch):
    """One render of the small city for every run of this module."""
    monkeypatch.setattr(run, "FRAMES", tmp_path_factory.getbasetemp() / "frames")


def _run(cell, monkeypatch=None, broken=None) -> dict:
    if broken is not None:
        monkeypatch.setattr(harness, "rollout", broken)
    return run.run(cell, SEED, SECONDS, False, "cpu", log=lambda s: None)


def unchanged(mp):
    """A step that returns its state unchanged: every frame keeps the
    incoming pose, the table does not move."""
    def rollout(state, images, setup):
        _, outs = REAL_ROLLOUT(state, images, setup)
        frozen = state.pose.expand((images.shape[0],) + state.pose.shape).clone()
        return state, outs._replace(pose=frozen)
    return rollout


def every_4th_pose_held(mp):
    """A step that skips a few frames in twenty: every 4th frame's pose is
    its predecessor's, the rest as the program gave them."""
    def rollout(state, images, setup):
        final, outs = REAL_ROLLOUT(state, images, setup)
        pose = outs.pose.clone()
        prev = state.pose
        for i in range(pose.shape[0]):
            frame = int(state.frame_idx) + 1 + i
            if frame % 4 == 0:
                pose[i] = prev
            prev = pose[i]
        return final, outs._replace(pose=pose)
    return rollout


def one_chunk_not_finite(mp):
    """One chunk of one pass gives poses that are not finite; every other
    chunk is sound."""
    calls = [0]

    def rollout(state, images, setup):
        final, outs = REAL_ROLLOUT(state, images, setup)
        calls[0] += 1
        if calls[0] == 3:  # the first is the warm-up's
            outs = outs._replace(pose=torch.full_like(outs.pose, float("nan")))
        return final, outs
    return rollout


def k1_answer_altered(mp):
    """An answer altered where it is produced: K1's response map, the
    kernel's output, one part in a hundred high on every frame."""
    from vo_tpu_torch.ops import kernels

    real = kernels.corner_response_nms
    mp.setattr(kernels, "corner_response_nms", lambda *a, **k: real(*a, **k) * 1.01)
    return REAL_ROLLOUT


def k1_suppression_left_out(mp):
    """K1 returns the response at every pixel, not at the local maxima of
    its suppression window alone."""
    from vo_tpu_torch.ops import harris, kernels

    def unsuppressed(img, mode="shi_tomasi", patch_size=7, kappa=0.08, nms_radius=5,
                     use_kernel=None):
        return harris.shi_tomasi_response(img.to(torch.float32), patch_size)

    mp.setattr(kernels, "corner_response_nms", unsuppressed)
    return REAL_ROLLOUT


def k2_gathers_a_pixel_off(mp):
    """K2 gathers every search patch one pixel right of where it was asked
    to."""
    from vo_tpu_torch.ops import klt

    real = klt.extract_patch_pairs

    def shifted(prev, nxt, tcorner, scorner, *a, **k):
        one = torch.tensor([1, 0], dtype=scorner.dtype, device=scorner.device)
        return real(prev, nxt, tcorner, scorner + one, *a, **k)

    mp.setattr(klt, "extract_patch_pairs", shifted)
    return REAL_ROLLOUT


def half_the_lanes(mp):
    """Half of the batch left out: lanes from B/2 on keep their state and
    pose, as if the step never ran them."""
    def rollout(state, images, setup):
        final, outs = REAL_ROLLOUT(state, images, setup)
        h = setup.n_lanes // 2

        def keep(new, old):
            return torch.cat([new[:h], old[h:]]) if torch.is_tensor(new) else new

        table = type(final.table)(*(keep(a, b) for a, b in zip(final.table, state.table)))
        pose = outs.pose.clone()
        pose[:, h:] = state.pose[h:]
        return final._replace(table=table, pose=keep(final.pose, state.pose)), outs._replace(
            pose=pose)
    return rollout


@pytest.fixture(scope="module")
def sound_city(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(run, "FRAMES", tmp_path_factory.getbasetemp() / "frames")
    try:
        return _run(tiny_cell("city640", "offline", **SIZE))
    finally:
        mp.undo()


def test_a_sound_run_is_correct(sound_city):
    assert sound_city["correct"] is True, sound_city["checks"]
    assert sound_city["attempted"] > 0 and sound_city["failed"] == 0


@pytest.mark.parametrize("fault, worse", [
    (unchanged, ("seg_err_med_m", "lk_gap_px")),
    (every_4th_pose_held, ("seg_err_p95_m",)),
    (one_chunk_not_finite, ("nonfinite_poses",)),
    (k1_answer_altered, ("k1_gap",)),
    (k1_suppression_left_out, ("k1_nms_gap",)),
    (k2_gathers_a_pixel_off, ("lk_gap_px",)),
], ids=lambda f: getattr(f, "__name__", ""))
def test_a_broken_step_is_not_correct(monkeypatch, sound_city, fault, worse):
    got = _run(tiny_cell("city640", "offline", **SIZE), monkeypatch, fault(monkeypatch))
    assert got["correct"] is False
    for name in worse:
        v, ok = got["checks"][name]["value"], sound_city["checks"][name]["value"]
        assert v is None or v > max(got["checks"][name]["limit"], 3 * ok), (name, v, ok)


def test_half_the_lanes_left_out_is_not_correct(monkeypatch):
    cell = tiny_cell("city640", "batch6", **SIZE, copies=2)
    assert _run(cell)["correct"] is True
    got = _run(cell, monkeypatch, half_the_lanes(monkeypatch))
    assert got["correct"] is False
    med = got["checks"]["seg_err_med_m"]
    assert med["value"] is None or med["value"] > med["limit"]


def sound_values(result: dict) -> dict:
    return {k: c["value"] for k, c in result["checks"].items()}


def test_the_control_is_not_correct(monkeypatch):
    """The control's numbers on a sound run's frames, under the cell's
    limits."""
    cell = tiny_cell("city640", "offline", **SIZE)
    seen = {}
    real_numbers = check.numbers

    def numbers(setup, answers, control=False):
        seen.update(setup=setup, answers=answers)
        return real_numbers(setup, answers, control)

    monkeypatch.setattr(check, "numbers", numbers)
    sound = _run(cell)
    assert sound["correct"] is True, sound["checks"]
    both = real_numbers(seen["setup"], seen["answers"], control=True)
    assert {k: both["program"][k] for k in check.NAMES} == sound_values(sound)
    values = both["control"]
    correct, checks = check.judge(values, cell.limits)
    assert correct is False
    failed = [k for k, c in checks.items() if c["value"] is None or c["value"] > c["limit"]]
    assert {"lk_gap_px", "k1_gap"} <= set(failed), checks
    assert np.isfinite(values["seg_err_med_m"])
