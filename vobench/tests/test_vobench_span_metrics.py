"""The readers of the program's own spans and counters (the per-layer
metrics that read `graphed.summary()["spans"]`), on a fixed summary: each
returns the value it should, and None where there is nothing to read (a
program that keeps no spans, a run in which no step counted, a share whose
whole is 0)."""

from __future__ import annotations

import copy
import json

import pytest

from vobench import registry
from vobench.run import Reading

SPANS = {
    "steps": 100, "left_out": 16, "wrapped": 0,
    "segment_ms": {"track": 4.0, "localize": 5.0, "recover": 0.25, "locate": 0.2,
                   "eigh": 0.1, "map": 0.5, "keyframe": 6.0, "finish": 0.15},
    "branch_steps": {"recover": 2, "keyframe": 50},
    "branch_ms": {"recover": 12.5, "keyframe": 12.0},
    "step_ms": {"mean": 16.2, "p95": 26.0},
    "device_idle_pct": 0.4, "device_idle_ms": 6.5, "device_wall_ms": 1626.5,
    "idle_host_ms": {"draw": 1.0, "launch": 2.0, "copy_out": 0.5, "copy_in": 0.5,
                     "copy_back": 0.5, "caller": 2.0},
    "host_ms": {"draw": 0.5, "launch": 12.0, "copy_out": 0.3},
    "counts": {"tracked": 40000, "pnp_inputs": 30000, "pnp_inliers": 27000,
               "tri_candidates": 10000, "new_landmarks": 2000, "lk_active": 1200000,
               "ba_runs": 50, "ba_kept": 49, "slots": 102400, "lk_run": 4096000,
               "pnp_hypotheses": 25600},
    "clock": {"offset_ns": 1792300666824477213, "uncertainty_ns": 7773.5, "drift_ns": 29726,
              "drift_over_s": 15.9, "tick_ns": 32},
}

WANT = {
    "device_idle_pct": 0.4,
    "host_step_ms": 12.8,
    "step_span_ms": 16.2,
    "front_end_ms": 4.0,
    "pnp_ms": 5.0,
    "map_ms": 0.8,
    "ba_ms": 6.0,
    "lk_active_pct": 100.0 * 1200000 / 4096000,
    "tracks_alive_pct": 100.0 * 40000 / 102400,
    "pnp_inlier_pct": 90.0,
    "ba_accept_pct": 98.0,
    "tri_yield_pct": 20.0,
}


def _ctx(spans) -> Reading:
    summary = {"frames": 116, "syncs_per_step": 0.0, "recoveries": 2, "keyframes": 58,
               "graphs": []}
    if spans is not ...:
        summary["spans"] = spans
    return Reading(None, 1, 480, 640, 1024, 4, summary)


def test_the_readers_are_the_benchmarks_entries():
    bench = json.loads(registry.BENCHMARK.read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in WANT:
        m = entries[name]
        assert m["source"] == "program_counter" and m["moves"] == "fps"
        assert m["workloads"] == ["city640.offline", "city640.batch6"]


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_on_a_fixed_summary(name):
    read = registry.metric(name)
    assert read(_ctx(SPANS)) == pytest.approx(WANT[name])
    # Nothing to read: no summary, a program without spans, no step counted.
    assert read(Reading(None, 1, 480, 640, 1024, 4, None)) is None
    assert read(_ctx(...)) is None
    assert read(_ctx(None)) is None
    assert read(_ctx(dict(SPANS, steps=0))) is None


@pytest.mark.parametrize("name,key", [
    ("lk_active_pct", "lk_run"), ("tracks_alive_pct", "slots"),
    ("pnp_inlier_pct", "pnp_inputs"), ("ba_accept_pct", "ba_runs"),
    ("tri_yield_pct", "tri_candidates")])
def test_a_share_of_nothing_reads_nothing(name, key):
    spans = copy.deepcopy(SPANS)
    spans["counts"][key] = 0
    assert registry.metric(name)(_ctx(spans)) is None
    del spans["counts"][key]
    assert registry.metric(name)(_ctx(spans)) is None


def test_ba_ms_reads_nothing_where_c_never_ran():
    spans = copy.deepcopy(SPANS)
    spans["branch_steps"]["keyframe"] = 0
    spans["segment_ms"]["keyframe"] = 0.0
    assert registry.metric("ba_ms")(_ctx(spans)) is None
    # ... and the idle share where no two counted steps were in a row.
    spans["device_idle_pct"] = None
    assert registry.metric("device_idle_pct")(_ctx(spans)) is None
