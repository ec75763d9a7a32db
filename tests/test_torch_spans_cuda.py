"""The captured step's spans and counters on the card (models/spans.py,
csrc/spans.cu): the frame graph's added nodes, the stamps, the shared clock
of the stamps and a profiler trace, and the same bits with spans on and
off. Every test is marked `cuda` and skips where torch sees no GPU; the file
imports neither jax nor vo_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_spans_cuda.py
"""

import json
import os
import re
import tempfile
import time

import numpy as np
import pytest
import torch

FRAMES = 13  # the bootstrap on frames 0 and 2, then 10 steps


@pytest.fixture(scope="module")
def city():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the mark kernel builds and runs only there)")
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.models import pipeline
    from vo_tpu_torch.utils.config import VOConfig

    dev = torch.device("cuda:0")
    seq = synthetic.render_sequence(synthetic.DEFAULT_SPEC, dev, FRAMES)
    cfg = VOConfig(capacity=1024)
    state, _ = pipeline.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                                  torch.Generator(device=dev).manual_seed(2023))
    return seq, cfg, state


def _runners(city):
    from vo_tpu_torch.models import graphed
    from vo_tpu_torch.utils.cache import RunnerCache

    seq, cfg, state = city
    return {on: graphed.runner_for(state, seq.frames[3:], seq.K, cfg, RunnerCache(), spans=on)
            for on in (True, False)}


@pytest.mark.cuda
def test_spans_add_the_documented_nodes_and_the_same_bits(city):
    """The frame's graph with spans holds the graph without them plus
    `spans.ADDED_NODES` nodes (at most 40): the marks (seven in the frame,
    two in each body) and the counters' few operations. Outputs and final
    state are bit-identical on and off."""
    from vo_tpu_torch.models import graphed, pipeline, spans

    seq, cfg, state = city
    runners = _runners(city)
    on, off = runners[True].frame.nodes, runners[False].frame.nodes
    assert on.nodes - off.nodes == spans.ADDED_NODES <= 40
    assert sum("vo_span_mark" in n for n in on.kernels) == 7
    assert sum("vo_span_mark" in n for n in on.body_kernels) == 4
    assert not any("vo_span_mark" in n for n in off.kernels + off.body_kernels)
    rewind = pipeline.rewinder(state)
    got = {}
    for flag, runner in runners.items():
        rewind()
        got[flag] = runner(state, seq.frames[3:], seq.K)
    (final_on, out_on), (final_off, out_off) = got[True], got[False]
    for name, a, b in zip(out_on._fields, out_on, out_off):
        assert torch.equal(a, b), name
    assert all(torch.equal(a, b) for a, b in zip(graphed._leaves(final_on),
                                                 graphed._leaves(final_off)))
    # The counters shadow the outputs the caller fetched.
    r = runners[True].span_readout()
    rows = r.table[np.arange(1, r.steps + 1) % len(r.table)][-out_on.pose.shape[0]:]
    col = spans.COL
    assert np.array_equal(rows[:, col["tracked"]], out_on.num_tracked.cpu().numpy())
    assert np.array_equal(rows[:, col["pnp_inliers"]], out_on.num_pnp_inliers.cpu().numpy())
    assert np.array_equal(rows[:, col["tri_candidates"]], out_on.num_candidates.cpu().numpy())
    assert np.array_equal(rows[:, col["new_landmarks"]],
                          out_on.num_new_landmarks.cpu().numpy())


@pytest.mark.cuda
def test_stamps_are_monotone_and_segments_tile_the_step(city):
    """Every row's stamps in schedule order (R's and C's where they ran,
    exactly on the steps the device counted), and the segments' means sum
    to the step's span within 1%."""
    from vo_tpu_torch.models import graphed, spans
    from vo_tpu_torch.utils.cache import RunnerCache

    seq, cfg, state = city
    cache = RunnerCache()
    runner = graphed.runner_for(state, seq.frames[3:], seq.K, cfg, cache)
    runner(state, seq.frames[3:], seq.K)
    r = runner.span_readout()
    rows = r.table[np.arange(1, r.steps + 1) % len(r.table)]
    t = rows[:, 1:1 + len(spans.BOUNDARIES)]
    ran = t > 0
    for row, on in zip(t, ran):
        assert np.all(np.diff(row[on]) >= 0), row
    col = spans.BOUNDARY
    assert ran[:, col["R.start"]].sum() == runner.stats.recoveries
    assert ran[:, col["C.start"]].sum() == runner.stats.keyframes >= 1
    s = graphed.summary(cache)["spans"]
    assert s["steps"] == r.steps and s["clock"]["tick_ns"] > 0
    total = sum(s["segment_ms"].values())
    assert abs(total - s["step_ms"]["mean"]) <= 0.01 * s["step_ms"]["mean"]
    assert len(json.dumps(graphed.summary(cache))) < 4096


def _host_minus_realtime_us() -> float:
    """time.monotonic_ns minus time.time_ns, in us: the narrowest of 16
    pairs of readings."""
    pairs = []
    for _ in range(16):
        m0 = time.monotonic_ns()
        w = time.time_ns()
        m1 = time.monotonic_ns()
        pairs.append((m1 - m0, (m0 + m1) / 2 - w))
    return min(pairs)[1] * 1e-3


@pytest.mark.cuda
def test_each_mark_lies_within_50_us_of_its_stamp_in_a_trace(city):
    """Two steps under torch.profiler: each vo_span_mark<B> kernel of the
    trace (the profiler's clock is the wall clock, its trace's times
    relative to `baseTimeNanoseconds`), put on the host's monotonic clock,
    lies within 50 us of the stamp the mark wrote, put on the same clock
    through the runner's calibration."""
    from torch.profiler import ProfilerActivity, profile

    from vo_tpu_torch.models import graphed, pipeline, spans
    from vo_tpu_torch.utils.cache import RunnerCache

    seq, cfg, state = city
    runner = graphed.runner_for(state, seq.frames[3:], seq.K, cfg, RunnerCache())
    mid, _ = runner(state, seq.frames[3:5], seq.K)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner(mid, seq.frames[5:7], seq.K)
        torch.cuda.synchronize()
    to_mono_us = _host_minus_realtime_us()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    r = runner.span_readout()
    seqs = np.array([r.steps - 1, r.steps])
    rows, host = r.table[seqs % len(r.table)], r.host[seqs % len(r.host)]
    assert np.all(host[:, spans.HCOL["profiled"]] == 1)
    kernels = sorted((e for e in trace["traceEvents"] if e.get("cat") == "kernel"
                      and "vo_span_mark" in e.get("name", "")), key=lambda e: e["ts"])
    base_us = trace.get("baseTimeNanoseconds", 0) * 1e-3
    if kernels and kernels[0]["ts"] > 1e14:  # times already since the epoch
        base_us = 0.0
    marks: dict = {}
    for e in kernels:
        b = int(re.search(r"vo_span_mark<(\d+)>", e["name"]).group(1))
        marks.setdefault(b, []).append(e["ts"] + base_us + to_mono_us)
    assert set(marks) >= {spans.BOUNDARY[b] for b in ("start", "track", "end")}
    off = {}
    for b, traced in marks.items():
        stamps = rows[:, 1 + b]
        stamps = stamps[stamps > 0]
        assert len(stamps) == len(traced), pipeline.BOUNDARIES[b]
        mono_us = spans.to_host_ns(stamps.astype(np.float64), r.calibrations) * 1e-3
        off[pipeline.BOUNDARIES[b]] = np.round(mono_us - np.array(traced), 1).tolist()
    print(f"each mark's stamp less its traced start, us: {off}")
    assert all(abs(x) < 50.0 for v in off.values() for x in v), off
