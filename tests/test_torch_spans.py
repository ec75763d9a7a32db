"""The captured step's spans and counters (models/spans.py) on the CPU,
through the runner's stand-in for capture (`graphed.StandIn`, whose mark
stamps the host's monotonic clock into the same ring), at 160x120 (focal
104), capacity 128, 12 steps of the city, three lanes, the third lost on
some frames so that R runs on some steps and not on others:

  * spans on and off give the same StepOutputs and final state, bit for
    bit, and the eager rollout's; with spans off nothing is marked;
  * the ring holds one row a step, its stamps in schedule order; R's and
    C's columns are set on exactly the steps they ran;
  * each counter equals the sum over lanes of the StepOutput field it
    shadows, or an eager recount (PnP's inputs, BA's runs and keeps, LK's
    active point-iterations, which never exceed those run);
  * a rollout under torch.profiler is flagged and left out; the summary
    stays under 4 KB; a wrapped ring counts only the rows it holds;
  * the statistics on rows made by hand: segments, gaps and what the host
    did during them, the clock's interpolation.

The card's own marks are tested in tests/test_torch_spans_cuda.py.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from vo_tpu_torch.data import synthetic as tsyn
from vo_tpu_torch.models import ba as tba
from vo_tpu_torch.models import graphed, spans
from vo_tpu_torch.models import pipeline as tpipe
from vo_tpu_torch.ops import image as timg
from vo_tpu_torch.ops import klt as tklt
from vo_tpu_torch.parallel import multiseq as tmulti
from vo_tpu_torch.utils.cache import RunnerCache
from vo_tpu_torch.utils.config import VOConfig

torch.set_num_threads(1)

SMALL = dict(width=160, height=120, focal=104.0)
CFG = VOConfig(capacity=128)
FRAMES = 15  # bootstrap on frames 0 and 2, then 12 steps


@pytest.fixture(scope="module")
def city():
    spec = dataclasses.replace(tsyn.DEFAULT_SPEC, **SMALL)
    seq = tsyn.render_sequence(spec, "cpu", FRAMES)
    return seq.frames, seq.K


def _boot(frames, K, seed):
    state, _ = tpipe.bootstrap(frames[0], frames[2], K, CFG, torch.Generator().manual_seed(seed))
    return state


def _lanes(frames, K):
    """Two lanes of the city and one that sees noise on frames 5-8 only."""
    lost = frames.clone()
    lost[5:9] = torch.from_numpy(
        np.random.default_rng(99).uniform(0, 255, lost[5:9].shape).astype(np.float32))
    states = [_boot(frames, K, 2023), _boot(frames, K, 2024), _boot(lost, K, 2025)]
    images = torch.stack([frames[3:], frames[3:], lost[3:]], dim=1)
    return tmulti.stack_states(states), images, K.expand(3, 3, 3).contiguous()


def _rows(runner) -> np.ndarray:
    """The device ring's rows of every step, in order."""
    r = runner.span_readout()
    return r.table[np.arange(1, r.steps + 1) % len(r.table)]


@pytest.fixture(scope="module")
def rolled(city):
    """The three lanes rolled eagerly (each branch's predicate, PnP's
    inputs, BA's verdicts and LK's active count recorded) and by runners
    with spans on and off."""
    frames, K = city
    state, images, Ks = _lanes(frames, K)
    rewind = tpipe.rewinder(state)
    seen = {"branch": [], "tri": [], "ba": [], "lk": []}
    mp = pytest.MonkeyPatch()
    real_branch, real_loc = tpipe.eager_branch, tpipe.step_localize
    real_track, real_kf = tpipe.step_track, tpipe.step_keyframe

    def branch(name, pred, run, skipped):
        seen["branch"].append((len(seen["tri"]), name, bool(pred)))
        return real_branch(name, pred, run, skipped)

    def localize(state, f, K, cfg):
        a = real_loc(state, f, K, cfg)
        seen["tri"].append(int(a.tri.sum()))
        return a

    def track(state, image, K, cfg):
        f = real_track(state, image, K, cfg, True)
        seen["lk"].append(int(f.lk_active.sum()))
        return f

    def keyframe(a, b, K, cfg):
        mapped, kept = real_kf(a, b, K, cfg, True)
        seen["ba"].append((len(seen["tri"]) - 1, int(b.push.sum()), int((b.push & kept).sum())))
        return mapped

    mp.setattr(tpipe, "eager_branch", branch)
    mp.setattr(tpipe, "step_localize", localize)
    mp.setattr(tpipe, "step_track", track)
    mp.setattr(tpipe, "step_keyframe", keyframe)
    eager = tmulti.batched_vo_rollout(state, images, Ks, CFG)
    mp.undo()
    got = {}
    for on in (True, False):
        rewind()
        cache = RunnerCache()
        out = graphed.graphed_rollout(state, images, Ks, CFG, cache=cache,
                                      capture=graphed.StandIn(), spans=on)
        got[on] = (out, graphed.runner_for(state, images, Ks, CFG, cache, spans=on), cache)
    return eager, got, seen


def test_spans_on_and_off_give_the_same_bits(rolled):
    (final_e, eager), got, _ = rolled
    (final_on, out_on), runner_on, _ = got[True]
    (final_off, out_off), runner_off, _ = got[False]
    for name, a, b, c in zip(eager._fields, eager, out_on, out_off):
        assert torch.equal(a, b) and torch.equal(a, c), name
    for a, b, c in zip(*(graphed._leaves(f) for f in (final_e, final_on, final_off))):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert runner_on.spans is not None and runner_off.spans is None
    assert runner_off.span_readout() is None


def test_spans_off_marks_nothing(city, monkeypatch):
    """With spans off the schedule runs with the eager step's mark: the
    capture mechanism is never asked to mark, and the runner keeps no
    ring."""
    frames, K = city

    def refuse(*args):
        raise AssertionError("a runner without spans marked a boundary")

    monkeypatch.setattr(graphed.StandIn, "mark", refuse)
    cache = RunnerCache()
    graphed.graphed_rollout(_boot(frames, K, 2023), frames[3:5], K, CFG, cache=cache,
                            capture=graphed.StandIn(), spans=False)
    assert graphed.summary(cache)["spans"] is None and graphed.span_rows(cache) == [None]


def test_the_ring_holds_one_row_a_step_in_schedule_order(rolled):
    _, got, seen = rolled
    (_, out), runner, _ = got[True]
    rows = _rows(runner)
    n = out.pose.shape[0]
    assert len(rows) == n and list(rows[:, 0]) == list(range(1, n + 1))
    t = rows[:, 1:1 + len(spans.BOUNDARIES)]
    ran = t > 0
    assert ran[:, [spans.BOUNDARY[b] for b in ("start", "track", "localize", "locate", "eigh",
                                              "map", "end")]].all()
    for row, on in zip(t, ran):
        assert np.all(np.diff(row[on]) >= 0), row
    # R's and C's columns on exactly the steps where the eager step ran them.
    for name, start, end in (("R", "R.start", "R.end"), ("C", "C.start", "C.end")):
        want = [on for _, b, on in seen["branch"] if b == name]
        assert list(ran[:, spans.BOUNDARY[start]]) == want == list(ran[:, spans.BOUNDARY[end]])
    assert ran[:, spans.BOUNDARY["R.start"]].sum() == runner.stats.recoveries >= 1
    assert ran[:, spans.BOUNDARY["C.start"]].sum() == runner.stats.keyframes >= 1
    assert not ran[:, spans.BOUNDARY["R.start"]].all()


def test_counters_equal_what_they_shadow(rolled):
    """The step's counts against the outputs the caller fetched, summed
    over lanes; PnP's inputs and BA's runs and keeps against an eager
    recount."""
    _, got, seen = rolled
    (_, out), runner, _ = got[True]
    rows = _rows(runner)
    col = spans.COL
    for name, field in (("tracked", "num_tracked"), ("pnp_inliers", "num_pnp_inliers"),
                        ("tri_candidates", "num_candidates"),
                        ("new_landmarks", "num_new_landmarks")):
        assert np.array_equal(rows[:, col[name]], getattr(out, field).sum(-1).numpy()), name
    assert list(rows[:, col["pnp_inputs"]]) == seen["tri"]
    runs, kept = np.zeros(len(rows), np.int64), np.zeros(len(rows), np.int64)
    for step, r, k in seen["ba"]:
        runs[step], kept[step] = r, k
    assert np.array_equal(rows[:, col["ba_runs"]], runs) and runs.sum() >= 1
    assert np.array_equal(rows[:, col["ba_kept"]], kept)
    assert np.all(kept <= runs) and np.all(rows[:, col["pnp_inliers"]] <= rows[:, col["pnp_inputs"]])
    counts = graphed.summary(got[True][2])["spans"]["counts"]
    assert counts["tracked"] == int(out.num_tracked.sum())
    assert counts["slots"] == CFG.capacity * 3 * len(rows)
    assert counts["pnp_hypotheses"] == 3 * len(rows) * CFG.pnp.num_hypotheses


def test_lk_active_never_exceeds_those_run_and_equals_an_eager_recount(rolled):
    _, got, seen = rolled
    (_, out), runner, cache = got[True]
    rows = _rows(runner)
    active = rows[:, spans.COL["lk_active"]]
    per_step = CFG.capacity * 3 * CFG.klt.pyramid_levels * CFG.klt.max_iters
    assert list(active) == seen["lk"]
    assert np.all((active > 0) & (active <= per_step))
    counts = graphed.summary(cache)["spans"]["counts"]
    assert counts["lk_run"] == per_step * len(rows) and counts["lk_active"] == active.sum()


def test_pyramidal_lk_counted_is_pyramidal_lk(city):
    """The counted track is the plain one bit for bit, and one frame's
    count is the levels' per-point counts of active iterations summed by
    hand."""
    frames, K = city
    p0, p1 = (timg.build_pyramid(frames[i], 3) for i in (3, 4))
    xy = torch.from_numpy(np.random.default_rng(5).uniform(12, 100, (64, 2)).astype(np.float32))
    plain = tklt.pyramidal_lk(p0, p1, xy, radius=8)
    counted, active = tklt.pyramidal_lk_counted(p0, p1, xy, radius=8)
    assert all(torch.equal(a, b) for a, b in zip(plain, counted))
    counts = []
    flow = torch.zeros_like(xy)
    for lvl in range(2, -1, -1):
        flow, _, _ = tklt._lk_level(p0[lvl], p1[lvl], xy / 2.0**lvl, flow, 8, 10, 0.03, 1e-4,
                                    None, counts)
        flow = flow * 2.0 if lvl else flow
    assert len(counts) == 3 and all(c.shape == (64,) and c.dtype == torch.int32
                                    and 0 <= int(c.min()) <= int(c.max()) <= 10 for c in counts)
    assert int(active) == sum(int(c.sum()) for c in counts)
    assert 0 < int(active) <= 64 * 30


def test_ba_refine_verdict_is_ba_refine(city):
    """The verdict rides beside `ba_refine`'s results, which stay its own."""
    frames, K = city
    st = _boot(frames, K, 2023)
    for f in range(3, 8):
        st, _ = tpipe.vo_step(st, frames[f], K, CFG)
    w, errs = tba.ba_refine(st.window, K, iters=3)
    w2, errs2, accept = tba.ba_refine_verdict(st.window, K, iters=3)
    assert all(torch.equal(a, b) for a, b in zip(w, w2)) and torch.equal(errs, errs2)
    assert accept.dtype == torch.bool and accept.shape == ()


def test_a_rollout_under_the_profiler_is_left_out(city):
    """Three steps, two under torch.profiler, two more: the profiled ones
    are flagged in the host ring and left out of every statistic."""
    from torch.profiler import ProfilerActivity, profile

    frames, K = city
    cache = RunnerCache()
    st = _boot(frames, K, 2023)

    def roll(state, lo, hi):
        return graphed.graphed_rollout(state, frames[lo:hi], K, CFG, cache=cache,
                                       capture=graphed.StandIn())[0]

    st = roll(st, 3, 6)
    with profile(activities=[ProfilerActivity.CPU]):
        st = roll(st, 6, 8)
    roll(st, 8, 10)
    r = graphed.span_rows(cache)[0]
    flags = r.host[np.arange(1, 8), spans.HCOL["profiled"]]
    assert list(flags) == [0, 0, 0, 1, 1, 0, 0]
    assert [x.profiled for x in r.rollouts] == [False, True, False]
    s = graphed.summary(cache)["spans"]
    assert s["steps"] == 5 and s["left_out"] == 2 and s["wrapped"] == 0
    # The gaps around the profiled steps are not the program's: 3 of 4 pairs
    # of steps in a row are counted, 2 of them between rollouts.
    assert s["device_wall_ms"] > 0 and 0 <= s["device_idle_pct"] < 100


def test_the_summary_stays_under_4kb(rolled):
    _, got, _ = rolled
    s = graphed.summary(got[True][2])
    text = json.dumps(s)
    assert len(text) < 4096
    sp = s["spans"]
    assert sp["steps"] == 12 and sp["left_out"] == 0
    assert set(sp["segment_ms"]) == set(spans.SEGMENTS)
    assert abs(sum(sp["segment_ms"].values()) - sp["step_ms"]["mean"]) <= (
        1e-3 * sp["step_ms"]["mean"])
    clock = sp["clock"]
    # The stand-in's clock is the host's: the offset lies within the
    # calibration's uncertainty.
    assert abs(clock["offset_ns"]) <= clock["uncertainty_ns"] + clock["tick_ns"]
    assert clock["tick_ns"] > 0


def test_a_wrapped_ring_counts_only_the_rows_it_holds(city, monkeypatch):
    frames, K = city
    monkeypatch.setattr(spans, "ROWS", 4)
    cache = RunnerCache()
    graphed.graphed_rollout(_boot(frames, K, 2023), frames[3:10], K, CFG, cache=cache,
                            capture=graphed.StandIn())
    r = graphed.span_rows(cache)[0]
    assert len(r.table) == 4 and r.steps == 7
    assert sorted(r.table[:, 0]) == [4, 5, 6, 7]
    s = graphed.summary(cache)["spans"]
    assert s["steps"] == 4 and s["wrapped"] == 3


def _made(stamps, counts=None, host=None, rollouts=(), cal=None, steps=None, rows=8):
    """A Readout from per-step stamps {boundary: [ns, ...]}."""
    n = len(stamps["start"])
    table = np.zeros((rows, len(spans.COLUMNS)), np.int64)
    hostr = np.zeros((rows, len(spans.HOST_COLUMNS)), np.int64)
    for i in range(n):
        s = i + 1
        table[s % rows, 0] = hostr[s % rows, 0] = s
        for b, v in stamps.items():
            table[s % rows, spans.COL[f"t.{b}"]] = v[i]
        for c, v in (counts or {}).items():
            table[s % rows, spans.COL[c]] = v[i]
        for c, v in (host or {}).items():
            hostr[s % rows, spans.HCOL[c]] = v[i]
    cals = cal or [spans.Calibration(0, 0, 10.0, 32)]
    return spans.Readout(table, hostr, list(rollouts), cals, steps or n,
                         dict(slots=10, lk_run=100, pnp_hypotheses=256))


def test_statistics_on_made_rows():
    """Two steps on a card clock 1000 ns ahead of the host's. Step 1: every
    segment 10 ns, R ran (its body 4 ns of B1's interval). Step 2 starts 60
    ns after step 1 ends; C ran (its body 10 ns of D's interval). The host
    drew during the first 20 ns of the gap, launched during the next 30 and
    copied during the last 10."""
    base = 1000
    st = {b: [0, 0] for b in spans.BOUNDARIES}
    t = base
    for b in ("start", "track", "localize", "R.start", "R.end", "locate", "eigh", "map", "end"):
        st[b][0] = t
        t += {"R.start": 4, "R.end": 6}.get(b, 10)
    t = st["end"][0] + 60
    for b in ("start", "track", "localize", "locate", "eigh", "map", "C.start", "C.end", "end"):
        st[b][1] = t
        t += 10
    # Host clock = card clock - 1000: the gap runs from host 70 to 130.
    host = {"draw": [0, 60], "launch": [0, 90], "copy_out": [0, 120], "done": [0, 150]}
    r = _made(st, counts={"tracked": [3, 4], "ba_runs": [0, 1], "ba_kept": [0, 1]},
              host=host, cal=[spans.Calibration(0, 1000, 5.0, 32)])
    seg = spans.segments_ns(r.table[[1, 2]])
    assert list(seg["recover"]) == [4, 0] and list(seg["locate"]) == [16, 10]
    assert list(seg["keyframe"]) == [0, 10] and list(seg["finish"]) == [10, 20]
    assert [int(sum(v[i] for v in seg.values())) for i in (0, 1)] == [
        st["end"][0] - st["start"][0], st["end"][1] - st["start"][1]]
    s = spans.statistics([r])
    assert s["steps"] == 2 and s["branch_steps"] == {"recover": 1, "keyframe": 1}
    assert s["device_idle_ms"] == pytest.approx(60e-6)
    wall = (st["end"][1] - st["start"][0]) * 1e-6
    assert s["device_wall_ms"] == pytest.approx(wall)
    assert s["device_idle_pct"] == pytest.approx(100 * 60e-6 / wall, rel=1e-5)
    idle = s["idle_host_ms"]
    assert idle["draw"] == pytest.approx(20e-6) and idle["launch"] == pytest.approx(30e-6)
    assert idle["copy_out"] == pytest.approx(10e-6) and idle["caller"] == 0
    assert s["counts"]["tracked"] == 7 and s["counts"]["ba_kept"] == 1
    assert s["counts"]["slots"] == 20 and s["counts"]["lk_run"] == 200
    assert s["clock"]["offset_ns"] == 1000 and s["clock"]["tick_ns"] == 32


def test_statistics_interpolate_the_clock_and_leave_out_broken_rows():
    """Two calibrations 1000 ns apart on the host whose offsets differ by
    100: a stamp half way between them maps with half the drift. A row
    whose host half belongs to another step is left out."""
    cals = [spans.Calibration(0, 5000, 1.0, 32), spans.Calibration(1000, 5100, 1.0, 32)]
    d = np.array([5000.0, 5550.0, 6100.0])
    assert list(spans.to_host_ns(d, cals)) == [0.0, 500.0, 1000.0]
    st = {b: [0, 0, 0] for b in spans.BOUNDARIES}
    for i in range(3):
        for j, b in enumerate(("start", "track", "localize", "locate", "eigh", "map", "end")):
            st[b][i] = 100 * (i + 1) + j
    r = _made(st, cal=cals)
    r.host[2, spans.HCOL["seq"]] = 9  # not step 2's
    s = spans.statistics([r])
    assert s["steps"] == 2 and s["left_out"] == 1
    assert s["device_idle_ms"] == 0 and s["clock"]["drift_ns"] == 100
    assert spans.statistics([_made({b: [] for b in spans.BOUNDARIES})]) is None
