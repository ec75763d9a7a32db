"""The benchmark's frozen copies held to the port's current source at a
small size: a change to the port's generator, evaluation or kernel
arithmetic shows here as drift of the program, not of the yardstick."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from vobench import evaluate, harness, reference, registry, roofline, scene
from vo_tpu_torch.data import city, evaluate as port_evaluate, synthetic
from vo_tpu_torch.ops import harris, image, klt


def _spec_fields(spec) -> dict:
    d = dataclasses.asdict(spec)
    d.pop("lighting")
    return d


def test_city640_is_the_headline_spec():
    (lane,) = harness.lanes_of(registry.config("city640"))
    assert _spec_fields(lane.spec) == _spec_fields(city.DEFAULT_SPEC)
    assert not lane.adaptive


def test_capacity_and_bootstrap_frames():
    cfg = registry.config("city640")
    assert cfg["vo"] == {"capacity": 1024}
    assert cfg["bootstrap_frames"] == [0, 2]


def test_scene_generators_equal_the_ports():
    spec = city.DEFAULT_SPEC
    np.testing.assert_array_equal(scene.make_path(spec.path, 600),
                                  city.make_path(spec.path, 600))
    ours, theirs = scene.build_city(spec.path, 3), city.build_city(spec.path, 3)
    for f in ("p0", "e1", "e2", "uv_off", "tile_m", "gain"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    for a, b in zip(scene.make_texture(4), city.make_texture(4)):
        np.testing.assert_array_equal(a, b)


def test_renderer_equals_the_ports():
    spec = dataclasses.replace(city.DEFAULT_SPEC, width=96, height=72, focal=62.25)
    rects, tex = scene.scene(spec)
    poses = scene.make_path(spec.path, 40)[::13]
    ours = scene.render_frames_torch(rects, tex, poses, spec.K(), 96, 72, device="cpu")
    prects, ptex = synthetic.scene(spec)
    theirs = synthetic.render_frames_torch(prects, ptex, poses, spec.K(), 96, 72,
                                           device="cpu")
    assert torch.equal(ours, theirs)


def test_evaluate_equals_the_ports():
    rng = np.random.default_rng(0)
    gt = np.cumsum(rng.normal(size=(50, 3)), 0)
    est = 0.3 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0] + rng.normal(0, 0.05, (50, 3))
    for a, b in zip(evaluate.align_umeyama(est, gt), port_evaluate.align_umeyama(est, gt)):
        np.testing.assert_array_equal(a, b)
    assert evaluate.ate_rmse(est, gt) == port_evaluate.ate_rmse(est, gt)


def test_corner_response_equals_the_ports():
    img = torch.rand(1, 60, 80, generator=torch.Generator().manual_seed(0)) * 255
    ours = reference.corner_response(img[0], dtype=torch.float32)
    theirs = harris.shi_tomasi_response(img[0], 7)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-2)
    exact = reference.corner_response(img[0])
    assert exact.dtype == torch.float64
    torch.testing.assert_close(exact.float(), theirs, rtol=1e-4, atol=1e-1)


def test_suppression_window_equals_the_ports():
    r = torch.rand(50, 70, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(reference.window_max(r.double(), 8),
                               harris._window_max(r.double(), 8), rtol=0, atol=0)


def test_pyramid_equals_the_ports():
    img = torch.rand(61, 83, generator=torch.Generator().manual_seed(2)) * 255
    ours = reference.build_pyramid(img, 4)
    theirs = image.build_pyramid(img.double(), 4)
    assert [o.shape for o in ours] == [t.shape for t in theirs]
    for o, t in zip(ours, theirs):
        torch.testing.assert_close(o, t, rtol=1e-12, atol=1e-9)


def test_lucas_kanade_equals_the_ports():
    """The reference's tracking in float64 against the port's plain path,
    fed the same float64 levels, points and guesses."""
    spec = dataclasses.replace(city.DEFAULT_SPEC, width=160, height=120, focal=103.75)
    rects, tex = scene.scene(spec)
    poses = scene.make_path(spec.path, 8)
    frames = scene.render_frames_torch(rects, tex, poses[[3, 4]], spec.K(), 160, 120,
                                       device="cpu").double()
    prev, nxt = image.build_pyramid(frames[0], 4), image.build_pyramid(frames[1], 4)
    g = torch.Generator().manual_seed(3)
    xy = torch.rand(64, 2, generator=g, dtype=torch.float64) * torch.tensor([140.0, 100.0]) + 10
    guess = torch.randn(64, 2, generator=g, dtype=torch.float64)
    ours, ok = reference.pyramidal_lk(prev, nxt, xy, guess, 8, 10, 0.03, 25.0, 1e-4)
    theirs = klt.pyramidal_lk(prev, nxt, xy, init_flow=guess, use_pallas=False)
    torch.testing.assert_close(ours, theirs.xy, rtol=0, atol=1e-9)
    assert torch.equal(ok, theirs.status) and ok.any()


def test_roofline_models_equal_chip_smokes():
    import chip_smoke

    rec: dict = {}
    chip_smoke._k1_bound(rec, (480, 640))
    assert roofline.k1_bound_s(1, 480, 640) * 1e3 == pytest.approx(rec["bound_ms"], rel=1e-12)
    chip_smoke._k1_bound(rec, (6, 480, 640))
    assert roofline.k1_bound_s(6, 480, 640) * 1e3 == pytest.approx(rec["bound_ms"], rel=1e-12)
    for lanes, (h, w), k in ((1, (480, 640), 1024), (1, (60, 80), 1024), (6, (240, 320), 512)):
        shape = (h, w) if lanes == 1 else (lanes, h, w)
        chip_smoke._pair_bound(rec, shape, k)
        assert roofline.pair_bound_s(lanes, h, w, k) * 1e3 == pytest.approx(rec["bound_ms"],
                                                                          rel=1e-12)
    assert roofline.K1_FLOP_PER_PIXEL == chip_smoke.K1_FLOP_PER_PIXEL
    assert (roofline.LK_TEMPLATE, roofline.LK_SEARCH) == (chip_smoke.LK_TSIZE,
                                                          chip_smoke.LK_SSIZE)
    assert roofline.pyramid_shapes(480, 640, 4) == [(480, 640), (240, 320), (120, 160),
                                                    (60, 80)]
