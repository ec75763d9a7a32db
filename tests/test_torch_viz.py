"""The port's figures (vo_tpu_torch/utils/viz.py) against the JAX package's
on the same seeded inputs: the overlays pixel for pixel (the same cv2 calls),
the three matplotlib writers each a valid PDF."""

import numpy as np
import pytest

from vo_tpu.utils import viz as jviz
from vo_tpu_torch.utils import viz as tviz


@pytest.fixture
def scene():
    rng = np.random.default_rng(2023)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    xy = rng.uniform(10, 110, (40, 2)).astype(np.float32)
    state = rng.integers(0, 3, 40)
    lm = rng.normal(0, 5, (200, 3)).astype(np.float32) + [0, 0, 15]
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, 2, 3] = np.arange(5)
    return img, xy, state, lm, poses


def test_overlays_equal_the_reference(scene):
    """Tolerance 0: both draw with the same cv2 calls on the same arrays."""
    img, xy, state, _, _ = scene
    for tracks in (None, xy + 2):
        got = tviz.keypoint_overlay(img, xy, state, tracks)
        assert got.shape == (120, 160, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jviz.keypoint_overlay(img, xy, state, tracks))
    mask = np.arange(40) % 3 != 0
    got = tviz.match_overlay(img, img[::-1], xy, xy + 3, mask, max_draw=7)
    assert got.shape == (120, 320, 3)
    np.testing.assert_array_equal(got, jviz.match_overlay(img, img[::-1], xy, xy + 3, mask,
                                                          max_draw=7))
    assert tviz.STATE_COLORS == jviz.STATE_COLORS


@pytest.mark.parametrize("figure", ["map", "trajectory", "landmarks"])
def test_figure_writers(scene, tmp_path, figure):
    """Each writer makes a PDF, as the reference's does from the same data."""
    _, _, _, lm, poses = scene
    sizes = []
    for mod in (tviz, jviz):
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}" / f"{figure}.pdf")
        if figure == "map":
            mod.save_point_cloud_plot(path, lm, poses, title="map")
        elif figure == "trajectory":
            mod.save_trajectory_plot(path, poses[:, :3, 3], poses[:, :3, 3] + 0.1, lm)
        else:
            mod.save_landmark_history_plot(path, np.arange(5), np.arange(5) * 3,
                                           np.arange(5) + 1, np.arange(5) * 2)
        with open(path, "rb") as f:
            assert f.read(5) == b"%PDF-"
        sizes.append(len(open(path, "rb").read()))
    assert sizes[0] > 1000 and abs(sizes[0] - sizes[1]) < 0.2 * sizes[1]
