"""Parity of the port's front-end against the JAX package on shared numpy
inputs: image stencils, corner responses, NMS and top-k selection, the two
kernels' plain versions (K1 against the Pallas kernel in interpret mode and
its XLA oracle, K2 against a vmapped dynamic_slice) and pyramidal LK.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vo_tpu.ops import harris as jh
from vo_tpu.ops import image as jimg
from vo_tpu.ops import klt as jklt
from vo_tpu.ops.pallas_kernels import corner_response_nms as pallas_corner_nms

from vo_tpu_torch.ops import harris as th
from vo_tpu_torch.ops import image as timg
from vo_tpu_torch.ops import kernels
from vo_tpu_torch.ops import klt as tklt

# Several pytest-xdist workers share the cores: PyTorch's intra-op thread
# pool over the port's many tiny CPU ops would only contend with them.
torch.set_num_threads(1)

RNG = np.random.default_rng(2023)
ATOL = 1e-5  # f32 stencils in the same tap order: equal up to a few ulps


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# ops/image.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sobel", "box7", "box9", "gauss", "down", "grad"])
def test_image_ops(op):
    img = _img((61, 83), seed=1)
    fns = {
        "sobel": lambda m, x: m.sobel(x),
        "box7": lambda m, x: m.box_filter(x, 7),
        "box9": lambda m, x: m.box_filter(x, 9),
        "gauss": lambda m, x: m.gaussian_blur(x, 1.3),
        "down": lambda m, x: m.downsample2(x),
        "grad": lambda m, x: m.image_gradients(x),
    }
    want = fns[op](jimg, jnp.asarray(img))
    got = fns[op](timg, torch.from_numpy(img))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(N(g), N(w), rtol=1e-6, atol=ATOL * 255)


def test_pyramid_and_bilinear():
    img = _img((96, 128), seed=2)
    jp = jimg.build_pyramid(jnp.asarray(img), 4)
    tp = timg.build_pyramid(torch.from_numpy(img), 4)
    for g, w in zip(tp, jp):
        np.testing.assert_allclose(N(g), N(w), rtol=1e-6, atol=ATOL * 255)
    pts = RNG.uniform(-3, 140, (200, 2)).astype(np.float32)
    np.testing.assert_allclose(
        N(timg.bilinear_sample(torch.from_numpy(img), torch.from_numpy(pts))),
        N(jimg.bilinear_sample(jnp.asarray(img), jnp.asarray(pts))),
        rtol=1e-6, atol=1e-3)


# ---------------------------------------------------------------------------
# K1: corner response + NMS (plain version vs Pallas interpret + XLA oracle)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,patch,nms_r", [("shi_tomasi", 7, 8), ("harris", 9, 5)])
@pytest.mark.parametrize("shape", [(150, 260), (64, 200), (30, 40)])
def test_k1_plain_matches_pallas_and_oracle(mode, patch, nms_r, shape):
    img = RNG.uniform(0, 255, shape).astype(np.float32)
    got = N(kernels.corner_response_nms_plain(torch.from_numpy(img), mode, patch, 0.08, nms_r))
    pallas = np.asarray(pallas_corner_nms(
        jnp.asarray(img), mode=mode, patch_size=patch, kappa=0.08, nms_radius=nms_r,
        interpret=True))
    resp = (jh.harris_response(jnp.asarray(img), patch, 0.08) if mode == "harris"
            else jh.shi_tomasi_response(jnp.asarray(img), patch))
    oracle = np.asarray(jh.nms_masked_response(resp, nms_r))
    for want in (pallas, oracle):
        # Same tolerance as tests/test_pallas_frontend.py: the maxima are
        # identical, values at rtol 1e-5 / atol 1e-2.
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fw = np.isfinite(want)
        np.testing.assert_allclose(got[fw], want[fw], rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("mode", ["shi_tomasi", "harris"])
def test_corner_responses(mode):
    img = _img((90, 120), seed=3)
    if mode == "harris":
        want = jh.harris_response(jnp.asarray(img), 9, 0.08)
        got = th.harris_response(torch.from_numpy(img), 9, 0.08)
    else:
        want = jh.shi_tomasi_response(jnp.asarray(img), 7)
        got = th.shi_tomasi_response(torch.from_numpy(img), 7)
    np.testing.assert_allclose(N(got), N(want), rtol=1e-5, atol=1e-2)


def test_detect_keypoints_tie_order():
    """Exact ties everywhere: a periodic pattern whose corners all share one
    response value. `lax.top_k` lists equal values by ascending index, and
    the port must produce the same slots in the same order."""
    tile = np.zeros((12, 12), np.float32)
    tile[3:9, 3:9] = 200.0
    img = np.tile(tile, (8, 10))
    args = dict(mode="shi_tomasi", patch_size=7, nms_radius=4, border=8, quality_level=0.01)
    want = jh.detect_keypoints(jnp.asarray(img), 64, use_pallas=False, **args)
    got = th.detect_keypoints(torch.from_numpy(img), 64, **args)
    assert int(np.asarray(want.valid).sum()) > 40
    np.testing.assert_array_equal(N(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(N(got.xy), np.asarray(want.xy))
    np.testing.assert_allclose(N(got.score), np.asarray(want.score), rtol=1e-6)


def test_select_from_masked_random():
    img = _img((190, 240), seed=4)
    resp = jh.shi_tomasi_response(jnp.asarray(img), 7)
    want = jh.select_keypoints(resp, 100, nms_radius=6, border=10, quality_level=0.01)
    got = th.select_keypoints(torch.from_numpy(np.asarray(resp)), 100, nms_radius=6,
                              border=10, quality_level=0.01)
    np.testing.assert_array_equal(N(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(N(got.xy), np.asarray(want.xy))


def test_kernel_dispatch_on_cpu():
    img = torch.from_numpy(_img((40, 50)))
    before = dict(kernels.launch_counts)
    a = kernels.corner_response_nms(img, "shi_tomasi", 7, 0.08, 8)
    b = kernels.corner_response_nms(img, "shi_tomasi", 7, 0.08, 8, use_kernel=False)
    assert torch.equal(a, b)
    cor = torch.zeros((3, 2), dtype=torch.int32)
    kernels.extract_patches(img, cor, 5)
    assert kernels.launch_counts == before  # the plain path never counts
    with pytest.raises(ValueError, match="CUDA"):
        kernels.corner_response_nms(img, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.extract_patches(img, cor, 5, use_kernel=True)


# ---------------------------------------------------------------------------
# K2: patch gather (plain version vs vmapped dynamic_slice)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [21, 35])
def test_k2_plain_matches_dynamic_slice(size):
    h, w = 120, 150
    img = _img((h, w), seed=5)
    # In range, on the edges and beyond them: dynamic_slice clamps starts.
    cor = np.stack([RNG.integers(-30, w + 30, 90), RNG.integers(-30, h + 30, 90)], -1)
    cor = np.concatenate([cor, [[0, 0], [w - size, h - size], [w, h], [-1, -1]]])
    cor = cor.astype(np.int32)
    want = jax.vmap(lambda c: jax.lax.dynamic_slice(jnp.asarray(img), (c[1], c[0]),
                                                    (size, size)))(jnp.asarray(cor))
    got = kernels.extract_patches_plain(torch.from_numpy(img), torch.from_numpy(cor), size)
    np.testing.assert_array_equal(N(got), np.asarray(want))
    # The batched form equals the per-image one.
    imgs = np.stack([img, img[::-1].copy()])
    cors = np.stack([cor, cor[::-1].copy()])
    gb = kernels.extract_patches_plain(torch.from_numpy(imgs), torch.from_numpy(cors), size)
    for b in range(2):
        np.testing.assert_array_equal(
            N(gb[b]),
            N(kernels.extract_patches_plain(torch.from_numpy(imgs[b]),
                                            torch.from_numpy(cors[b]), size)))


# ---------------------------------------------------------------------------
# Pyramidal LK
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_init_flow", [False, True])
def test_pyramidal_lk(with_init_flow):
    base = _img((140, 200), seed=6)
    import scipy.ndimage

    base = scipy.ndimage.gaussian_filter(base, 2.0).astype(np.float32)
    nxt = scipy.ndimage.shift(base, (2.3, -3.6), order=1, mode="nearest").astype(np.float32)
    xy = RNG.uniform(10, 130, (64, 2)).astype(np.float32)
    xy[:3] = [[1.0, 1.0], [198.0, 139.0], [100.5, 70.25]]  # borders and subpixel
    flow = (RNG.normal(0, 1.0, (64, 2)) + [-3.6, 2.3]).astype(np.float32) \
        if with_init_flow else None
    jp0, jp1 = jimg.build_pyramid(jnp.asarray(base), 3), jimg.build_pyramid(jnp.asarray(nxt), 3)
    tp0 = timg.build_pyramid(torch.from_numpy(base), 3)
    tp1 = timg.build_pyramid(torch.from_numpy(nxt), 3)
    want = jklt.pyramidal_lk(jp0, jp1, jnp.asarray(xy), use_pallas=False,
                             init_flow=None if flow is None else jnp.asarray(flow))
    got = tklt.pyramidal_lk(tp0, tp1, torch.from_numpy(xy),
                            init_flow=None if flow is None else torch.from_numpy(flow))
    # xy: atol 1e-3 px (f32 matmul resamples reduce in another order).
    np.testing.assert_array_equal(N(got.status), np.asarray(want.status))
    np.testing.assert_allclose(N(got.xy), np.asarray(want.xy), atol=1e-3)
    np.testing.assert_allclose(N(got.err), np.asarray(want.err), atol=1e-3)
    assert np.asarray(want.status).mean() > 0.5
