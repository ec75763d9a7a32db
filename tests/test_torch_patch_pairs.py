"""`extract_patch_pairs` — both patch gathers of one Lucas-Kanade level from
the UNPADDED levels — against the JAX package's way (edge-pad the level, then
gather) on shared numpy inputs, bit for bit: against `vo_tpu.ops.klt.
_extract_patches` (a vmapped dynamic_slice) for every corner, in range or
not, and against the Pallas gather in interpret mode inside its contract.

On the CPU the wrapper runs its plain version (pad + gather). The CUDA
kernel never builds a padded level: each thread clamps its own address. That
addressing is written out here in numpy (`_clamped_gather`) and held against
the plain version for every corner, so the identity the kernel rests on is
checked where there is no card; the kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vo_tpu.ops import klt as jklt
from vo_tpu.ops.pallas_kernels import extract_patches_aligned

from vo_tpu_torch.ops import image as timg
from vo_tpu_torch.ops import kernels
from vo_tpu_torch.ops import klt as tklt

torch.set_num_threads(1)

RADIUS = 8
PAD = RADIUS + tklt.MARGIN + 2  # 18, as _lk_level pads
TSIZE = 2 * RADIUS + 1 + 4  # 21
SSIZE = 2 * RADIUS + 1 + 2 * tklt.MARGIN + 2  # 35


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _levels(rng, shape):
    return (rng.uniform(0, 255, shape).astype(np.float32),
            rng.uniform(0, 255, shape).astype(np.float32))


def _lk_corners(rng, lead, k, h, w, offset):
    """Corners as `_lk_level` makes them: floor of a centre clamped into the
    level, minus `offset`, plus the pad. The first centres sit on the level's
    own corners and edges."""
    pts = rng.uniform(-20, max(h, w) + 20, lead + (k, 2)).astype(np.float32)
    pts[..., :5, :] = [[0, 0], [w - 1, h - 1], [0, h - 1], [w - 1, 0], [w - 1.5, 0.25]]
    pts = np.clip(pts, 0, [w - 1.0, h - 1.0])
    return (np.floor(pts).astype(np.int32) - offset + PAD).astype(np.int32)


def _any_corners(rng, lead, k, hp, wp, size):
    """Corners anywhere, out to 40 px beyond the padded extent, and the
    extremes of lax.dynamic_slice's contract."""
    cor = np.stack([rng.integers(-40, wp + 40, lead + (k,)),
                    rng.integers(-40, hp + 40, lead + (k,))], -1)
    cor[..., :5, :] = [[0, 0], [wp - size, hp - size], [wp, hp], [-1, -1], [-wp - 5, -hp - 5]]
    return cor.astype(np.int32)


def _clamped_gather(level, corners, size, pad):
    """The CUDA kernel's addressing, in numpy: the start follows
    lax.dynamic_slice on the padded extent, then every pixel's address is
    clamped into the unpadded level."""
    h, w = level.shape
    hp, wp = h + 2 * pad, w + 2 * pad
    out = np.empty((len(corners), size, size), np.float32)
    for i, (cx, cy) in enumerate(corners):
        cx = cx + wp if cx < 0 else cx
        cy = cy + hp if cy < 0 else cy
        x0 = min(max(cx, 0), wp - size) - pad
        y0 = min(max(cy, 0), hp - size) - pad
        ys = np.clip(y0 + np.arange(size), 0, h - 1)
        xs = np.clip(x0 + np.arange(size), 0, w - 1)
        out[i] = level[np.ix_(ys, xs)]
    return out


def _jax_padded_gather(level, corners, size):
    return np.asarray(jklt._extract_patches(
        jnp.pad(jnp.asarray(level), PAD, mode="edge"), jnp.asarray(corners), size, False))


@pytest.mark.parametrize("corners", ["lk", "any"])
@pytest.mark.parametrize("shape", [(60, 80), (45, 37), (3, 40, 64)])
def test_pair_matches_jax_padded_gather(shape, corners):
    """Single and batched, border corners included: what the port's pair
    returns is what the JAX package gathers from its edge-padded levels."""
    rng = np.random.default_rng(5)
    lead, (h, w) = shape[:-2], shape[-2:]
    prev, nxt = _levels(rng, shape)
    if corners == "lk":
        tcor = _lk_corners(rng, lead, 50, h, w, RADIUS + 2)
        scor = _lk_corners(rng, lead, 50, h, w, RADIUS + tklt.MARGIN)
    else:
        tcor = _any_corners(rng, lead, 50, h + 2 * PAD, w + 2 * PAD, TSIZE)
        scor = _any_corners(rng, lead, 50, h + 2 * PAD, w + 2 * PAD, SSIZE)
    before = dict(kernels.launch_counts)
    got_t, got_s = kernels.extract_patch_pairs(T(prev), T(nxt), T(tcor), T(scor),
                                               TSIZE, SSIZE, PAD)
    assert kernels.launch_counts == before  # the plain path never counts
    assert got_t.shape == lead + (50, TSIZE, TSIZE)
    assert got_s.shape == lead + (50, SSIZE, SSIZE)
    lanes = [()] if not lead else [(b,) for b in range(lead[0])]
    for b in lanes:
        np.testing.assert_array_equal(
            got_t[b].numpy(), _jax_padded_gather(prev[b], tcor[b], TSIZE))
        np.testing.assert_array_equal(
            got_s[b].numpy(), _jax_padded_gather(nxt[b], scor[b], SSIZE))


@pytest.mark.parametrize("size,offset", [(TSIZE, RADIUS + 2), (SSIZE, RADIUS + tklt.MARGIN)])
def test_pair_matches_pallas_gather_in_interpret_mode(size, offset):
    """Inside the Pallas kernel's contract (its aligned cover region in
    bounds, by the reference's 48/256 over-pad): bit-identical to the TPU
    kernel on the padded level."""
    rng = np.random.default_rng(6)
    h, w = 60, 80
    prev, nxt = _levels(rng, (h, w))
    cor = _lk_corners(rng, (), 40, h, w, offset)
    padded = jnp.pad(jnp.pad(jnp.asarray(nxt), PAD, mode="edge"), ((0, 48), (0, 256)))
    want = np.asarray(extract_patches_aligned(padded, jnp.asarray(cor), size, interpret=True))
    other = _lk_corners(rng, (), 40, h, w, RADIUS + 2)
    # The level under test goes in as `nxt`; give it the size under test.
    _, got = kernels.extract_patch_pairs(T(prev), T(nxt), T(other), T(cor), TSIZE, size, PAD)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,pad,tsize,ssize", [
    ((60, 80), PAD, TSIZE, SSIZE), ((20, 25), PAD, TSIZE, SSIZE), ((48, 64), 7, 9, 15),
    ((30, 30), 0, 5, 30),
])
def test_kernel_addressing_equals_plain_for_every_corner(shape, pad, tsize, ssize):
    """Clamping each pixel's address into the unpadded level (what the CUDA
    kernel does) equals gathering from the edge-replicated copy, for corners
    in range, on the border and far outside the padded extent."""
    rng = np.random.default_rng(7)
    h, w = shape
    prev, nxt = _levels(rng, shape)
    tcor = _any_corners(rng, (), 200, h + 2 * pad, w + 2 * pad, tsize)
    scor = _any_corners(rng, (), 200, h + 2 * pad, w + 2 * pad, ssize)
    got_t, got_s = kernels.extract_patch_pairs_plain(T(prev), T(nxt), T(tcor), T(scor),
                                                     tsize, ssize, pad)
    np.testing.assert_array_equal(got_t.numpy(), _clamped_gather(prev, tcor, tsize, pad))
    np.testing.assert_array_equal(got_s.numpy(), _clamped_gather(nxt, scor, ssize, pad))


def test_pad_zero_pair_is_two_plain_gathers():
    """With pad = 0 the pair is `extract_patches` on each level: one device
    code serves both entries."""
    rng = np.random.default_rng(8)
    prev, nxt = _levels(rng, (2, 40, 50))
    tcor = _any_corners(rng, (2,), 30, 40, 50, 11)
    scor = _any_corners(rng, (2,), 30, 40, 50, 17)
    got_t, got_s = kernels.extract_patch_pairs(T(prev), T(nxt), T(tcor), T(scor), 11, 17, 0)
    assert torch.equal(got_t, kernels.extract_patches(T(prev), T(tcor), 11))
    assert torch.equal(got_s, kernels.extract_patches(T(nxt), T(scor), 17))


def test_pair_dispatch_on_cpu():
    img = torch.zeros((40, 50))
    cor = torch.zeros((3, 2), dtype=torch.int32)
    a = kernels.extract_patch_pairs(img, img, cor, cor, 5, 9, 4)
    b = kernels.extract_patch_pairs(img, img, cor, cor, 5, 9, 4, use_kernel=False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.extract_patch_pairs(img, img, cor, cor, 5, 9, 4, use_kernel=True)


@pytest.mark.parametrize("batched", [False, True])
def test_lk_gathers_once_a_level_inside_the_padded_extent(monkeypatch, batched):
    """`pyramidal_lk` asks for ONE pair per pyramid level, hands it the
    unpadded levels, and every corner it computes keeps its window inside
    the padded extent (so no start is ever clamped there), also for
    keypoints on the border and a flow guess that points far outside."""
    rng = np.random.default_rng(9)
    shape = (2, 120, 160) if batched else (120, 160)
    lead = shape[:-2]
    base = rng.uniform(0, 255, shape).astype(np.float32)
    p0 = timg.build_pyramid(T(base), 3)
    p1 = timg.build_pyramid(T(np.roll(base, (2, -3), axis=(-2, -1))), 3)
    xy = rng.uniform(0, 119, lead + (40, 2)).astype(np.float32)
    xy[..., :4, :] = [[0, 0], [159, 119], [0, 119], [159, 0]]
    flow = rng.normal(0, 30, lead + (40, 2)).astype(np.float32)
    calls = []

    def spy(prev, nxt, tcorner, scorner, tsize, ssize, pad, use_kernel=None):
        calls.append((tuple(prev.shape), tsize, ssize, pad))
        assert nxt.shape == prev.shape
        h, w = prev.shape[-2:]
        for cor, size in ((tcorner, tsize), (scorner, ssize)):
            assert cor.dtype == torch.int32 and cor.shape == lead + (40, 2)
            assert int(cor.min()) >= 0
            assert int(cor[..., 0].max()) <= w + 2 * pad - size
            assert int(cor[..., 1].max()) <= h + 2 * pad - size
        return kernels.extract_patch_pairs(prev, nxt, tcorner, scorner, tsize, ssize, pad,
                                           use_kernel=use_kernel)

    monkeypatch.setattr(tklt, "extract_patch_pairs", spy)
    out = tklt.pyramidal_lk(p0, p1, T(xy), init_flow=T(flow))
    assert bool(torch.isfinite(out.xy).all())
    assert calls == [(tuple(p.shape), TSIZE, SSIZE, PAD) for p in reversed(p0)]


def _lk_case(rng, batched):
    """Pyramids of a textured level and its shifted copy, 40 points (the
    level's corners among them) and flow guesses, one lane or two."""
    shape = (2, 120, 160) if batched else (120, 160)
    lead = shape[:-2]
    base = rng.uniform(0, 255, shape).astype(np.float32)
    p0 = timg.build_pyramid(timg.gaussian_blur(T(base), 1.5), 3)
    p1 = timg.build_pyramid(timg.gaussian_blur(T(np.roll(base, (2, -3), axis=(-2, -1))), 1.5), 3)
    xy = rng.uniform(0, 119, lead + (40, 2)).astype(np.float32)
    xy[..., :4, :] = [[0, 0], [159, 119], [0, 119], [159, 0]]
    flow = rng.normal(0, 3, lead + (40, 2)).astype(np.float32)
    return p0, p1, T(xy), T(flow)


@pytest.mark.parametrize("batched", [False, True])
def test_lk_on_the_cpu_takes_the_plain_path_bit_for_bit(monkeypatch, batched):
    """On CPU tensors `pyramidal_lk_counted` launches nothing and returns what
    it returns with `use_pallas=False`, track and count, bit for bit."""
    p0, p1, xy, flow = _lk_case(np.random.default_rng(10), batched)

    def no_launch(*args):
        raise AssertionError("a kernel launch on the CPU path")

    monkeypatch.setattr(kernels, "_launch", no_launch)
    before = dict(kernels.launch_counts)
    got, got_n = tklt.pyramidal_lk_counted(p0, p1, xy, init_flow=flow)
    want, want_n = tklt.pyramidal_lk_counted(p0, p1, xy, init_flow=flow, use_pallas=False)
    assert kernels.launch_counts == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got_n, want_n) and got_n.dtype == torch.int64
    assert int(got_n.min()) > 0


def test_lk_solve_with_the_kernel_asked_for_on_cpu_raises():
    p0, p1, xy, flow = _lk_case(np.random.default_rng(11), False)
    k = xy.shape[0]
    args = (torch.zeros((k, TSIZE, TSIZE)), torch.zeros((k, SSIZE, SSIZE)), xy % 1.0,
            xy % 1.0 + tklt.MARGIN, flow, RADIUS, 10, 0.03, 1e-4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lk_solve(*args, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tklt.pyramidal_lk(p0, p1, xy, init_flow=flow, use_pallas=True)
    flow_out, cond, err = kernels.lk_solve(*args, use_kernel=False)
    assert flow_out.shape == (k, 2) and cond.dtype == torch.bool and err.shape == (k,)


@pytest.mark.parametrize("batched", [False, True])
def test_lk_launches_one_solve_and_one_pair_a_level(monkeypatch, batched):
    """With both launches stubbed by plain twins that count as the kernels
    count (`_batched` over more than one lane), LK makes one pair launch and
    then one solve launch a pyramid level, coarsest first, and the track is
    the plain path's."""
    p0, p1, xy, flow = _lk_case(np.random.default_rng(12), batched)
    suffix = "_batched" if batched else ""
    calls = []
    real_pairs, real_solve = tklt.extract_patch_pairs, tklt.lk_solve

    def pairs(prev, *args, use_kernel=None):
        calls.append(("pair", tuple(prev.shape[-2:])))
        kernels.launch_counts["extract_patches" + suffix] += 1
        return real_pairs(prev, *args, use_kernel=False)

    def solve(*args, use_kernel=None):
        calls.append(("solve", tuple(args[1].shape)))
        kernels.launch_counts["lk_solve" + suffix] += 1
        return real_solve(*args, use_kernel=False)

    monkeypatch.setattr(tklt, "extract_patch_pairs", pairs)
    monkeypatch.setattr(tklt, "lk_solve", solve)
    before = dict(kernels.launch_counts)
    got, got_n = tklt.pyramidal_lk_counted(p0, p1, xy, init_flow=flow)
    launched = {n: kernels.launch_counts[n] - before[n] for n in before}
    assert launched == {**{n: 0 for n in before}, "extract_patches" + suffix: 3,
                        "lk_solve" + suffix: 3}
    levels = [tuple(p.shape[-2:]) for p in reversed(p0)]
    spatches = xy.shape[:-1] + (SSIZE, SSIZE)
    assert calls == [c for hw in levels for c in (("pair", hw), ("solve", spatches))]
    monkeypatch.undo()
    want, want_n = tklt.pyramidal_lk_counted(p0, p1, xy, init_flow=flow)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(got_n, want_n)


def test_lk_solve_rejects_a_wrong_patch_size_or_lane_count():
    k = 12
    t, s = torch.zeros((k, TSIZE, TSIZE)), torch.zeros((k, SSIZE, SSIZE))
    p = torch.zeros((k, 2))
    rest = (RADIUS, 10, 0.03, 1e-4)
    kernels.lk_solve(t, s, p, p, p, *rest)  # the shapes the LK caller makes
    with pytest.raises(ValueError, match="templates"):  # a template for radius 7
        kernels.lk_solve(torch.zeros((k, 19, 19)), s, p, p, p, *rest)
    with pytest.raises(ValueError, match="templates"):  # a search patch too small
        kernels.lk_solve(t, torch.zeros((k, 18, 18)), p, p, p, *rest)
    with pytest.raises(ValueError, match="templates"):  # not square
        kernels.lk_solve(t, torch.zeros((k, 35, 36)), p, p, p, *rest)
    with pytest.raises(ValueError, match="templates"):  # patches of 3 lanes, points of 2
        kernels.lk_solve(t.expand(3, k, TSIZE, TSIZE), s.expand(3, k, SSIZE, SSIZE),
                         p.expand(2, k, 2), p.expand(2, k, 2), p.expand(2, k, 2), *rest)
    with pytest.raises(ValueError, match="templates"):  # points of another count
        kernels.lk_solve(t, s, p[:5], p[:5], p[:5], *rest)
    with pytest.raises(ValueError, match="templates"):  # two lane axes
        kernels.lk_solve(t[None, None], s[None, None], p[None, None], p[None, None],
                         p[None, None], *rest)
    # The plain version takes any float dtype (the benchmark's reference test
    # feeds it float64); the kernel's dtypes are checked on the card.
    flow, _, err = kernels.lk_solve(t.double(), s.double(), p.double(), p.double(),
                                    p.double(), *rest)
    assert flow.dtype == err.dtype == torch.float64
