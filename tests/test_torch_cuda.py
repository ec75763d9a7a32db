"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where torch sees no GPU. The
file imports neither jax nor vo_tpu, so it also runs on a machine with only
PyTorch and the CUDA toolkit, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from vo_tpu_torch.ops import kernels

RNG = np.random.default_rng(2023)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels build and run only there)")
    return torch.device("cuda:0")


# (7, 8), (7, 5) and (9, 5) have instances of their own (both compiled in as
# constants); every other (patch, r) runs the generic instance.
K1_INSTANCES = [("shi_tomasi", 7, 8), ("harris", 7, 5), ("harris", 9, 5),
                ("shi_tomasi", 5, 3), ("shi_tomasi", 15, 12), ("harris", 2, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,patch,nms_r", K1_INSTANCES)
@pytest.mark.parametrize("shape", [(150, 260), (480, 640), (2, 64, 200), (30, 40), (41, 65)])
def test_k1_kernel_matches_plain(cuda_device, mode, patch, nms_r, shape):
    img = torch.as_tensor(RNG.uniform(0, 255, shape).astype(np.float32), device=cuda_device)
    # A launch over more than one image counts as the batched kernel's.
    name = "corner_response_nms_batched" if len(shape) == 3 else "corner_response_nms"
    before = dict(kernels.launch_counts)
    got = kernels.corner_response_nms(img, mode, patch, 0.08, nms_r, use_kernel=True)
    want = kernels.corner_response_nms_plain(img, mode, patch, 0.08, nms_r)
    assert kernels.launch_counts == {**before, name: before[name] + 1}
    # Same contract as the Pallas kernel's: identical maxima, values at
    # rtol 1e-5 / atol 1e-2 (tests/test_pallas_frontend.py).
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fw = torch.isfinite(want)
    torch.testing.assert_close(got[fw], want[fw], rtol=1e-5, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,patch,nms_r", K1_INSTANCES[:4])
def test_k1_kernel_breaks_exact_ties_as_plain(cuda_device, mode, patch, nms_r):
    """Flat regions (response 0 everywhere) and a periodic pattern whose
    corners share one response value: the tie-break decides every maximum."""
    img = RNG.uniform(0, 255, (200, 330)).astype(np.float32)
    img[:70, :160] = 7.0
    tile = np.zeros((12, 12), np.float32)
    tile[3:9, 3:9] = 200.0
    img[100:, 150:] = np.tile(tile, (9, 15))[:100, :180]
    img = torch.as_tensor(img, device=cuda_device)
    got = kernels.corner_response_nms(img, mode, patch, 0.08, nms_r, use_kernel=True)
    want = kernels.corner_response_nms_plain(img, mode, patch, 0.08, nms_r)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fw = torch.isfinite(want)
    torch.testing.assert_close(got[fw], want[fw], rtol=1e-5, atol=1e-2)


@pytest.mark.cuda
def test_k1_launch_info_and_unsupported_radius(cuda_device):
    info = kernels.corner_nms_launch_info(7, 8, cuda_device)
    assert info["specialised"] == 1 and info["blocks_per_sm"] >= 1
    assert kernels.corner_nms_launch_info(5, 3, cuda_device)["specialised"] == 0
    # A radius whose halo no block's shared memory holds is refused, not
    # handed to the plain version.
    with pytest.raises(RuntimeError, match="cudaError"):
        kernels.corner_response_nms(torch.zeros((64, 64), device=cuda_device),
                                    "shi_tomasi", 7, 0.08, 40, use_kernel=True)


def _pair_inputs(device, shape, k, tsize=21, ssize=35, pad=18):
    """Levels and corners for `extract_patch_pairs`: LK-like corners, a
    quarter anywhere out to 60 px beyond the padded extent, and the extremes."""
    lead, (h, w) = tuple(shape[:-2]), shape[-2:]
    hp, wp = h + 2 * pad, w + 2 * pad
    prev = torch.as_tensor(RNG.uniform(0, 255, shape).astype(np.float32), device=device)
    nxt = torch.as_tensor(RNG.uniform(0, 255, shape).astype(np.float32), device=device)

    def corners(size, offset):
        cor = np.stack([RNG.integers(0, w, lead + (k,)) + pad - offset,
                        RNG.integers(0, h, lead + (k,)) + pad - offset], -1)
        cor[..., : k // 4, :] = np.stack([RNG.integers(-60, wp + 60, lead + (k // 4,)),
                                          RNG.integers(-60, hp + 60, lead + (k // 4,))], -1)
        cor[..., -8:, :] = [
            [pad - offset, pad - offset], [pad + w - 1 - offset, pad + h - 1 - offset],
            [pad - offset, pad + h - 1 - offset], [pad + w - 1 - offset, pad - offset],
            [0, 0], [wp - size, hp - size], [wp, hp], [-1, -1]]
        return torch.as_tensor(cor.astype(np.int32), device=device)

    return prev, nxt, corners(tsize, 10), corners(ssize, 16), tsize, ssize, pad


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [
    ((480, 640), 1024), ((240, 320), 1024), ((120, 160), 1024), ((60, 80), 1024),
    ((6, 480, 640), 512), ((6, 60, 80), 512), ((3, 20, 25), 40),
])
def test_pair_kernel_matches_plain(cuda_device, shape, k):
    """Both gathers of an LK level in one launch, from the unpadded levels,
    bit-identical to pad + two plain gathers at the four level shapes of a
    640x480 frame, single and over six lanes, corners on the border and
    beyond the padded extent."""
    args = _pair_inputs(cuda_device, shape, k)
    name = "extract_patches_batched" if len(shape) == 3 else "extract_patches"
    before = dict(kernels.launch_counts)
    got_t, got_s = kernels.extract_patch_pairs(*args)
    assert kernels.launch_counts == {**before, name: before[name] + 1}  # ONE launch
    want_t, want_s = kernels.extract_patch_pairs_plain(*args)
    assert torch.equal(got_t, want_t) and torch.equal(got_s, want_s)
    if len(shape) == 3:  # and lane b is the single launch on lane b
        lane = kernels.extract_patch_pairs(*(a[1] for a in args[:4]), *args[4:])
        assert torch.equal(lane[0], got_t[1]) and torch.equal(lane[1], got_s[1])


@pytest.mark.cuda
def test_pair_kernel_with_pad_zero_is_the_single_gather(cuda_device):
    prev, nxt, tcor, scor, tsize, ssize, _ = _pair_inputs(cuda_device, (2, 96, 116), 200, pad=0)
    got_t, got_s = kernels.extract_patch_pairs(prev, nxt, tcor, scor, tsize, ssize, 0)
    assert torch.equal(got_t, kernels.extract_patches(prev, tcor, tsize))
    assert torch.equal(got_s, kernels.extract_patches(nxt, scor, ssize))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [21, 35])
def test_k2_kernel_matches_plain(cuda_device, size):
    img = torch.as_tensor(RNG.uniform(0, 255, (516, 676)).astype(np.float32),
                          device=cuda_device)
    cor = np.stack([RNG.integers(-40, 716, 1024), RNG.integers(-40, 556, 1024)], -1)
    cor = torch.as_tensor(cor.astype(np.int32), device=cuda_device)
    got = kernels.extract_patches(img, cor, size, use_kernel=True)
    assert torch.equal(got, kernels.extract_patches_plain(img, cor, size))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,patch,nms_r", [("shi_tomasi", 7, 8), ("harris", 9, 5)])
def test_k1b_kernel_matches_plain(cuda_device, mode, patch, nms_r):
    """The corner kernel over the six lanes of the multi-sequence run."""
    imgs = torch.as_tensor(RNG.uniform(0, 255, (6, 480, 640)).astype(np.float32),
                           device=cuda_device)
    before = dict(kernels.launch_counts)
    got = kernels.corner_response_nms(imgs, mode, patch, 0.08, nms_r)
    want = kernels.corner_response_nms_plain(imgs, mode, patch, 0.08, nms_r)
    assert kernels.launch_counts == {
        **before, "corner_response_nms_batched": before["corner_response_nms_batched"] + 1}
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fw = torch.isfinite(want)
    assert int(fw.flatten(1).sum(1).min()) > 100
    torch.testing.assert_close(got[fw], want[fw], rtol=1e-5, atol=1e-2)
    for b in range(6):  # and lane b is the single-image launch on lane b
        assert torch.equal(got[b], kernels.corner_response_nms(imgs[b], mode, patch, 0.08, nms_r))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 516, 676), (6, 96, 116)])
@pytest.mark.parametrize("size", [21, 35])
def test_k2b_kernel_matches_plain(cuda_device, size, shape):
    """The gather kernel over six lanes at the finest and coarsest LK level,
    with negative and clamped starts."""
    b, h, w = shape
    imgs = torch.as_tensor(RNG.uniform(0, 255, shape).astype(np.float32), device=cuda_device)
    cor = np.stack([RNG.integers(-40, w + 40, (b, 512)), RNG.integers(-40, h + 40, (b, 512))], -1)
    cor[:, :4] = [[0, 0], [w - size, h - size], [w, h], [-1, -1]]
    cor = torch.as_tensor(cor.astype(np.int32), device=cuda_device)
    before = dict(kernels.launch_counts)
    got = kernels.extract_patches(imgs, cor, size)
    assert kernels.launch_counts == {
        **before, "extract_patches_batched": before["extract_patches_batched"] + 1}
    assert torch.equal(got, kernels.extract_patches_plain(imgs, cor, size))
    assert torch.equal(got[3], kernels.extract_patches(imgs[3], cor[3], size))


@pytest.mark.cuda
def test_batched_step_launches_the_batched_kernels(cuda_device):
    """Two lanes through `batched_vo_step` on the card: one corner launch,
    one gather launch a pyramid level (the pair: template and search windows
    together) and one LK solve launch a level, all of them batched."""
    from vo_tpu_torch.models.pipeline import bootstrap
    from vo_tpu_torch.parallel.multiseq import batched_vo_step, stack_states
    from vo_tpu_torch.utils.config import VOConfig

    cfg = VOConfig(capacity=128)
    K = torch.tensor([[200.0, 0, 160], [0, 200.0, 120], [0, 0, 1]], device=cuda_device)
    base = torch.as_tensor(RNG.uniform(0, 255, (2, 240, 320)).astype(np.float32),
                           device=cuda_device)
    frames = [torch.roll(base, (i, 2 * i), dims=(1, 2)) for i in range(4)]
    states = stack_states([
        bootstrap(frames[0][b], frames[2][b], K, cfg,
                  torch.Generator(device=cuda_device).manual_seed(b))[0] for b in range(2)])
    kernels.reset_launch_counts()
    _, out = batched_vo_step(states, frames[3], K.expand(2, 3, 3).contiguous(), cfg)
    assert out.pose.shape == (2, 4, 4) and bool(torch.isfinite(out.pose).all())
    assert kernels.launch_counts == {
        "corner_response_nms": 0, "corner_response_nms_batched": 1,
        "extract_patches": 0, "extract_patches_batched": cfg.klt.pyramid_levels,
        "lk_solve": 0, "lk_solve_batched": cfg.klt.pyramid_levels}


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_input(cuda_device):
    img = torch.zeros((2, 40, 50), device=cuda_device)
    with pytest.raises(TypeError):
        kernels.corner_response_nms(img.double(), use_kernel=True)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.corner_response_nms(img.transpose(1, 2), use_kernel=True)
    cor = torch.zeros((2, 3, 2), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        kernels.extract_patches(img, cor, 5, use_kernel=True)
    with pytest.raises(ValueError, match="fit"):
        kernels.extract_patches(img, cor.int(), 41, use_kernel=True)
    with pytest.raises(TypeError):
        kernels.extract_patch_pairs(img, img, cor, cor.int(), 5, 9, 4, use_kernel=True)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.extract_patch_pairs(img, img.transpose(1, 2).transpose(1, 2)[:, :, ::2],
                                    cor.int(), cor.int(), 5, 9, 4, use_kernel=True)
    with pytest.raises(ValueError, match="shape"):
        kernels.extract_patch_pairs(img, img[:, :30].contiguous(), cor.int(), cor.int(),
                                    5, 9, 4, use_kernel=True)
    with pytest.raises(ValueError, match="fit"):
        kernels.extract_patch_pairs(img, img, cor.int(), cor.int(), 5, 49, 4, use_kernel=True)


@pytest.mark.cuda
@pytest.mark.parametrize("tracker", ["klt", "harris", "sift"])
def test_cuda_graphs_equal_the_eager_rollout(cuda_device, tracker):
    """The captured rollout (models/graphed.py) against the eager one
    (graph=False) at the headline's frame size: every output, the final
    state and the launch counts, bit for bit."""
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.models import graphed, pipeline
    from vo_tpu_torch.utils.config import VOConfig

    seq = synthetic.render_sequence(synthetic.DEFAULT_SPEC, cuda_device, 23)
    cfg = VOConfig(capacity=1024, tracker=tracker)
    state, _ = pipeline.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                                  torch.Generator(device=cuda_device).manual_seed(2023))
    rewind = pipeline.rewinder(state)
    runs = []
    for graph in (False, True):
        rewind()
        kernels.reset_launch_counts()
        rolled = dict(pipeline.ROLLED)
        final, outs = pipeline.vo_rollout(state, seq.frames[3:], seq.K, cfg, graph=graph)
        runs.append((final, outs, dict(kernels.launch_counts),
                     pipeline.executor_since(rolled)))
    (final_e, eager, n_eager, ran_e), (final_g, got, n_got, ran_g) = runs
    assert n_eager == n_got and (ran_e, ran_g) == ("eager", "graphs")
    for name, a, b in zip(eager._fields, eager, got):
        assert torch.equal(a, b), name
    assert all(torch.equal(a, b) for a, b in zip(graphed._leaves(final_e),
                                                 graphed._leaves(final_g)))
    runner = graphed.RUNNERS.runners()[-1]
    assert runner.stats.conditionals == 2 and runner.stats.syncs == 0


def _dlt_systems(device, lanes, k, seed):
    """A^T A of `ops/triangulate.py::dlt_system` for random views of random
    points: the DLT's eigh at its shape."""
    from vo_tpu_torch.ops.triangulate import dlt_system

    rng = np.random.default_rng(seed)
    R = np.linalg.qr(rng.normal(size=(lanes, k, 3, 3)))[0]
    t = rng.normal(size=(lanes, k, 3, 1))
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    P1 = K @ np.concatenate([R, t], -1)
    P2 = np.broadcast_to(K @ np.eye(3, 4), P1.shape)
    uv1, uv2 = rng.uniform(0, 600, (2, lanes, k, 2))
    return dlt_system(*(torch.as_tensor(x, dtype=torch.float32, device=device)
                        for x in (P1, P2, uv1, uv2)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["dlt 1x1024", "dlt 6x512", "8-point 1x256", "refit 1",
                                   "refit 3", "single 9x9"])
def test_cusolver_eigh_is_torch_linalg_eigh(cuda_device, shape):
    """ops/cusolver.py's eigh (cusolverDnXsyevBatched, no host read) gives
    torch.linalg.eigh's bits at the step's shapes: the DLT systems of one
    lane and of six, R's 8-point systems, its refit (one lane and three),
    and the bootstrap's single refit."""
    from vo_tpu_torch.ops import cusolver

    if shape.startswith("dlt"):
        lanes, k = (int(v) for v in shape.split()[1].split("x"))
        A = _dlt_systems(cuda_device, lanes, k, 3)
    else:
        dims = {"8-point 1x256": (1, 256), "refit 1": (1,), "refit 3": (3,),
                "single 9x9": ()}[shape]
        M = torch.as_tensor(RNG.normal(size=dims + (20, 9)), dtype=torch.float32,
                            device=cuda_device)
        A = M.transpose(-1, -2) @ M
    vals, vecs = cusolver.syev_batched(A)
    want_vals, want_vecs = torch.linalg.eigh(A)
    assert torch.equal(vals, want_vals) and torch.equal(vecs, want_vecs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 256, 3, 3), (1, 3, 3), (6, 3, 3), (3, 3)])
def test_cusolver_svd_is_torch_linalg_svd(cuda_device, shape):
    from vo_tpu_torch.ops import cusolver

    A = torch.as_tensor(RNG.normal(size=shape), dtype=torch.float32, device=cuda_device)
    for got, want in zip(cusolver.gesvdj_batched(A), torch.linalg.svd(A)):
        assert torch.equal(got, want)


def _two_view(seed, n=512, outliers=0.1):
    """Tracks of n points seen from two cameras that mostly rotate (2
    degrees about y, 1 cm forward), 0.3 px of noise and a share of
    outliers: the nearly degenerate 8-point systems of the recovery at a
    turn. (prev_xy, xy, K) in float32 numpy."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    X = rng.uniform([-20, -10, 5], [20, 10, 60], (n, 3))
    a = np.radians(2.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.0, 0.0, -0.01])

    def project(P):
        uv = P @ K.T
        return uv[:, :2] / uv[:, 2:]

    prev = project(X) + rng.normal(0, 0.3, (n, 2))
    xy = project(X @ R.T + t) + rng.normal(0, 0.3, (n, 2))
    bad = rng.random(n) < outliers
    xy[bad] += rng.uniform(-30, 30, (int(bad.sum()), 2))
    return prev.astype(np.float32), xy.astype(np.float32), K


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["8-point 1x256", "8-point 3x256", "refit 1", "refit 3",
                                   "dlt 1x4x1024", "8-point 512", "single 9x9", "dlt 4x1024"])
def test_cusolver_eigh_in_f64_is_torch_linalg_eigh(cuda_device, shape):
    """The two-view solve's eighs run in float64 (models/pipeline.py
    ::two_view_f64): cusolverDnXsyevBatched with CUDA_R_64F gives
    torch.linalg.eigh's bits at R's shapes, its 8-point and refit systems
    (one lane and three) and the DLT of its cheirality vote (4 candidates
    of 1,024 slots), and at the bootstrap's: its 512 8-point systems, its
    single refit and its DLT without a lane axis."""
    from vo_tpu_torch.ops import cusolver

    if shape.startswith("dlt"):
        A = _dlt_systems(cuda_device, 4, 1024, 5).to(torch.float64)
        A = A[None] if shape == "dlt 1x4x1024" else A
    else:
        dims = {"8-point 1x256": (1, 256), "8-point 3x256": (3, 256), "refit 1": (1,),
                "refit 3": (3,), "8-point 512": (512,), "single 9x9": ()}[shape]
        M = torch.as_tensor(RNG.normal(size=dims + (20, 9)), dtype=torch.float64,
                            device=cuda_device)
        A = M.transpose(-1, -2) @ M
    vals, vecs = cusolver.syev_batched(A)
    want_vals, want_vecs = torch.linalg.eigh(A)
    assert vals.dtype == vecs.dtype == torch.float64
    assert torch.equal(vals, want_vals) and torch.equal(vecs, want_vecs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 256, 3, 3), (3, 256, 3, 3), (1, 3, 3), (3, 3, 3),
                                   (512, 3, 3), (3, 3)])
def test_cusolver_svd_in_f64_is_torch_linalg_svd(cuda_device, shape):
    """cusolverDnDgesvdjBatched (float64's tolerance) gives
    torch.linalg.svd's bits at R's shapes and the bootstrap's (no lane
    axis, 512 hypotheses): the rank-2 projections of the hypotheses and of
    the refit, E's projection and decomposition."""
    from vo_tpu_torch.ops import cusolver

    A = torch.as_tensor(RNG.normal(size=shape), dtype=torch.float64, device=cuda_device)
    for got, want in zip(cusolver.gesvdj_batched(A), torch.linalg.svd(A)):
        assert got.dtype == torch.float64 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.complex64,
                                   torch.int32])
def test_cusolver_refuses_other_dtypes(cuda_device, dtype):
    """float32 and float64 only; nothing falls back to torch.linalg."""
    from vo_tpu_torch.ops import cusolver

    A = torch.eye(3, device=cuda_device).to(dtype)[None]
    for routine in (cusolver.syev_batched, cusolver.gesvdj_batched):
        with pytest.raises(TypeError, match="float32 or float64"):
            routine(A)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_recovery_on_the_card_is_the_cpus(cuda_device, seed):
    """R (float64 on both devices) on nearly degenerate tracks with the
    same uniforms: the same inlier count and decision, and poses one or two
    float32 steps apart at most (both round an f64 pose that agrees to
    about 1e-12)."""
    from vo_tpu_torch.models import pipeline
    from vo_tpu_torch.ops.ransac import Drawn, draw_uniforms
    from vo_tpu_torch.utils.config import VOConfig

    prev, xy, K = _two_view(seed)
    n = prev.shape[0]
    cfg = VOConfig(capacity=n)
    u = draw_uniforms(torch.Generator().manual_seed(seed), *pipeline.recovery_shape(cfg))
    sides = []
    for dev in (cuda_device, torch.device("cpu")):
        T = lambda x: torch.as_tensor(x, device=dev)[None]  # noqa: E731
        sides.append(pipeline.recover_pose(
            T(prev), T(xy), T(np.ones(n, bool)), T(np.eye(4, dtype=np.float32)),
            T(np.float32(1.0)), T(False), T(np.eye(4, dtype=np.float32)), T(K), cfg,
            [Drawn(u.to(dev))]))
    card, cpu = sides
    assert card.pose.dtype == cpu.pose.dtype == torch.float32
    assert int(card.num_inliers) == int(cpu.num_inliers) > 30
    assert bool(card.took) and bool(cpu.took)
    assert float((card.pose.cpu() - cpu.pose).abs().max()) <= 3e-7


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_bootstrap_on_the_card_is_the_cpus(cuda_device, seed):
    """The bootstrap's solve (`two_view_f64` and `bootstrap_map`, float64
    on both devices) on a nearly degenerate, mostly rotating pair with the
    same uniforms: the same inlier and cheirality masks, the same
    landmarks and the same float32 pose of camera 1, bit for bit. (With a
    1 cm baseline most points lie beyond the depth range: a few are
    landmarks.)"""
    from vo_tpu_torch.models import pipeline
    from vo_tpu_torch.ops.ransac import Drawn, draw_uniforms
    from vo_tpu_torch.utils.config import VOConfig

    prev, xy, K = _two_view(seed)
    n = prev.shape[0]
    cfg = VOConfig(capacity=n)
    u = draw_uniforms(torch.Generator().manual_seed(seed), cfg.bootstrap.num_hypotheses, n)
    sides = []
    for dev in (cuda_device, torch.device("cpu")):
        T = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        two = pipeline.two_view_f64(T(prev), T(xy), T(np.ones(n, bool)), T(K), cfg,
                                    cfg.bootstrap, Drawn(u.to(dev)))
        sides.append((two.ransac.inliers.cpu(), (two.rel.good & two.ransac.inliers).cpu())
                     + tuple(t.cpu() for t in pipeline.bootstrap_map(two, cfg)))
    (card_inl, card_front, card_pose, card_pts, card_good), \
        (cpu_inl, cpu_front, cpu_pose, cpu_pts, cpu_good) = sides
    assert card_pose.dtype == cpu_pose.dtype == torch.float32
    assert int(card_inl.sum()) > 30 and torch.equal(card_inl, cpu_inl)
    assert int(card_front.sum()) > 30 and torch.equal(card_front, cpu_front)
    assert int(card_good.sum()) > 0 and torch.equal(card_good, cpu_good)
    assert torch.equal(card_pose, cpu_pose)
    assert torch.allclose(card_pts[cpu_good], cpu_pts[cpu_good], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_the_frame_graph_holds_two_conditional_nodes(cuda_device):
    """One graph a frame: its IF nodes for R and C, the kernels of
    ops/kernels.py outside them (one K1, four K2 a step) and none inside,
    where R's cuSOLVER kernels are."""
    from vo_tpu_torch.data import synthetic
    from vo_tpu_torch.models import graphed, pipeline
    from vo_tpu_torch.utils.cache import RunnerCache
    from vo_tpu_torch.utils.config import VOConfig

    seq = synthetic.render_sequence(synthetic.DEFAULT_SPEC, cuda_device, 5)
    cfg = VOConfig(capacity=1024)
    state, _ = pipeline.bootstrap(seq.frames[0], seq.frames[2], seq.K, cfg,
                                  torch.Generator(device=cuda_device).manual_seed(2023))
    runner = graphed.runner_for(state, seq.frames[3:], seq.K, cfg, RunnerCache())
    nodes = runner.frame.nodes
    assert nodes.conditionals == 2 and runner.stats.graphs["frame"] == nodes.nodes
    assert sum("corner_nms_kernel" in n for n in nodes.kernels) == 1
    assert sum("patch_gather_kernel" in n for n in nodes.kernels) == 4
    assert not any(s in n for n in nodes.body_kernels for s in ("corner_nms", "patch_gather"))
    assert any("syev" in n or "sytrd" in n or "steqr" in n for n in nodes.body_kernels)


@pytest.mark.cuda
def test_graph_nodes_reads_kernels_inside_conditional_bodies(cuda_device):
    """A K1 launch captured into a branch and the branch under an IF node:
    `graph_nodes` finds it inside the body, a K2 launch outside it."""
    from vo_tpu_torch.models import graphed

    img = torch.as_tensor(RNG.uniform(0, 255, (64, 96)).astype(np.float32),
                          device=cuda_device)
    cor = torch.full((8, 2), 20, dtype=torch.int32, device=cuda_device)
    pred = torch.ones((), dtype=torch.bool, device=cuda_device)
    capture = graphed.CudaGraphs(cuda_device)
    with capture.warming_up():
        kernels.corner_response_nms(img, "shi_tomasi", 7, 0.04, 8, use_kernel=True)
        kernels.extract_patches(img, cor, 5, use_kernel=True)
    branch = capture.capture(
        lambda: kernels.corner_response_nms(img, "shi_tomasi", 7, 0.04, 8, use_kernel=True),
        branch=True)

    def frame():
        kernels.extract_patches(img, cor, 5, use_kernel=True)
        capture.if_node(pred.clone(), branch)

    nodes = capture.capture(frame).nodes
    assert nodes.conditionals == 1
    assert sum("patch_gather_kernel" in n for n in nodes.kernels) == 1
    assert not any("corner_nms_kernel" in n for n in nodes.kernels)
    assert sum("corner_nms_kernel" in n for n in nodes.body_kernels) == 1
