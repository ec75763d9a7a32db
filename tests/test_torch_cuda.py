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


@pytest.mark.cuda
@pytest.mark.parametrize("mode,patch,nms_r", [("shi_tomasi", 7, 8), ("harris", 9, 5)])
@pytest.mark.parametrize("shape", [(150, 260), (480, 640), (2, 64, 200)])
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
    """Two lanes through `batched_vo_step` on the card: one corner launch and
    two gathers a pyramid level, all of them batched."""
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
        "extract_patches": 0, "extract_patches_batched": 2 * cfg.klt.pyramid_levels}


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
