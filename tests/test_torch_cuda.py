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
    before = kernels.launch_counts["corner_response_nms"]
    got = kernels.corner_response_nms(img, mode, patch, 0.08, nms_r, use_kernel=True)
    want = kernels.corner_response_nms_plain(img, mode, patch, 0.08, nms_r)
    assert kernels.launch_counts["corner_response_nms"] == before + 1
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
