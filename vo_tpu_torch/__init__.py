"""vo_tpu_torch — the PyTorch/CUDA port of vo_tpu (monocular visual odometry).

A second package beside `vo_tpu/`, which stays the reference. Every module
mirrors its `vo_tpu` counterpart's name, public functions, argument order and
array layouts, so the two can be run side by side on the same numpy inputs
(tests/test_torch_*.py). The two Pallas TPU kernels on the main path are
hand-written CUDA C++ kernels for Hopper (`csrc/`, bound in `ops/kernels.py`),
each with a plain PyTorch version beside it that is both the CPU path and the
kernel's oracle.

This package imports torch and never jax: it never runs `import vo_tpu`
(whose `__init__` imports jax). The framework-free numpy modules of
`vo_tpu` (the config dataclasses, the synthetic-city builders, ATE/RPE) are
loaded by file path instead (`_shared.py`).

Package map:
  vo_tpu_torch.geom    — homogeneous coords, Hartley normalization, SO(3)/SE(3),
                         camera model
  vo_tpu_torch.ops     — image stencils, corner detection, pyramidal LK,
                         RANSAC, 8-point/E, DLT, P3P, small SPD solves, and
                         the CUDA kernels (ops/kernels.py, ops/_build.py)
  vo_tpu_torch.models  — fixed-capacity feature table, sliding-window BA,
                         bootstrap + per-frame step
  vo_tpu_torch.data    — on-device synthetic-city renderer, ATE/RPE
  vo_tpu_torch.utils   — the shared VOConfig tree
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (8-point, DLT, P3P, the Gauss-Newton and BA solves) needs true f32
# accumulation. Hopper's TF32 tensor-core path keeps ~10 mantissa bits —
# the same reduced-precision trap that cost the reference 48% headline ATE
# when a bf16-pass solve slipped in (EVAL.md, round 5). cuDNN's flag
# defaults to True, so both are pinned explicitly.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
