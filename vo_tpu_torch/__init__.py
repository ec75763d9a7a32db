"""vo_tpu_torch — the PyTorch/CUDA port of vo_tpu (monocular visual odometry).

A second package beside `vo_tpu/`, which stays the reference. Every module
mirrors its `vo_tpu` counterpart's name, public functions, argument order and
array layouts, so the two can be run side by side on the same numpy inputs
(tests/test_torch_*.py). The Pallas TPU kernels (two, each with a batched
twin) are two hand-written CUDA C++ kernels for Hopper with a batch dimension
(`csrc/`, bound in `ops/kernels.py`), each with a plain PyTorch version beside
it that is both the CPU path and the kernel's oracle.

This package imports torch and never jax, and nothing of `vo_tpu`: it keeps
its own copies of the reference's numpy-only modules (the config dataclasses
in `utils/config.py`, the synthetic-city generators in `data/city.py`, ATE/RPE
in `data/evaluate.py`), and tests/test_torch_no_jax.py holds the copies equal
to the reference.

Package map:
  vo_tpu_torch.geom    — homogeneous coords, Hartley normalization,
                         SO(3)/SE(3)/Sim(3), camera model
  vo_tpu_torch.ops     — image stencils, corner detection, pyramidal LK,
                         patch descriptors + matcher, SIFT, RANSAC,
                         8-point/E, DLT, P3P, small SPD solves, and the CUDA
                         kernels (ops/kernels.py, ops/_build.py)
  vo_tpu_torch.models  — fixed-capacity feature table, sliding-window BA,
                         bootstrap + per-frame step with the klt, harris and
                         sift trackers (one sequence, or B lanes in lockstep),
                         keyframe database, Sim(3) pose graph, back-end
  vo_tpu_torch.parallel — lockstep multi-sequence rollout (multiseq.py)
  vo_tpu_torch.data    — synthetic-city generators and on-device renderer,
                         the multi-sequence lane set, ATE/RPE
  vo_tpu_torch.utils   — the VOConfig tree, checkpoint / resume, text HUD
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
