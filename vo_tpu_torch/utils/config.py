"""The VOConfig tree — `vo_tpu/utils/config.py` itself, loaded by file path
(see `vo_tpu_torch/_shared.py`), so the port's defaults are the reference's.

The `use_pallas` fields keep their meaning for the CUDA kernels: None lets
the tensor's device decide (kernel on CUDA, plain PyTorch on CPU), False
forces the plain version (the `--no-pallas` twin), True demands the kernel
and raises for a CPU tensor.
"""

from vo_tpu_torch._shared import load

_config = load("utils/config.py")

BAConfig = _config.BAConfig
BootstrapConfig = _config.BootstrapConfig
DescriptorConfig = _config.DescriptorConfig
DetectorConfig = _config.DetectorConfig
KLTConfig = _config.KLTConfig
PnPConfig = _config.PnPConfig
RecoveryConfig = _config.RecoveryConfig
SiftConfig = _config.SiftConfig
TriangulationConfig = _config.TriangulationConfig
VOConfig = _config.VOConfig

__all__ = [
    "BAConfig",
    "BootstrapConfig",
    "DescriptorConfig",
    "DetectorConfig",
    "KLTConfig",
    "PnPConfig",
    "RecoveryConfig",
    "SiftConfig",
    "TriangulationConfig",
    "VOConfig",
]
