"""Host-side data layer: dataset loaders, prefetch, trajectory evaluation;
the synthetic city renders on the device (data/synthetic.py)."""

from vo_tpu_torch.data.evaluate import align_umeyama, ate_rmse, rpe
from vo_tpu_torch.data.loaders import Sequence

__all__ = ["Sequence", "ate_rmse", "align_umeyama", "rpe"]
