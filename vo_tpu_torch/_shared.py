"""Load framework-free modules of the JAX package by file path.

`vo_tpu/__init__.py` imports jax, so any `import vo_tpu.<module>` pulls jax
in — and the machine with the GPU has no jax. A few `vo_tpu` files import
only the standard library and numpy (the config dataclasses, the synthetic
city/texture/path builders, the ATE/RPE evaluator); the port loads exactly
those files from disk under private module names, so their defaults and
algorithms cannot fork from the reference and `vo_tpu/__init__.py` never
runs.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType

_REFERENCE = Path(__file__).resolve().parent.parent / "vo_tpu"


def load(relpath: str) -> ModuleType:
    """Execute `vo_tpu/<relpath>` as the private module
    `vo_tpu_torch._shared.<stem>` and return it (cached in sys.modules)."""
    name = f"{__name__}.{Path(relpath).stem}"
    mod = sys.modules.get(name)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(name, _REFERENCE / relpath)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {_REFERENCE / relpath}")
    mod = importlib.util.module_from_spec(spec)
    # Registered BEFORE exec: dataclasses looks up sys.modules[cls.__module__]
    # while it builds the (frozen) config classes.
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod
