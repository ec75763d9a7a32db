"""The captured runners of the process — the port's counterpart of
vo_tpu/utils/cache.py and of `jax.jit`'s cache.

The JAX package compiles its jitted step once per (config, shapes) and keeps
the executables, on disk too (`enable_compilation_cache`). The port's
counterpart of a compiled program is a captured rollout
(models/graphed.py): the step's segments as CUDA graphs over static
buffers. A `RunnerCache` keeps one per key, so a second rollout under the
same key captures nothing.

The cache lives in the process only: a CUDA graph holds device addresses
of this process and cannot be written to disk. What is worth keeping across
processes, the kernels' build, is cached on disk by ops/_build.py (keyed by
the sources' hash).
"""

from __future__ import annotations

from typing import Any, Callable

from vo_tpu_torch.utils.config import VOConfig


def runner_key(cfg: VOConfig, batch: int, height: int, width: int, dtype, device,
               spans: bool = True) -> tuple:
    """(cfg, lanes, frame height, frame width, frame dtype, device, spans):
    what fixes the shapes, the types and the code a capture records. `cfg`
    holds the capacity, the kernel routing and what decides the graph's
    shape: the recovery on or off (an IF node for R or none) and BA on or
    off (an IF node for C or none); `spans`, the step's span marks and
    counters in the graph or not (models/spans.py)."""
    return (cfg, batch, height, width, dtype, str(device), bool(spans))


class RunnerCache:
    """Runners by `runner_key`; `captures` counts the runners built."""

    def __init__(self) -> None:
        self._runners: dict = {}
        self.captures = 0

    def get(self, key: tuple, build: Callable[[], Any]) -> Any:
        """The runner under `key`, built by `build()` the first time."""
        runner = self._runners.get(key)
        if runner is None:
            runner = self._runners[key] = build()
            self.captures += 1
        return runner

    def runners(self) -> list:
        """Every runner built, in the order they were built."""
        return list(self._runners.values())

    def find(self, key: tuple) -> Any:
        """The runner under `key`, or None: nothing is built."""
        return self._runners.get(key)

    def clear(self) -> None:
        """Drop every runner (their graphs and static buffers go with them)."""
        self._runners.clear()

    def __len__(self) -> int:
        return len(self._runners)


# The process's cache, which `vo_rollout` and `batched_vo_rollout` use.
RUNNERS = RunnerCache()
