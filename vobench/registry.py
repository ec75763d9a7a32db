"""Where the benchmark finds what a cell is made of, by name.

A cell of BENCHMARK.json names a configuration and a traffic mix; each is
a data file of its own (`configs/<name>.json`, `traffic/<name>.json`), and
the limits of the cell's comparison are `limits/<cell>.json`. A per-layer
metric is a reader of its own, `metrics/<name>.py`, with a function
`read(ctx) -> float | None`. A later change adds a configuration, a mix, a
metric or a cell by adding files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, NamedTuple

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def limits(cell: str, root: Path = ROOT) -> dict:
    return _json(root / "limits" / f"{cell}.json")


def metric(name: str, root: Path = ROOT) -> Callable[[Any], float | None]:
    """The `read` function of `metrics/<name>.py` (a name may hold dots)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vobench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, benchmark: Path = BENCHMARK, root: Path = ROOT) -> Cell:
    """Cell `name` of `benchmark`, with its configuration, mix, limits and
    the metrics it reports."""
    bench = _json(benchmark)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {benchmark}; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=config(w["config"], root), traffic=traffic(w["traffic"], root),
        limits=limits(name, root),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )
