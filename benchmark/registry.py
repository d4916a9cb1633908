"""Everything the harness runs, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics. A cell's configuration is the file its ``configs`` entry
names; its traffic mix is ``benchmark/traffic/<traffic>.json``; its
correctness limits are ``benchmark/limits/<cell>.json``; a per-layer
metric's reader is ``benchmark/metrics/<metric>.py``, whose ``read(ctx)``
returns the metric's value or None when it finds nothing to read. A new
cell, mix or metric is new files and entries, and no edit.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import NamedTuple

HERE = pathlib.Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed, or, with no list,
    the cell reports the end-to-end metric it moves (or is end-to-end)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


class Registry:
    def __init__(self, root: pathlib.Path):
        self.root = pathlib.Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "benchmark"

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        w = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        config = json.loads((self.root / configs[w["config"]]["file"]).read_text())
        traffic = json.loads((self.dir / "traffic" / f"{w['traffic']}.json").read_text())
        limits = json.loads((self.dir / "limits" / f"{name}.json").read_text())
        e2e = [m for m in self.bench["end_to_end"] if _reports(m, name, set())]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in self.bench["per_layer"] if _reports(m, name, reported)]
        return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer)

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
        path = self.dir / "metrics" / f"{metric}.py"
        name = "benchmark_metric_" + metric.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
