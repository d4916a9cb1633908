"""Everything the harness runs, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics. A cell's configuration is the file its ``configs`` entry
names; its traffic mix is ``benchmark/traffic/<traffic>.json``; its
correctness limits are ``benchmark/limits/<cell>.json``; a per-layer
metric's reader is ``benchmark/metrics/<metric>.py``, whose ``read(ctx)``
returns the metric's value or None when it finds nothing to read. A new
cell, mix or metric is new files and entries, and no edit.

A configuration file may also name its own world and its own reference,
each by a path relative to the checkout that lies under ``benchmark/``:

- ``"world"``: a module that defines ``build_world(cfg, api)``, the
  configuration's world made of ``api``'s classes, and ``views(cfg,
  traffic, api)``, the cameras the traffic moves through. Without the
  key: ``benchmark/world.py``, whose ``views`` is ``traffic.views``.
- ``"reference"``: a package directory laid out like
  ``benchmark/reference/``, holding every module of ``REFERENCE_MODULES``
  (the ones ``check.py`` uses) and what they import, its own modules
  imported relatively, in plain torch and numpy, importing nothing of the
  program, of JAX or of the JAX package. It is loaded under a module name
  of its own, so it never falls back on ``benchmark.reference``. Without
  the key: ``benchmark.reference``, imported as a package.

So a scene that needs what the shared world module or the shared
reference lacks (a material, a primitive, a camera's shutter) comes in as
new files: its configuration, its world module and its reference copy.
Like every file of the benchmark, a world module and a reference copy are
frozen once a cell that uses them is accepted. ``Registry.cell`` refuses,
naming the path and before any set-up, a path outside ``benchmark/``, a
world module that lacks ``build_world`` or ``views``, and a package that
lacks one of ``REFERENCE_MODULES`` or imports ``benchmark`` absolutely.
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import json
import pathlib
import re
import sys
import types
from typing import NamedTuple, Optional

HERE = pathlib.Path(__file__).resolve().parent

# The modules of a reference package that ``check.py`` uses.
REFERENCE_MODULES = ("adaptive", "api", "camera", "compile", "gates", "hit", "integrator",
                     "lights", "rng", "vec")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    world: types.ModuleType  # build_world(cfg, api), views(cfg, traffic, api)
    reference: types.ModuleType  # the reference package, REFERENCE_MODULES imported


def _reports(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed, or, with no list,
    the cell reports the end-to-end metric it moves (or is end-to-end)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def _under_benchmark(root: pathlib.Path, key: str, rel) -> pathlib.Path:
    """``rel``, a configuration's ``key``, resolved in the checkout ``root``;
    refused unless it lies under ``benchmark/``."""
    bench = (root / "benchmark").resolve()
    if not isinstance(rel, str) or not rel or pathlib.PurePath(rel).is_absolute():
        raise ValueError(f"{key} {rel!r}: not a path relative to the checkout")
    path = (root / rel).resolve()
    if path == bench or not path.is_relative_to(bench):
        raise ValueError(f"{key} {rel!r}: the path lies outside benchmark/")
    return path


def _module_name(prefix: str, rel: str) -> str:
    """A module name of its own for the file or package at ``rel``."""
    return prefix + re.sub(r"\W", "_", rel.strip("/"))


def world_module(root: pathlib.Path, rel: Optional[str] = None) -> types.ModuleType:
    """The world module a configuration names (``rel``), or
    ``benchmark.world`` without one."""
    if rel is None:
        return importlib.import_module("benchmark.world")
    path = _under_benchmark(root, "world", rel)
    if path.suffix != ".py" or not path.is_file():
        raise ValueError(f"world {rel!r}: no such module")
    name = _module_name("benchmark_world_", rel)
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    missing = [f for f in ("build_world", "views") if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"world {rel!r}: the module lacks {', '.join(missing)}")
    return mod


def _absolute_benchmark_imports(path: pathlib.Path) -> list:
    """The module's absolute imports of ``benchmark``."""
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if a.name.split(".")[0] == "benchmark"]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module.split(".")[0] == "benchmark":
            found.append(node.module)
    return found


def reference_package(root: pathlib.Path, rel: Optional[str] = None) -> types.ModuleType:
    """The reference package a configuration names (``rel``), or
    ``benchmark.reference`` without one; either way with every module of
    ``REFERENCE_MODULES`` imported, as ``pkg.<module>``."""
    if rel is None:
        name = "benchmark.reference"
    else:
        path = _under_benchmark(root, "reference", rel)
        if not (path / "__init__.py").is_file():
            raise ValueError(f"reference {rel!r}: not a package (no __init__.py)")
        missing = [m for m in REFERENCE_MODULES if not (path / f"{m}.py").is_file()]
        if missing:
            raise ValueError(f"reference {rel!r}: the package lacks {', '.join(missing)}")
        for src in sorted(path.glob("*.py")):
            if found := _absolute_benchmark_imports(src):
                raise ValueError(f"reference {rel!r}: {src.name} imports {', '.join(found)}; "
                                 "a copy imports its own modules relatively")
        name = _module_name("benchmark_reference_", rel)
        if name not in sys.modules:
            spec = importlib.util.spec_from_file_location(
                name, path / "__init__.py", submodule_search_locations=[str(path)])
            pkg = importlib.util.module_from_spec(spec)
            sys.modules[name] = pkg  # before it runs, so its relative imports resolve in it
            spec.loader.exec_module(pkg)
    pkg = importlib.import_module(name)
    for m in REFERENCE_MODULES:
        importlib.import_module(f"{name}.{m}")
    return pkg


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
        world = world_module(self.root, config.get("world"))
        reference = reference_package(self.root, config.get("reference"))
        traffic = json.loads((self.dir / "traffic" / f"{w['traffic']}.json").read_text())
        limits = json.loads((self.dir / "limits" / f"{name}.json").read_text())
        e2e = [m for m in self.bench["end_to_end"] if _reports(m, name, set())]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in self.bench["per_layer"] if _reports(m, name, reported)]
        return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer, world,
                    reference)

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
        path = self.dir / "metrics" / f"{metric}.py"
        name = "benchmark_metric_" + metric.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
