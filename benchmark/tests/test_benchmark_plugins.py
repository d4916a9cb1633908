"""A configuration's own world module and reference package: a cell that
names neither reads what it read when the harness imported
``benchmark/world.py`` and ``benchmark.reference`` directly; one that names
both (``tests/data/textured_final.json``, in no cell of BENCHMARK.json)
runs end to end and is exact; and the registry refuses what a cell must
not load."""

import importlib
import json

import numpy as np
import pytest

import benchmark.reference as direct_reference
import benchmark.world as direct_world
from benchmark import check, registry, run, traffic
from conftest import ADAPTIVE_CELLS, CELLS, MESH_CELLS, ROOT, SEED, tiny, tiny_adaptive, tiny_mesh

ALL_CELLS = CELLS + ADAPTIVE_CELLS + MESH_CELLS
PLUGIN = "benchmark/tests/data/textured_final.json"


def _registry(config: str, cell: str = "final.offline") -> registry.Registry:
    """The checkout's registry with ``cell`` running the configuration file
    ``config`` in place of its own, under the cell's traffic, limits and
    metrics: a configuration that is in no cell of BENCHMARK.json."""
    reg = registry.Registry(ROOT)
    configs = reg.bench["configs"] + [{"name": "under_test", "file": config}]
    workloads = [dict(w, config="under_test") if w["name"] == cell else w
                 for w in reg.bench["workloads"]]
    reg.bench = dict(reg.bench, configs=configs, workloads=workloads)
    return reg


def _cut(cell):
    if cell.name in ADAPTIVE_CELLS:
        return tiny_adaptive(cell)
    return tiny_mesh(cell) if cell.name in MESH_CELLS else tiny(cell)


def _answers(cell) -> list:
    """Answers of the cut cell's shape, for the reference to read: two
    frames from a cursor past 0, or an adaptive image whose four blocks got
    different windows."""
    cfg = cell.config
    fb = np.zeros((cfg["height"], cfg["width"], 3), np.float32)
    if cell.name not in ADAPTIVE_CELLS:
        return [check.Answer(view=0, sample_start=4, frames=2, spp=2, segments=0.0,
                             framebuffer=fb)]
    spp = cell.traffic["samples_per_window"]
    count = np.array([[2, 1], [1, 3]], np.int64) * spp
    blocks = check.Blocks(start=np.array([[0, 2], [4, 0]], np.int64) * spp, count=count,
                          width=64, height=32, samples=int(count.sum()) * 64 * 32,
                          asked=int(count.sum()) * 64 * 32)
    return [check.Answer(view=0, sample_start=0, frames=0, spp=spp, segments=0.0,
                         framebuffer=fb, blocks=blocks)]


@pytest.mark.parametrize("name", ALL_CELLS)
def test_defaults_are_the_direct_imports(reg, name):
    cell = reg.cell(name)
    assert "world" not in cell.config and "reference" not in cell.config
    assert cell.world is direct_world and cell.reference is direct_reference
    for m in registry.REFERENCE_MODULES:
        assert getattr(cell.reference, m) is importlib.import_module(f"benchmark.reference.{m}")


@pytest.mark.parametrize("name", ALL_CELLS)
def test_views_are_the_turntable(reg, name, program):
    cell = reg.cell(name)
    for api in (program.api, cell.reference.api):
        got = cell.world.views(cell.config, cell.traffic, api)
        assert got == traffic.views(cell.config, cell.traffic, api) and got


@pytest.mark.parametrize("name", ALL_CELLS)
def test_reading_is_the_same_through_every_loading(reg, name):
    """The reference's values, segments, samples and tests on a cut of the
    cell: through the package the cell resolves to, through
    ``benchmark.reference`` imported directly, and through the same files
    loaded by path under a name of their own."""
    cell = _cut(reg.cell(name))
    answers = _answers(cell)
    ix, iy = traffic.check_pixels(SEED, cell.config["width"], cell.config["height"], 64)
    copy = registry.reference_package(ROOT, "benchmark/reference")
    readings = [
        check.Reference(cell.config, cell.traffic, SEED, "cpu", world=cell.world,
                        reference=cell.reference).read(answers, ix, iy, count=True),
        check.Reference(cell.config, cell.traffic, SEED, "cpu", world=direct_world,
                        reference=direct_reference).read(answers, ix, iy, count=True),
        check.Reference(cell.config, cell.traffic, SEED, "cpu",
                        reference=copy).read(answers, ix, iy, count=True),
    ]
    want = readings[1]
    assert want.segments > 0 and want.samples > 0 and want.tests["sphere"] > 0
    for got in readings:
        assert np.array_equal(got.values, want.values)
        assert (got.segments, got.samples, got.tests) == (want.segments, want.samples, want.tests)


def test_plugin_is_loaded_under_its_own_names():
    cell = _registry(PLUGIN).cell("final.offline")
    pkg = cell.reference.__name__
    assert pkg != "benchmark.reference" and not pkg.startswith("benchmark.")
    closest = cell.reference.integrator.closest_hit.__module__
    assert closest == f"{pkg}.hit" and not closest.startswith("benchmark.reference")
    assert cell.world.__name__ not in ("benchmark.world", "world")
    world = cell.world.build_world(cell.config, cell.reference.api)
    assert world.texture_set == (cell.reference.api.TEXTURE_CHECKER,
                                 cell.reference.api.TEXTURE_MARBLE)


def test_plugin_runs_and_is_exact(program):
    """The configuration's own world module and reference copy, through
    ``run.run_cell`` on the program's plain integrator: correct and
    bitwise, the segments a sample exact."""
    reg = _registry(PLUGIN)
    cell = tiny(reg.cell("final.offline"))
    assert cell.config["world"] and cell.config["reference"]
    out = run.run_cell(cell, SEED, 0.6, False, program, backend="torch", reg=reg)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["fb_max_abs_diff"]["value"] == 0.0
    assert out["checks"]["segs_rel_gap"]["value"] == 0.0


def test_traced_readers_get_the_whole_count(program, monkeypatch, tmp_path):
    """A traced run hands the readers the reference's whole count, textures
    included, and its segments, beside ``tests_per_segment``."""
    reg = _registry(PLUGIN)
    seen = []
    monkeypatch.setattr(reg, "reader", lambda metric: seen.append)
    cell = tiny(reg.cell("final.offline"))
    run.run_cell(cell, SEED, 0.6, True, program, backend="torch", reg=reg,
                 trace_path=tmp_path / "trace.json")
    ctx = seen[0]
    assert ctx.tests["checker"] > 0 and ctx.tests["marble"] > 0 and ctx.reference_segments > 0
    assert ctx.tests_per_segment == {k: ctx.tests[k] / ctx.reference_segments
                                     for k in ("sphere", "triangle")}


def _refused(tmp_path, **keys) -> str:
    """The message with which ``Registry.cell`` refuses final's
    configuration with ``keys`` added."""
    cfg = json.loads((ROOT / "benchmark/configs/rtiow_final.json").read_text())
    path = tmp_path / "config.json"
    path.write_text(json.dumps(dict(cfg, **keys)))
    with pytest.raises(ValueError) as e:
        _registry(str(path)).cell("final.offline")
    return str(e.value)


@pytest.mark.parametrize("key,path", [
    ("world", "tools/sweep.py"),
    ("world", "benchmark/../bench.py"),
    ("reference", "myraytracer_tpu_torch/render"),
    ("reference", str(ROOT / "benchmark" / "reference")),
])
def test_path_outside_benchmark_is_refused(tmp_path, key, path):
    assert repr(path) in _refused(tmp_path, **{key: path})


def test_world_without_views_is_refused(tmp_path):
    path = "benchmark/tests/data/world_without_views.py"
    msg = _refused(tmp_path, world=path)
    assert repr(path) in msg and "lacks views" in msg


def test_reference_without_gates_is_refused(tmp_path):
    path = "benchmark/tests/data/broken_reference"
    msg = _refused(tmp_path, reference=path)
    assert repr(path) in msg and "lacks gates" in msg


def test_reference_importing_the_shared_one_is_refused(tmp_path, monkeypatch):
    """A copy that imports ``benchmark.reference`` would fall back on it."""
    monkeypatch.setattr(registry, "REFERENCE_MODULES",
                        tuple(m for m in registry.REFERENCE_MODULES if m != "gates"))
    path = "benchmark/tests/data/broken_reference"
    msg = _refused(tmp_path, reference=path)
    assert repr(path) in msg and "hit.py imports benchmark.reference.hit" in msg
