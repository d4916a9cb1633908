"""What the reference and the harness import: the reference nothing of
the program, and nothing anywhere JAX or the JAX package."""

import ast
import json
import pathlib

import pytest

from benchmark.registry import REFERENCE_MODULES
from conftest import ROOT

BENCH = ROOT / "benchmark"


def _plugins() -> list:
    """The world modules and the reference packages' modules, relative to
    ``benchmark/``: the defaults, and those that the configurations under
    ``benchmark/`` (the cells' and the tests') name."""
    starts = {"world.py"} | {f"reference/{m}.py" for m in REFERENCE_MODULES}
    for path in sorted(BENCH.glob("configs/*.json")) + sorted(BENCH.glob("tests/data/*.json")):
        cfg = json.loads(path.read_text())
        if "world" in cfg:
            starts.add(str(pathlib.PurePosixPath(cfg["world"]).relative_to("benchmark")))
        if "reference" in cfg:
            pkg = pathlib.PurePosixPath(cfg["reference"]).relative_to("benchmark")
            starts |= {f"{pkg}/{m}.py" for m in REFERENCE_MODULES}
    return sorted(starts)


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _local_closure(start: pathlib.Path) -> set:
    """The benchmark's own modules that ``start`` loads, itself included."""
    seen, todo = set(), [start]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if node.level:  # relative, inside a reference package
                    base = path.parent
                    mods = [node.module] if node.module else [a.name for a in node.names]
                    for m in mods:
                        todo.append(base / f"{m.replace('.', '/')}.py")
                elif node.module and node.module.startswith("benchmark"):
                    mod = node.module
                    cand = [ROOT / f"{mod.replace('.', '/')}.py"]
                    cand += [ROOT / f"{mod.replace('.', '/')}/{a.name}.py" for a in node.names]
                    todo += [c for c in cand if c.is_file()]
    return seen


def test_the_test_configurations_world_module_is_covered():
    assert "tests/data/textured_world.py" in _plugins()


@pytest.mark.parametrize("start", ["check.py", "registry.py", "traffic.py", "roofline.py",
                                   *_plugins()])
def test_reference_imports_nothing_of_the_program(start):
    for path in _local_closure(BENCH / start):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert "myraytracer_tpu_torch" not in tops, path
        assert not tops & {"jax", "jaxlib", "flax", "myraytracer_tpu"}, path


def test_no_file_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "myraytracer_tpu"}, path


def test_only_run_loads_the_program():
    users = {p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")
             if "myraytracer_tpu_torch" in {n.split(".")[0] for n in _imports(p)}}
    assert users <= {"run.py", "tests/test_benchmark_run.py", "tests/test_benchmark_mesh.py"}
