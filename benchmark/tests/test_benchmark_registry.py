"""The harness finds every configuration, traffic mix, limit file and
metric by name, and a new one is new files and entries only."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import registry
from conftest import ADAPTIVE_CELLS, CELLS, MESH_CELLS, ROOT


def test_benchmark_json_names_every_file(reg):
    bench = reg.bench
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reg.reader(m["name"]))


# Each cell's per-layer metrics, as BENCHMARK.json lists them.
UNIFORM_LAYER = {"session.step_host_ms", "session.ops_ms_per_frame", "trace.launches_per_frame",
                 "trace.mrays_per_s", "trace_spheres_roofline", "device.idle_pct",
                 "session.host_syncs_per_frame", "session.blend_host_ms", "trace.launch_host_ms",
                 "setup.program_s"}
LAYER = {
    "final.offline": UNIFORM_LAYER,
    "cornell.offline": UNIFORM_LAYER,
    "mesh5.offline": {m + ".mesh5" for m in UNIFORM_LAYER - {"setup.program_s"}}
                     | {"setup.program_s"},
    "final.progressive": UNIFORM_LAYER,
    "final.orbit": {"session.fetch_ms.orbit", "session.ops_ms_per_frame.orbit",
                    "trace.mrays_per_s.orbit", "device.idle_pct.orbit",
                    "session.host_syncs_per_frame.orbit", "session.set_camera_host_ms.orbit",
                    "trace.launch_host_ms.orbit", "setup.program_s"},
    "final.adaptive": {"trace.mrays_per_s.adaptive", "device.idle_pct.adaptive",
                       "adaptive.round_host_ms", "adaptive.ops_ms_per_round",
                       "trace_adaptive_roofline"},
}
E2E = {"final.orbit": {"frame_ms_p95", "setup_s"},
       "final.adaptive": {"msamples_per_s.adaptive", "setup_s"},
       "mesh5.offline": {"msamples_per_s.mesh5", "setup_s"}}


@pytest.mark.parametrize("name", CELLS + ADAPTIVE_CELLS + MESH_CELLS)
def test_cell_lookup(reg, name):
    cell = reg.cell(name)
    assert cell.chips == 1
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == E2E.get(name, {"msamples_per_s", "setup_s"})
    assert all(m["moves"] in e2e for m in cell.per_layer)
    assert {m["name"] for m in cell.per_layer} == LAYER[name]


def test_every_cell_is_tested(reg):
    assert {w["name"] for w in reg.bench["workloads"]} == set(CELLS + ADAPTIVE_CELLS + MESH_CELLS) \
        == set(LAYER)


def test_unknown_cell(reg):
    with pytest.raises(KeyError):
        reg.cell("final.nothing")


def test_new_cell_is_files_and_entries_only(tmp_path):
    """A copy of the harness gains a configuration, a traffic mix, a cell
    and a per-layer metric by new files and new entries in BENCHMARK.json:
    no file that was there changes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}

    cfg = json.loads((tmp_path / "benchmark/configs/rtiow_final.json").read_text())
    cfg.update(name="rtiow_final_small", width=64, height=48)
    (tmp_path / "benchmark/configs/rtiow_final_small.json").write_text(json.dumps(cfg))
    traffic = json.loads((tmp_path / "benchmark/traffic/orbit.json").read_text())
    traffic.update(name="orbit4", samples_per_frame=4)
    (tmp_path / "benchmark/traffic/orbit4.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/limits/small.orbit4.json").write_text(
        json.dumps({"fb_max_abs_diff": 0.0, "segs_rel_gap": 0.5}))
    (tmp_path / "benchmark/metrics/window.answers.py").write_text(
        "def read(ctx):\n    return ctx.window.answers\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "rtiow_final_small", "source": "https://example.org",
                             "file": "benchmark/configs/rtiow_final_small.json",
                             "reduced": ["width", "height"], "why": "a test"})
    bench["workloads"].append({"name": "small.orbit4", "config": "rtiow_final_small",
                               "traffic": "orbit4", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "window.answers", "unit": "answers", "better": "higher",
                               "source": "host_clock", "layer": "harness",
                               "moves": "msamples_per_s", "workloads": ["small.orbit4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    reg = registry.Registry(tmp_path)
    cell = reg.cell("small.orbit4")
    assert cell.config["width"] == 64 and cell.traffic["samples_per_frame"] == 4
    assert [m["name"] for m in cell.per_layer] == ["window.answers"]
    assert reg.reader("window.answers")(type("C", (), {"window": type("W", (), {"answers": 3})})) == 3
    assert {p: p.read_bytes() for p in before} == before


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    """Without a CUDA card, or in a directory that holds only the benchmark,
    the command exits non-zero and prints no result."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for cwd in (ROOT, tmp_path):
        proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "final.orbit",
                               "--seed", "3", "--seconds", "1", "--trace", "0"],
                              cwd=cwd, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""
