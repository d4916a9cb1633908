"""The mesh cell: its configuration is the port's ``mesh:5`` preset written
out as data, the ``icospheres`` key builds the same triangles for the
program and the reference, the other configurations' worlds are as they
were, and a run at a test's size on the CPU is exact, while the control
and a broken timed path fail."""

import hashlib
import json

import numpy as np
import pytest

from benchmark import check, registry, run, traffic, world
from benchmark.reference import api as rapi
from conftest import ROOT, SEED, run_tiny_mesh, tiny_mesh
from myraytracer_tpu_torch.scene import api as papi
from myraytracer_tpu_torch.scene import presets
from test_benchmark_run import FAULTS


def _config(name="baseline_mesh5"):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def _same_scene(got, want):
    """Mesh for mesh: the vertices in float32, the faces in order and the
    materials; the camera and the background; no spheres."""
    assert len(got.meshes) == len(want.meshes)
    for g, w in zip(got.meshes, want.meshes):
        assert np.array_equal(np.asarray(g.vertices, np.float32),
                              np.asarray(w.vertices, np.float32))
        assert np.array_equal(np.asarray(g.triangles), np.asarray(w.triangles))
        assert repr(g.material) == repr(w.material)
    for k in ("lookfrom", "lookat", "vup", "vfov_degrees", "aperture", "focus_dist"):
        assert getattr(got.camera, k) == getattr(want.camera, k), k
    assert got.ambient == want.ambient and not got.spheres and not want.spheres


def test_configuration_is_the_preset():
    got = world.build_world(_config(), papi)
    _same_scene(got, presets.get_scene("mesh:5"))
    assert got.triangle_count == 25_614
    assert [len(m) for m in got.meshes] == [2, 12, 20_480, 5_120]


def test_reference_builds_the_same_triangles():
    cfg = _config()
    _same_scene(world.build_world(cfg, rapi), world.build_world(cfg, papi))


def test_tiny_cut_is_mesh2(reg):
    """The CPU tests' cut of the cell is the preset ``mesh:2``, under the
    512 triangles past which the program's CPU path builds a BVH."""
    cfg = tiny_mesh(reg.cell("mesh5.offline")).config
    got = world.build_world(cfg, papi)
    _same_scene(got, presets.get_scene("mesh:2"))
    assert got.triangle_count == 414


def _digest(w) -> str:
    h = hashlib.sha256()
    for s in w.spheres:
        h.update(repr((s.center, s.radius, s.material)).encode())
    for m in w.meshes:
        h.update(np.asarray(m.vertices, np.float32).tobytes())
        h.update(np.asarray(m.triangles, np.int32).tobytes())
        h.update(repr(m.material).encode())
    h.update(repr((w.camera, w.ambient)).encode())
    return h.hexdigest()


# The worlds of the configurations, as the harness built them before a
# configuration could name its own world module: the first two before the
# icospheres key, baseline_mesh5 when it came.
DIGESTS = {
    "rtiow_final": "452093a4251eea5d639d5077d8212a132f3803bd3392352c087c0dfbae190a05",
    "rttnw_cornell": "49116a978f4c3a0910da1cec443533ab113dee9bd0127bbc2182c43a300b8f5d",
    "baseline_mesh5": "0499a270f4f99dcdce2b8c078a25bbb0ce4d3d410b41612f15ef78394196e926",
}


def _copy_api():
    return registry.reference_package(ROOT, "benchmark/reference").api


@pytest.mark.parametrize("api", [lambda: papi, lambda: rapi, _copy_api],
                         ids=["program", "reference", "reference-by-path"])
@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_other_worlds_are_unchanged(reg, name, api):
    """Each configuration's world, built by the world module its cell
    resolves to, with the program's API, the reference's and a copy of the
    reference's loaded by path."""
    cell = next(w["name"] for w in reg.bench["workloads"] if w["config"] == name)
    built = reg.cell(cell).world.build_world(_config(name), api())
    assert _digest(built) == DIGESTS[name]


def test_result_line(reg, program):
    out = run_tiny_mesh(reg, program)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "reference_s",
                         "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["fb_max_abs_diff"]["value"] == 0.0
    assert out["checks"]["segs_rel_gap"]["value"] == 0.0
    assert set(out["metrics"]) == {m["name"] for m in reg.cell("mesh5.offline").end_to_end}


def test_control_fails(reg, program):
    """The reference computed in bfloat16, put in the program's place,
    fails the check."""
    out = run_tiny_mesh(reg, program, control=True)
    ctl = out["control_checks"]
    assert ctl["fb_max_abs_diff"]["value"] > ctl["fb_max_abs_diff"]["limit"]
    assert out["correct"] is True


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(reg, program, fault):
    out = run_tiny_mesh(reg, program, on_session=FAULTS[fault])
    assert out["correct"] is False
    assert out["checks"]["fb_max_abs_diff"]["value"] > 0.0


def test_sweep_counts_triangle_tests(reg):
    """The roofline's count on the cut scene: every segment tests some
    triangles behind the gates, and no more than the padded table."""
    cell = tiny_mesh(reg.cell("mesh5.offline"))
    ref = check.Reference(cell.config, cell.traffic, 5, "cpu")
    ix, iy = traffic.check_pixels(5, 48, 32, 64)
    ans = check.Answer(view=0, sample_start=0, frames=1, spp=2, segments=0.0,
                       framebuffer=np.zeros((32, 48, 3), np.float32))
    r = ref.read([ans], ix, iy, count=True)
    assert ref.world.triangle_count == 414
    assert 0 < r.tests["triangle"] / r.segments <= ref.tables.n_tris
    assert r.samples == ix.shape[0] * 2


def test_traced_run_reads_the_mesh_copies(reg, program, tmp_path):
    """A traced CPU run reads the cell's host-side per-layer metrics, its
    ``.mesh5`` copies among them; the device's have no trace of the card
    to read."""
    cell = tiny_mesh(reg.cell("mesh5.offline"))
    out = run.run_cell(cell, SEED, 0.6, True, program, backend="torch", reg=reg,
                       trace_path=tmp_path / "trace_m.json")
    assert out["correct"] is True
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {"session.step_host_ms.mesh5", "session.blend_host_ms.mesh5",
            "setup.program_s"} <= set(out["metrics"])
