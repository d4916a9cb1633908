"""The frozen roofline count and the reading of a profiler trace."""

import numpy as np
import pytest
import torch

from benchmark import check, profiling, roofline, traffic
from conftest import tiny


def test_count_on_a_tiny_world(reg):
    """Tests a segment of the gated sweep on the reference's pixels: every
    segment sweeps the 8 leaders, and no more than the padded table."""
    cell = tiny(reg.cell("final.offline"))
    ref = check.Reference(cell.config, cell.traffic, 5, "cpu")
    ix, iy = traffic.check_pixels(5, 24, 16, 16)
    ans = check.Answer(view=0, sample_start=0, frames=1, spp=4, segments=0.0,
                       framebuffer=np.zeros((16, 24, 3), np.float32))
    r = ref.read([ans], ix, iy, count=True)
    per_seg = r.tests["sphere"] / r.segments
    assert 8 <= per_seg <= ref.tables.n_spheres
    assert r.tests["triangle"] == 0
    assert r.samples == ix.shape[0] * 4
    # 486 spheres padded to 8 leaders + 10 chunks of 48, 10 chunk boxes and
    # 1 outer box... the bytes are the tables' floats.
    t = ref.tables
    assert t.n_spheres == 8 + 48 * 10
    assert t.table_bytes == 4 * (11 * t.n_spheres + 15 * t.n_tris + 6 * t.n_boxes)


def test_cornell_counts_triangles(reg):
    cell = tiny(reg.cell("cornell.offline"))
    ref = check.Reference(cell.config, cell.traffic, 5, "cpu")
    ix, iy = traffic.check_pixels(5, 24, 16, 16)
    ans = check.Answer(view=0, sample_start=8, frames=2, spp=4, segments=0.0,
                       framebuffer=np.zeros((16, 24, 3), np.float32))
    r = ref.read([ans], ix, iy, count=True)
    assert ref.world.triangle_count == 36
    assert r.tests["triangle"] > 0 and r.tests["sphere"] > 0
    assert r.samples == ix.shape[0] * 2 * 4


def test_bound_takes_the_larger_term():
    tps = {"sphere": 100.0, "triangle": 10.0}
    flop = 1e9 * (100 * 25 + 10 * 40)
    got = roofline.bound_s(tps, 1e9, launches=2, frames=32, table_bytes=1000, width=10,
                           height=10, device_name="NVIDIA H100 80GB HBM3")
    assert got == pytest.approx(flop / 67e12)
    nbytes = 2 * (1000 + 400) + 32 * 1200
    got = roofline.bound_s({"sphere": 0.0, "triangle": 0.0}, 1.0, 2, 32, 1000, 10, 10, "H100 PCIe")
    assert got == pytest.approx(nbytes / 3.35e12)
    assert roofline.bound_s(tps, 1.0, 1, 1, 1, 1, 1, "cpu") is None


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_read_trace():
    events = [
        _ev("bench.slice", "user_annotation", 0.0, 1000.0),
        _ev("bench.step", "user_annotation", 0.0, 100.0),
        _ev("bench.fetch", "user_annotation", 600.0, 300.0),
        _ev("void trace_spheres_kernel<1, 0, 0>(Params)", "kernel", 50.0, 450.0),
        _ev("elementwise_kernel", "kernel", 500.0, 100.0),
        _ev("Memcpy DtoH", "gpu_memcpy", 700.0, 100.0),
        _ev("elementwise_kernel", "kernel", 950.0, 100.0),  # clipped at the slice's end
        _ev("cpu op", "cpu_op", 0.0, 1000.0),
    ]
    d = profiling.read_trace(events)
    assert d.window_s == pytest.approx(1e-3)
    assert d.busy_s == pytest.approx((550 + 100 + 50) * 1e-6)
    assert d.trace_kernel_s == pytest.approx(450e-6)
    assert d.other_kernel_s == pytest.approx(150e-6)
    assert d.copy_s == pytest.approx(100e-6)
    assert d.trace_events == 1
    assert d.device_ops[0] == ["void trace_spheres_kernel<1, 0, 0>(Params)", pytest.approx(450e-6)]
    # Gaps: 0-50 in step, 600-700 and 800-950 in fetch.
    assert d.idle_gaps == [["fetch", pytest.approx(150e-6)], ["fetch", pytest.approx(100e-6)],
                           ["step", pytest.approx(50e-6)]]


def test_read_trace_needs_the_slice():
    with pytest.raises(ValueError):
        profiling.read_trace([_ev("k", "kernel", 0.0, 1.0)])


def test_profiler_trace_format(tmp_path):
    """The CPU profiler's chrome trace carries the slice's annotation in
    the form ``read_trace`` reads."""
    path = tmp_path / "t.json"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(profiling.SLICE):
            with torch.profiler.record_function("bench.step"):
                torch.ones(4).sum()
    prof.export_chrome_trace(str(path))
    d = profiling.read_trace_file(path)
    assert d.window_s > 0 and d.busy_s == 0.0
    assert d.idle_gaps[0][0] == "step"


def test_merge_pieces():
    a = profiling.DeviceSlice(1.0, 0.5, 0.4, 0.05, 0.05, 2, [["k", 0.4], ["c", 0.05]],
                              [["fetch", 0.2], ["step", 0.1]])
    b = profiling.DeviceSlice(0.5, 0.5, 0.45, 0.05, 0.0, 3, [["k", 0.45]], [["host", 0.15]])
    m = profiling.merge([a, b])
    assert (m.window_s, m.busy_s, m.trace_events) == (1.5, 1.0, 5)
    assert m.trace_kernel_s == pytest.approx(0.85)
    assert m.device_ops[0] == ["k", pytest.approx(0.85)]
    assert m.idle_gaps == [["fetch", 0.2], ["host", 0.15], ["step", 0.1]]
