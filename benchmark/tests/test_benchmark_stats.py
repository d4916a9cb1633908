"""The end-to-end arithmetic and the per-layer readers on synthetic
readings: a rate over all of the window, a tail over all frames."""

import types

import pytest

from benchmark import stats
from conftest import CELLS


def test_rate_is_all_work_over_all_time():
    # 57 images of 960,000 px x 500 spp in 30.2 s.
    assert stats.rate(57 * 960_000 * 500, 30.2) == pytest.approx(906.0e6, rel=1e-3)


def test_percentile_over_all_frames():
    lat = [0.004] * 90 + [0.010] * 10
    # The 95th percentile of 100 frames lies between the 95th and 96th
    # order statistics: both 10 ms here, not a median of chunks.
    assert stats.percentile(lat, 95.0) == pytest.approx(0.010)
    assert stats.percentile([1.0, 2.0, 3.0, 4.0], 50.0) == pytest.approx(2.5)
    assert stats.percentile([5.0], 95.0) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 95.0)


def _ctx(**kw):
    window = types.SimpleNamespace(seconds=2.0, samples=4e8, answers=100, setup_s=7.5,
                                   latencies=[0.002] * 90 + [0.01] * 10, frames=1600,
                                   launches=100)
    base = dict(cell="final.progressive", window=window, width=1200, height=800,
                device_name="NVIDIA H100 80GB HBM3", spans={"step": [1.0, 3.0], "fetch": [2.0]},
                slice=types.SimpleNamespace(window_s=1.0, busy_s=0.9, trace_kernel_s=0.8,
                                            other_kernel_s=0.08, copy_s=0.02),
                slice_counts={"segs": 1.6e9, "frames": 800, "launches": 50},
                tests_per_segment={"sphere": 150.0, "triangle": 0.0}, table_bytes=40_000)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_end_to_end_readers(reg):
    ctx = _ctx()
    assert reg.reader("msamples_per_s")(ctx) == pytest.approx(200.0)
    assert reg.reader("frame_ms_p95")(ctx) == pytest.approx(10.0)
    assert reg.reader("setup_s")(ctx) == 7.5
    ctx.window.latencies = []
    assert reg.reader("frame_ms_p95")(ctx) is None


def test_per_layer_readers(reg):
    ctx = _ctx()
    assert reg.reader("session.step_host_ms")(ctx) == pytest.approx(2.0)
    assert reg.reader("session.fetch_ms.orbit")(ctx) == pytest.approx(2.0)
    assert reg.reader("session.ops_ms_per_frame")(ctx) == pytest.approx(0.1)
    assert reg.reader("trace.launches_per_frame")(ctx) == pytest.approx(1 / 16)
    assert reg.reader("trace.mrays_per_s")(ctx) == pytest.approx(2000.0)
    assert reg.reader("device.idle_pct")(ctx) == pytest.approx(10.0)
    for name in ("session.ops_ms_per_frame", "trace.mrays_per_s", "device.idle_pct"):
        assert reg.reader(name + ".orbit")(ctx) == reg.reader(name)(ctx)
    # 1.6e9 segments x 150 tests x 25 flop over 67 TFLOP/s.
    bound = 1.6e9 * 150 * 25 / 67e12
    assert reg.reader("trace_spheres_roofline")(ctx) == pytest.approx(100 * bound / 0.8)


@pytest.mark.parametrize("metric", ["session.ops_ms_per_frame", "trace.mrays_per_s",
                                    "trace_spheres_roofline", "device.idle_pct",
                                    "session.ops_ms_per_frame.orbit", "trace.mrays_per_s.orbit",
                                    "device.idle_pct.orbit"])
def test_device_readers_find_nothing_without_a_trace(reg, metric):
    assert reg.reader(metric)(_ctx(slice=None, slice_counts=None)) is None


def test_roofline_reads_nothing_off_the_peak_table(reg):
    assert reg.reader("trace_spheres_roofline")(_ctx(device_name="cpu")) is None


@pytest.mark.parametrize("name", CELLS)
def test_every_metric_of_a_cell_has_a_reader(reg, name):
    cell = reg.cell(name)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(reg.reader(m["name"]))
