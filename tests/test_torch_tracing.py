"""The port's spans and host-sync counters (``utils/profiling.py``): nesting
and self time, the fixed-size ring, no profiler annotation unless a
profiler records, the annotations in a profiler's Chrome trace, and the
counts of a session's per-frame path on the CPU.

The card's side, that the counters see every sync a frame makes, is
``tests/test_torch_gpu.py::test_host_sync_counters_see_every_sync``."""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import dataclasses
import json

import pytest
import torch

from myraytracer_tpu_torch import cli
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.kernels import trace as ktrace
from myraytracer_tpu_torch.render import dispatch
from myraytracer_tpu_torch.render.session import session_scene
from myraytracer_tpu_torch.scene import presets
from myraytracer_tpu_torch.utils import profiling

CFG = RenderConfig(width=16, height=8, samples_per_frame=1, ray_depth=3, backend="torch")


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture
def clock(monkeypatch):
    """A span clock that moves only when a test says."""
    now = [0]
    monkeypatch.setattr(profiling, "_clock", lambda: now[0])
    return now


def test_spans_nest_and_self_times_add_up(clock):
    with profiling.span("outer"):
        clock[0] += 5
        with profiling.span("a"):
            clock[0] += 7
            with profiling.span("b"):
                clock[0] += 11
        with profiling.span("b"):
            clock[0] += 13
        clock[0] += 3
    spans = profiling.span_stats()["spans"]
    assert spans["outer"]["total_s"] == pytest.approx(39e-9)
    assert spans["outer"]["self_s"] == pytest.approx(8e-9)
    assert spans["a"]["total_s"] == pytest.approx(18e-9)
    assert spans["a"]["self_s"] == pytest.approx(7e-9)
    assert spans["b"]["count"] == 2 and spans["b"]["self_s"] == pytest.approx(24e-9)
    assert spans["outer"]["parents"] == {None: 1}
    assert spans["a"]["parents"] == {"outer": 1}
    assert spans["b"]["parents"] == {"a": 1, "outer": 1}
    # Every nanosecond of the outer span is some span's self time.
    assert sum(s["self_s"] for s in spans.values()) == pytest.approx(spans["outer"]["total_s"])


def test_ring_keeps_the_last_durations(clock):
    """After 5,000 spans the ring holds 4,096, the newest: the median is
    theirs, the count and the total are all 5,000's."""
    for i in range(5000):
        with profiling.span("x"):
            clock[0] += 1000 if i < 5000 - profiling.RING else 10
    assert profiling.RING == 4096
    assert len(profiling._SPANS["x"].ring) == 4096
    stats = profiling.span_stats()["spans"]["x"]
    assert stats["count"] == 5000
    assert stats["median_s"] == pytest.approx(10e-9)
    assert stats["total_s"] == pytest.approx((904 * 1000 + 4096 * 10) * 1e-9)


def test_no_annotation_without_a_profiler(monkeypatch):
    """With no profiler recording, neither a span nor a session's frame
    enters ``record_function`` or its C++ form."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_annotation", refuse)
    with profiling.span("outer"), profiling.host_sync("site"):
        pass
    s = dispatch.make_session(presets.defocus_scene(), CFG)
    s.set_camera(s.camera)
    s.step()
    assert s.segments_traced > 0
    assert {"outer", "site", "session.step", "session.set_camera"} <= set(
        profiling.span_stats()["spans"])


def test_spans_land_in_the_profilers_trace(tmp_path):
    """Under ``torch.profiler`` the spans are annotations in the Chrome
    trace, inside the enclosing annotation, and stay out of the
    aggregates; a host-sync site is counted and not annotated."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.step"):
            with profiling.span("session.step"):
                with profiling.span("session.blend"):
                    torch.ones(8).add_(1)
            with profiling.host_sync("session.segments"):
                pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"}
    outer = events["bench.step"]
    assert "session.segments" not in events
    for name in ("session.step", "session.blend"):
        e = events[name]
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"], name
    step, blend = events["session.step"], events["session.blend"]
    assert step["ts"] <= blend["ts"] and blend["ts"] + blend["dur"] <= step["ts"] + step["dur"]
    stats = profiling.span_stats()
    assert stats["spans"] == {}
    assert stats["syncs"] == {"session.segments": 1}  # a count, kept under a profiler


def test_orbit_loop_counts_its_syncs():
    """set_camera, step and segments_traced, four times, on a CPU session:
    4 ``session.segments`` and 4 ``session.camera_upload`` (a site counts
    its call on every device; on the CPU the copy waits on nothing). A
    second read with nothing pending counts nothing."""
    world = presets.defocus_scene()
    s = dispatch.make_session(world, CFG)
    for i in range(4):
        s.set_camera(dataclasses.replace(world.camera, lookfrom=(0.1 * i, 0.0, 0.0)))
        s.step()
        s.segments_traced
    s.segments_traced
    stats = profiling.span_stats()
    assert stats["syncs"] == {"session.camera_upload": 4, "session.segments": 4}
    spans = stats["spans"]
    assert spans["session.init"]["count"] == 1
    assert spans["session.set_camera"]["count"] == 4
    assert spans["session.camera_upload"]["parents"] == {"session.set_camera": 4}
    assert spans["session.step"]["count"] == 4
    assert spans["session.blend"]["parents"] == {"session.step": 4}
    assert spans["session.segments"]["parents"] == {None: 4}
    assert "trace.launch" not in spans  # the plain integrator launches nothing


def test_nan_check_is_a_counted_sync():
    profiling.enable_debug_nans(True)
    try:
        s = dispatch.make_session(presets.defocus_scene(), CFG)
        s.step()
        s.step()
    finally:
        profiling.enable_debug_nans(False)
    assert profiling.span_stats()["syncs"] == {"session.nan_check": 2}


def test_kernel_renderer_on_the_cpu_builds_tables_once_and_launches_nothing():
    """``kernels.trace``'s renderer on a CPU scene runs the plain version:
    its table build is a ``trace.tables`` span, once a scene, and there is
    no ``trace.launch``, which times the card's launch only."""
    world = presets.defocus_scene()
    scene = session_scene(world, "torch", 8, 4)
    render = ktrace.make_renderer(world.camera, 8, 4, 1, 2)
    for cursor in (0, 1):
        render(scene, (0, 1), cursor)
    spans = profiling.span_stats()["spans"]
    assert spans["trace.tables"]["count"] == 1
    assert "trace.launch" not in spans and "kernel.load" not in spans


def test_profile_trace_carries_the_programs_spans(tmp_path):
    """The CLI's ``--profile`` trace holds the session's spans."""
    logdir = tmp_path / "prof"
    assert cli.main(["--backend", "torch", "--scene", "defocus", "--width", "16", "--height",
                     "8", "--samples-per-frame", "1", "--ray-depth", "2", "--frames", "2",
                     "--profile", str(logdir), "--out", str(tmp_path / "p.png")]) == 0
    events = json.loads((logdir / profiling.TRACE_NAME).read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert {"session.step", "session.blend"} <= names
