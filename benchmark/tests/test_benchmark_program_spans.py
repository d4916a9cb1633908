"""The readers of the program's own spans and host-sync counters
(``benchmark/program_spans.py``): each gives a number after a traced CPU
run of every cell that lists it, and None from fresh aggregates or from a
program without them (one older than its spans)."""

import sys
import types

import pytest

from benchmark import program_spans, registry, run
from conftest import ROOT, SEED, tiny

METRICS = ("session.host_syncs_per_frame", "session.blend_host_ms", "trace.launch_host_ms",
           "session.host_syncs_per_frame.orbit", "session.set_camera_host_ms.orbit",
           "trace.launch_host_ms.orbit", "setup.program_s")


def _profiling():
    return sys.modules[program_spans.PROGRAM_PROFILING]


def _launch_span(session):
    """``trace.launch`` times the card's launch only, and the plain
    integrator of a CPU run launches nothing: the span is made here around
    each render call, so that its readers have one to read."""
    render, span = session._render, _profiling().span

    def launched(*args):
        with span("trace.launch"):
            return render(*args)
    session._render = launched


@pytest.fixture(scope="module")
def traced(reg, program, tmp_path_factory):
    """Each cell's traced CPU run, from fresh aggregates, once."""
    runs = {}

    def of(name):
        if name not in runs:
            _profiling().reset_spans()
            path = tmp_path_factory.mktemp("trace") / f"trace_{name}.json"
            runs[name] = run.run_cell(tiny(reg.cell(name)), SEED, 0.6, True, program,
                                      backend="torch", on_session=_launch_span,
                                      trace_path=path, reg=reg)
        return runs[name]
    return of


def _cases():
    bench = registry.Registry(ROOT).bench
    return [(m["name"], cell) for m in bench["per_layer"] if m["name"] in METRICS
            for cell in m["workloads"]]


@pytest.mark.parametrize("metric,cell", _cases())
def test_reader_reads_a_traced_run(traced, metric, cell):
    out = traced(cell)
    assert out["correct"] is True
    value = out["metrics"][metric]["value"]
    assert value > 0


def test_every_new_metric_has_cells():
    assert {m for m, _ in _cases()} == set(METRICS)


def _ctx():
    return types.SimpleNamespace(window=types.SimpleNamespace(frames=16))


@pytest.mark.parametrize("metric", METRICS)
def test_reader_finds_nothing_in_fresh_aggregates(reg, program, metric):
    _profiling().reset_spans()
    assert reg.reader(metric)(_ctx()) is None


@pytest.mark.parametrize("metric", METRICS)
def test_reader_finds_nothing_in_a_program_without_spans(reg, monkeypatch, metric):
    monkeypatch.setitem(sys.modules, program_spans.PROGRAM_PROFILING,
                        types.ModuleType(program_spans.PROGRAM_PROFILING))
    assert reg.reader(metric)(_ctx()) is None
