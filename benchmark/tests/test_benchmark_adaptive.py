"""The adaptive cell on the CPU, through the harness, on the program's
plain oracle at a test's size: a correct check, the block cursors tracked
across camera moves, a check that comes out false when the timed path is
broken underneath it, the control failing, and the uniform cells' result
lines as they were."""

import numpy as np
import pytest
import torch

from benchmark import check, roofline, run, traffic, world
from conftest import CELLS, SEED, run_tiny, run_tiny_adaptive, tiny_adaptive


def test_result_line(reg, program):
    out = run_tiny_adaptive(reg, program)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["fb_max_abs_diff"]["value"] == 0.0
    assert out["checks"]["segs_rel_gap"]["value"] == 0.0
    assert out["checks"]["samples_gap"]["value"] == 0.0
    assert set(out["metrics"]) == {m["name"] for m in reg.cell("final.adaptive").end_to_end}
    for m in out["metrics"].values():
        assert m["value"] > 0
    assert [ln.split(":")[0] for ln in run.check_lines(out["checks"])] == [
        "check fb_max_abs_diff", "check segs_rel_gap", "check samples_gap"]


def test_cursors_survive_set_camera(reg, program):
    """Each image starts where the last left each block's cursor, the
    second image's cursors are not 0, and the reference judges the second
    image exactly from the cursors the loop tracked."""
    cell = tiny_adaptive(reg.cell("final.adaptive"))
    cfg, tf = cell.config, cell.traffic
    w, h, spp = cfg["width"], cfg["height"], tf["samples_per_window"]
    rc = program.RenderConfig(width=w, height=h, samples_per_frame=spp,
                              ray_depth=cfg["max_depth"], seed=SEED, backend="torch",
                              frame_batch=tf["windows_per_round"], max_frames=tf["budget_frames"])
    session = program.AdaptiveSession(world.build_world(cfg, program.api), rc)
    picker = traffic.Picker(SEED, 2, "last")
    loop = run.AdaptiveLoop(session, traffic.views(cfg, tf, program.api), 3, spp,
                            tf["budget_frames"] * spp * w * h, run.Spans(), picker)
    loop.unit()
    loop.unit()
    first, second = picker.answers()
    assert first.view == 3 and second.view == 4
    assert not first.blocks.start.any()
    assert (second.blocks.start == first.blocks.count).all() and second.blocks.start.all()
    assert loop.rounds > 0
    ix, iy = (a.reshape(-1) for a in np.meshgrid(np.arange(w), np.arange(h)))
    ref = check.Reference(cfg, tf, SEED, "cpu")
    reading = ref.read([second], ix, iy)
    assert check.numbers([second], reading, ix, iy, w, h) == {
        "fb_max_abs_diff": 0.0, "segs_rel_gap": 0.0, "samples_gap": 0.0}


def _wrap_render(session, change):
    render = session._render

    def changed(scene, key, ids, samp0):
        return change(render, scene, key, ids, samp0)
    session._render = changed


def _dropped_window(session):
    """The last window of each launch is lost; its samples are counted."""
    def drop(render, *args):
        sums, segs = render(*args)
        sums = sums.clone()
        sums[-1] = 0.0
        return sums, segs
    _wrap_render(session, drop)


def _shifted_cursor(session):
    """Each block renders the window after the one its cursor names."""
    spp = session.config.samples_per_frame

    def shift(render, scene, key, ids, samp0):
        return render(scene, key, ids, samp0 + spp)
    _wrap_render(session, shift)


def _nudged_pixel(session):
    """Every pixel's sums moved by one ulp where they are produced."""
    def nudge(render, *args):
        sums, segs = render(*args)
        return torch.nextafter(sums, torch.full_like(sums, float("inf"))), segs
    _wrap_render(session, nudge)


def _cursor_reset(session):
    """A camera move sends every block's cursor back to 0."""
    set_camera = session.set_camera

    def moved(cam):
        set_camera(cam)
        session._state = session._state[:5] + (torch.zeros_like(session._state[5]),)
    session.set_camera = moved


def _unchanged(session):
    """Each call leaves the state as it was, and counts its samples."""
    session.fold_round = lambda lidx, ids: None


FAULTS = {"dropped_window": _dropped_window, "shifted_cursor": _shifted_cursor,
          "nudged_pixel": _nudged_pixel, "cursor_reset": _cursor_reset,
          "unchanged": _unchanged}


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_caught(reg, program, fault):
    out = run_tiny_adaptive(reg, program, on_session=FAULTS[fault])
    assert out["correct"] is False
    checks = out["checks"]
    assert any(c["value"] > c["limit"] for c in checks.values())
    if fault == "unchanged":
        assert checks["samples_gap"]["value"] == 1.0
    else:
        assert checks["fb_max_abs_diff"]["value"] > 0.0


def test_control_fails(reg, program):
    """The reference computed in bfloat16, put in the program's place,
    fails the check."""
    out = run_tiny_adaptive(reg, program, control=True)
    ctl = out["control_checks"]
    assert ctl["fb_max_abs_diff"]["value"] > ctl["fb_max_abs_diff"]["limit"]
    assert ctl["samples_gap"]["value"] == 0.0


@pytest.mark.parametrize("name", CELLS)
def test_uniform_cells_keep_their_line(reg, program, name):
    """A uniform cell's result line has the keys, checks and metrics it had
    before the adaptive branch: no adaptive number leaks into it."""
    out = run_tiny(reg, program, name)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "reference_s",
                         "checks"]
    assert list(out["checks"]) == ["fb_max_abs_diff", "segs_rel_gap"]
    assert set(out["metrics"]) == {m["name"] for m in reg.cell(name).end_to_end}
    assert out["correct"] is True


def test_traced_run_reads_the_round(reg, program, tmp_path):
    """A traced CPU run reads the round's host time; the device's metrics
    have no trace of the card to read."""
    out = run.run_cell(tiny_adaptive(reg.cell("final.adaptive")), SEED, 0.3, True, program,
                       backend="torch", reg=reg, trace_path=tmp_path / "trace_a.json")
    assert out["correct"] is True
    assert set(out["metrics"]) == {"adaptive.round_host_ms"}
    assert out["metrics"]["adaptive.round_host_ms"]["value"] > 0


def test_adaptive_bound_takes_the_larger_term():
    tps = {"sphere": 100.0, "triangle": 0.0}
    got = roofline.adaptive_bound_s(tps, 1e9, launches=17, windows=15, n_sel=118,
                                    block_pixels=2048, table_bytes=40_000,
                                    device_name="NVIDIA H100 80GB HBM3")
    assert got == pytest.approx(1e9 * 100 * 25 / 67e12)
    nbytes = 17 * (40_000 + 8 * 118 + 118 * 2048 * (12 * 15 + 4))
    got = roofline.adaptive_bound_s({"sphere": 0.0, "triangle": 0.0}, 1.0, 17, 15, 118, 2048,
                                    40_000, "H100 PCIe")
    assert got == pytest.approx(nbytes / 3.35e12)
    assert roofline.adaptive_bound_s(tps, 1.0, 1, 1, 1, 1, 1, "cpu") is None


def test_fold_is_the_running_mean():
    """The frozen fold of equal windows gives their mean, and a pixel with
    fewer windows stops at its own count."""
    from benchmark.reference import adaptive as radaptive

    sums = torch.full((3, 2, 3), 6.0)
    got = radaptive.fold(sums, torch.tensor([3, 1]), 4)
    assert torch.equal(got, torch.full((2, 3), 1.5))
    assert torch.equal(radaptive.fold(sums, torch.tensor([0, 2]), 4)[0], torch.zeros(3))
