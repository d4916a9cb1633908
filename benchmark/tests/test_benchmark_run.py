"""A whole run of each cell on the CPU, through the harness, on the
program's plain integrator at a test's size: the result line's keys, a
correct check, and a check that comes out false when the timed path is
broken underneath it."""

import json
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from benchmark import run
from conftest import CELLS, run_tiny


@pytest.mark.parametrize("name", CELLS)
def test_result_line(reg, program, name):
    out = run_tiny(reg, program, name)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["fb_max_abs_diff"]["value"] == 0.0
    assert out["checks"]["segs_rel_gap"]["value"] == 0.0
    names = {m["name"] for m in reg.cell(name).end_to_end}
    assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(out)
    lines = run.check_lines(out["checks"])
    assert [ln.split(":")[0] for ln in lines] == ["check fb_max_abs_diff", "check segs_rel_gap"]


def _unchanged(session):
    """Each step returns the state as it was (after as long as a tiny
    frame takes, so that the window holds a test's number of frames)."""
    def step():
        time.sleep(0.02)
        return session.framebuffer
    session.step = step


def _half_samples(session):
    """Each frame's image is the mean of the first half of its samples."""
    from myraytracer_tpu_torch.render import integrator

    cfg = session.config
    session._render = integrator.make_renderer(
        session.world.camera, session.width, session.height, cfg.samples_per_frame // 2,
        cfg.ray_depth, frames=session.frame_batch)


def _half_rows(session):
    """Half of each frame's rows left out, filled from the rows kept."""
    render = session._render

    def rows(scene, key, cursor):
        img, segs = render(scene, key, cursor)
        img = img.clone()
        if img.dim() == 3:
            img[1::2] = img[0::2][: img[1::2].shape[0]]
        else:
            img[..., 1::2, :] = img[..., 0::2, :][..., : img.shape[-2] // 2, :]
        return img, segs * 0.5
    session._render = rows


def _altered(session):
    """Every pixel of every image moved by one ulp where it is produced."""
    render = session._render

    def nudged(scene, key, cursor):
        img, segs = render(scene, key, cursor)
        return torch.nextafter(img, torch.full_like(img, float("inf"))), segs
    session._render = nudged


FAULTS = {"unchanged": _unchanged, "half_rows": _half_rows, "altered": _altered,
          "half_samples": _half_samples}


@pytest.mark.parametrize("name,fault", [
    (c, f) for c in CELLS for f in ("unchanged", "half_rows", "altered")
] + [("final.offline", "half_samples"), ("cornell.offline", "half_samples")])
def test_fault_is_caught(reg, program, name, fault):
    out = run_tiny(reg, program, name, on_session=FAULTS[fault])
    assert out["correct"] is False
    assert out["checks"]["fb_max_abs_diff"]["value"] > 0.0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(reg, program, name):
    """The reference computed in bfloat16, put in the program's place,
    fails the check."""
    out = run_tiny(reg, program, name, control=True)
    ctl = out["control_checks"]
    assert ctl["fb_max_abs_diff"]["value"] > ctl["fb_max_abs_diff"]["limit"]
    assert np.isfinite(out["checks"]["segs_rel_gap"]["value"])


def test_forbidden_modules_after_imports():
    """After a run's imports no top-level module is JAX's or the JAX
    package's."""
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import run; run.load_program(); "
            "import benchmark.check; print(run.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    """``myraytracer_tpu_torch`` begins with ``myraytracer_tpu`` and is no
    match; ``myraytracer_tpu.x`` and ``jaxlib`` are."""
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "myraytracer_tpu_torch_fake", types.ModuleType("f"))
    monkeypatch.setitem(sys.modules, "jaxlibx", types.ModuleType("f"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "myraytracer_tpu.render", types.ModuleType("f"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("f"))
    assert run.forbidden_modules() == ["jaxlib", "myraytracer_tpu"]
