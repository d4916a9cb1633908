"""The port's measured entry points on the CPU: ``python -m
myraytracer_tpu_torch.bench`` and the goldens recorder
(``myraytracer_tpu_torch.goldens``).

On the card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase n) the
bench times the CUDA kernel and checks its first frame's hash; here it
runs the plain integrator (``BENCH_BACKEND=torch``) at a tiny size, and
the default backend, which is the card, must refuse to run without one.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from myraytracer_tpu_torch import bench, goldens
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.render.dispatch import make_session
from myraytracer_tpu_torch.scene.presets import get_scene
from myraytracer_tpu_torch.utils import hwgolden

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(BENCH_BACKEND="torch", BENCH_WIDTH="16", BENCH_HEIGHT="8", BENCH_SPP="1",
            BENCH_DEPTH="4", BENCH_FRAMES="1", BENCH_WARMUP="0")
KEYS = {"metric", "value", "unit", "vs_baseline", "phases", "golden"}


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_bench_prints_one_line_with_every_key(monkeypatch, capsys, pipeline):
    for k, v in {**TINY, "BENCH_PIPELINE": pipeline}.items():
        monkeypatch.setenv(k, v)
    assert bench.main() == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == KEYS and res["unit"] == "Mrays/s" and res["value"] > 0
    assert set(res["phases"]) == {"build_s", "tables_s", "first_frame_s"}
    assert res["vs_baseline"] is None and res["golden"] is None  # no card, no golden
    assert "backend=torch" in res["metric"] and "device=cpu" in res["metric"]
    per_ray = float(bench.SEGMENTS_LINE.search(err).group(1))
    assert 1.0 <= per_ray <= 5.0


def test_bench_without_a_gpu_exits_nonzero_and_prints_nothing(monkeypatch, capsys):
    for k in ("BENCH_BACKEND", "BENCH_WIDTH", "BENCH_HEIGHT", "BENCH_SPP"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() != 0
    out, err = capsys.readouterr()
    assert out == "" and "is_available() is False" in err
    monkeypatch.setenv("BENCH_BACKEND", "cuda")
    assert bench.main() != 0
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError):  # the render path itself refuses, too
        bench.run(bench.settings({"BENCH_BACKEND": "cuda", "BENCH_WIDTH": "8"}))


def test_bench_defaults():
    card = bench.settings({})
    assert (card["scene"], card["width"], card["height"], card["spp"], card["depth"]) == (
        "final", 1200, 800, 500, 50)
    assert (card["backend"], card["warmup"], card["frames"], card["pipeline"],
            card["record"]) == ("auto", 1, 3, True, False)
    cpu = bench.settings({"BENCH_BACKEND": "torch"})
    assert (cpu["width"], cpu["height"], cpu["spp"], cpu["depth"]) == (200, 112, 2, 50)
    assert bench.headline_key("NVIDIA H100 80GB HBM3") == (
        "final:1200x800:spp500:d50:cuda:eager:NVIDIA H100 80GB HBM3")
    with pytest.raises(ValueError):
        bench.settings({"BENCH_BACKEND": "pallas"})


def test_bench_first_frame_is_the_sessions_frame():
    s = bench.settings(TINY)
    _, first = bench.run(s)
    session = make_session(get_scene("final"), RenderConfig(
        width=16, height=8, samples_per_frame=1, ray_depth=4, backend="torch", frame_batch=1))
    session.step()
    np.testing.assert_array_equal(first, session.framebuffer.numpy())


def _jax_goldens_tool(monkeypatch):
    """``tools/tpu_goldens.py``, imported with its environment change undone
    after the test."""
    monkeypatch.setenv("MYRT_EXPORT_CACHE", "0")
    spec = importlib.util.spec_from_file_location("tpu_goldens", REPO / "tools" / "tpu_goldens.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_goldens_rows_are_the_jax_tools(monkeypatch):
    jtool = _jax_goldens_tool(monkeypatch)
    # Every row on the card: the JAX tool sends earth to its jnp integrator.
    want = [(n, {k: v for k, v in o.items() if k != "backend"}) for n, o in jtool.ROWS]
    assert goldens.ROWS == want
    assert goldens.BASE == {**jtool.BASE, "backend": "cuda"}
    kind = "NVIDIA H100 80GB HBM3"
    for name, overrides in goldens.ROWS:
        cfg = RenderConfig(**{**goldens.BASE, **overrides})
        jcfg = jtool.RenderConfig(**{**jtool.BASE, **overrides, "backend": "cuda"})
        assert goldens.row_key(name, cfg, kind) == jtool.row_key(name, jcfg, kind).replace(
            ":jit:", ":eager:")


def test_goldens_check_rows_on_the_cpu():
    rows = [("earth", {}), ("three-sphere", dict(rr=3, ray_depth=5))]
    base = dict(goldens.BASE, width=16, height=8, samples_per_frame=1, ray_depth=3,
                backend="torch")
    checked = goldens.check_rows({}, "cpu", rows, base)
    assert [s for _, s, _, _ in checked] == ["absent", "absent"]
    assert checked[1][0] == "three-sphere+rr3:16x8:spp1:d5:torch:eager:cpu"
    table = {key: hwgolden.make_entry(digest, 0.0) for key, _, _, digest in checked}
    assert [s for _, s, _, _ in goldens.check_rows(table, "cpu", rows, base)] == ["match"] * 2
    session = make_session(get_scene("earth"), RenderConfig(**{**base, **rows[0][1]}))
    session.step()
    assert checked[0][3] == hwgolden.frame_hash(session.framebuffer.numpy())
    table[checked[0][0]]["hash"] = "0" * 64
    assert goldens.check_rows(table, "cpu", rows[:1], base)[0][1] == "mismatch"


def test_goldens_without_a_gpu_exits_nonzero(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(hwgolden, "DEFAULT_PATH", tmp_path / "t.json")
    assert goldens.main([]) == 3
    assert goldens.main(["--record"]) == 3
    assert "is_available() is False" in capsys.readouterr().err
    assert not (tmp_path / "t.json").exists()
