"""The quality A/B tools of the port (``adaptive_bench``, ``qmc_bench``,
``rr_bench``, ``denoise_bench``) and their formulas (``quality.py``).

The formulas are held to the JAX tools': ``rmse`` and ``disp`` imported from
``tools/*.py`` (they import only numpy when loaded), the inline expressions
written out as the oracles. The two JAX forms of the equal-quality fit,
``(e_u sqrt(n) / e)^2`` and ``n (e_u / e)^2``, are one fit rounded in two
orders, so ``quality.equal_quality_spp`` is held to both within 1e-12
relative. Each tool's ``main`` runs on the plain integrator at 16x8 with a
small reference; it must write no file, and its uniform RMSE must fall as
its spp rise.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import builtins
import importlib.util
import json
import pathlib

import numpy as np
import pytest

from myraytracer_tpu_torch import adaptive_bench, denoise_bench, qmc_bench, quality, rr_bench

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _images(seed, shape=(8, 16, 3)):
    rs = np.random.RandomState(seed)
    return (rs.random_sample(shape) * 1.5).astype(np.float32), rs.random_sample(shape).astype(
        np.float32)


@pytest.mark.parametrize("tool", ["adaptive_bench", "qmc_bench", "denoise_bench"])
def test_rmse_is_the_jax_tools(tool):
    a, b = _images(1)
    assert quality.rmse(a, b) == _jax_tool(tool).rmse(a, b)
    assert quality.rmse(a, a) == 0.0


def test_disp_is_the_jax_tools():
    a, _ = _images(2)
    a[0, 0] = [-0.5, 0.001, 2.0]  # clipped, the linear toe, clipped
    np.testing.assert_array_equal(quality.disp(a), _jax_tool("denoise_bench").disp(a))


def test_formulas_are_the_jax_tools_expressions():
    rs = np.random.RandomState(3)
    for _ in range(100):
        n = int(rs.randint(1, 4096))
        e_u, e, e0, e1 = rs.uniform(1e-4, 1.0, size=4)
        t0, t1 = rs.uniform(1e-3, 10.0, size=2)
        # tools/adaptive_bench.py:136-138
        c = e_u * np.sqrt(n)
        assert quality.equal_quality_spp(n, e_u, e) == pytest.approx((c / e) ** 2, rel=1e-12)
        # tools/qmc_bench.py:113
        assert quality.equal_quality_spp(n, e_u, e) == pytest.approx(
            n * (e_u / max(e, 1e-12)) ** 2, rel=1e-12)
        # tools/rr_bench.py:96
        assert quality.rr_win(t0, t1, e0, e1) == (t0 / t1) * (e0 / e1) ** 2
        # tools/denoise_bench.py:119-120
        assert quality.denoise_efficiency(e0, e1) == (e0 / e1) ** 2
        # Raw samples' seconds at the filter's worth over spp samples and a pass.
        assert quality.denoise_wall_clock(n, e0, t0, t1) == pytest.approx(
            n * e0 * t0 / (n * t0 + t1), rel=1e-12)
    assert quality.equal_quality_spp(4, 0.1, 0.0) == 4 * (0.1 / 1e-12) ** 2  # qmc's guard
    assert quality.falls([3.0, 2.0, 1.0]) and not quality.falls([3.0, 3.0, 1.0])


@pytest.mark.parametrize("name,want", [("pallas", "cuda"), ("jnp", "torch"), ("cuda", "cuda"),
                                       ("torch", "torch")])
def test_backend_names(name, want):
    assert quality.backend_name(name) == want


def test_backend_names_refuse_others():
    with pytest.raises(ValueError):
        quality.backend_name("cpu")


@pytest.fixture
def no_writes(monkeypatch, tmp_path):
    """Fail a file opened for writing outside ``tmp_path`` and ``build/``."""
    real_open = builtins.open
    allowed = (tmp_path.resolve(), (REPO / "build").resolve())

    def guarded(file, mode="r", *args, **kwargs):
        if isinstance(file, (str, pathlib.Path)) and any(c in mode for c in "wax+"):
            path = pathlib.Path(file).resolve()
            if not any(path.is_relative_to(a) for a in allowed):
                raise AssertionError(f"a quality tool wrote {path}")
        return real_open(file, mode, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", guarded)
    monkeypatch.chdir(tmp_path)


def _run(tool, env, capsys):
    assert tool.main(env) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_adaptive_bench_on_the_cpu(no_writes, capsys):
    out = _run(adaptive_bench, dict(AB_W="16", AB_H="8", AB_DEPTH="4", AB_SPP="2",
                                    AB_REF_SPP="64", AB_BUDGETS="1,2,4", AB_BACKEND="jnp"),
               capsys)
    rows = out["rows"]
    assert out["backend"] == "torch" and [r["spp"] for r in rows] == [2, 4, 8]
    assert out["warm_calls"] >= 3  # the throwaway session's bootstrap and a round
    assert quality.falls([r["rmse_uniform"] for r in rows])
    for r in rows:
        assert np.isfinite([r["rmse_uniform"], r["rmse_adaptive"]]).all()
        assert r["uniform_spp_needed"] == quality.equal_quality_spp(
            r["spp"], r["rmse_uniform"], r["rmse_adaptive"])
        assert r["calls"] >= 2 and r["adaptive_launches"] is None  # no kernel on the CPU


def test_qmc_bench_on_the_cpu(no_writes, capsys):
    out = _run(qmc_bench, dict(QB_W="16", QB_H="8", QB_DEPTH="4", QB_SPP="1,4,16",
                               QB_REF_SPP="64", QB_BACKEND="torch"), capsys)
    assert [sc["scene"] for sc in out["scenes"]] == ["defocus", "final"]
    for sc in out["scenes"]:
        assert quality.falls([r["rmse_uniform"] for r in sc["rows"]])
        assert all(np.isfinite(r["rmse_qmc"]) and r["t_qmc_s"] > 0 for r in sc["rows"])


def test_rr_bench_on_the_cpu(no_writes, capsys):
    out = _run(rr_bench, dict(RR_WH="16x8", RR_DEPTH="8", RR_SPP="4", RR_REF_SPP="64",
                              RR_N="2", RR_REPS="1", RR_BACKEND="torch"), capsys)
    for sc in out["scenes"]:
        base, rr = sc["rows"]
        assert (base["rr"], rr["rr"]) == (0, 2) and rr["segments"] < base["segments"]
        assert sc["win"] == quality.rr_win(base["t_s"], rr["t_s"], base["rmse"], rr["rmse"])
    # The uniform RMSE at spp 1 and 4 against the same reference: it falls.
    errs = [_run(rr_bench, dict(RR_WH="16x8", RR_DEPTH="8", RR_SPP=spp, RR_REF_SPP="64",
                                RR_N="2", RR_REPS="1", RR_SCENES="final", RR_BACKEND="torch"),
                 capsys)["scenes"][0]["rows"][0]["rmse"] for spp in ("1", "4")]
    assert quality.falls(errs)


def test_denoise_bench_on_the_cpu(no_writes, capsys):
    out = _run(denoise_bench, dict(DB_W="16", DB_H="8", DB_DEPTH="4", DB_SPP="1",
                                   DB_REF_FRAMES="32", DB_FRAMES="1,4,16", DB_ITERS="2,5",
                                   DB_BACKEND="jnp"), capsys)
    assert out["backend"] == "torch" and out["ref_spp"] == 32
    for iters in (2, 5):
        rows = [r for r in out["rows"] if r["iters"] == iters]
        assert [r["spp"] for r in rows] == [1, 4, 16]
        assert quality.falls([r["rmse_raw"] for r in rows])
        assert all(r["efficiency_x"] == quality.denoise_efficiency(r["rmse_raw"], r["rmse_dn"])
                   for r in rows)
        assert all(r["wall_clock_x"] == quality.denoise_wall_clock(
            r["spp"], r["efficiency_disp_x"], out["t_spp_s"], r["filter_s"]) for r in rows)
    assert out["t_spp_s"] > 0
    # No filter pass: the win is the worth, 1.
    assert all(r["wall_clock_x"] == pytest.approx(1.0) for r in out["auto_rows"] if not r["iters"])
    assert [r["spp"] for r in out["auto_rows"]] == [1, 4, 16]
