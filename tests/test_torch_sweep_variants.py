"""The kernel-config A/B (``python -m myraytracer_tpu_torch.sweep --variants``)
and the sweep's forms it varies (``KernelConfig``'s ``SQRT_GUARD`` ...
``TILE_W``, build options of ``csrc/trace.cu``) against the JAX package's
``tools/sweep.py`` and its kernel's forms.

The tool and the option builds need a card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase r hold each exact build bitwise the default build
there). Here: the variant table against the JAX tool's (read with
``ast.literal_eval``, no JAX import of it), its env defaults and its
per-round ratios (the JAX tool's ``main`` run on stub renders and a stub
clock), the builds' flags and guards, the plain version's forms, and a
small run of the tool on the CPU's plain version.

Tolerance of the rsqrt form against JAX's ``disc * lax.rsqrt(disc)`` on
seeded discriminants: the same misses, and t within rtol 1e-6 (torch's and
XLA's CPU ``rsqrt`` may differ by an ulp).
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import ast
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu_torch import sweep
from myraytracer_tpu_torch.config import SWEEP_WIDTHS, TILE_WIDTHS, KernelConfig
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.core.vec import V3
from myraytracer_tpu_torch.kernels import build as kbuild
from myraytracer_tpu_torch.kernels import trace as ktrace
from myraytracer_tpu_torch.render import hit as thit
from myraytracer_tpu_torch.scene import presets as tpresets
from myraytracer_tpu_torch.scene.compile import compile_scene as tcompile

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_TOOL = REPO / "tools" / "sweep.py"
# Each exact option at a value other than its default.
EXACT = {"SQRT_GUARD": False, "WINDOW_FUSE": True, "SWEEP_WIDTH": 4, "LANE_GATE": False,
         "MERGED_FETCH": True, "STATIC_CAM": True, "TILE_W": 8}


def jax_variants():
    """The JAX tool's ``VARIANTS``, read from its source."""
    tree = ast.parse(JAX_TOOL.read_text())
    (node,) = [n for n in tree.body if isinstance(n, ast.Assign)
               and any(getattr(t, "id", None) == "VARIANTS" for t in n.targets)]
    return ast.literal_eval(node.value)


# -- the variant table ---------------------------------------------------------


def test_jax_names_are_the_ports_variants_or_no_counterpart():
    jax_table = jax_variants()
    names = [n for n, _ in jax_table]
    port = [(n, o) for n, o in sweep.VARIANTS if n not in sweep.PORT_VARIANTS]
    none = [(n, o) for n, o, _ in sweep.NO_COUNTERPART]
    assert len(names) == len(set(names)) == 67
    assert sorted(names) == sorted([n for n, _ in port] + [n for n, _ in none])
    assert (len(port), len(none), len(sweep.PORT_VARIANTS)) == (52, 15, 6)
    assert set(sweep.PORT_VARIANTS) <= {n for n, _ in sweep.VARIANTS}
    jax_of = dict(jax_table)
    for name, overrides in port + none:  # the JAX override dicts, verbatim
        assert overrides == jax_of[name], name
    # The JAX entries keep the JAX tool's order; the port's own come last.
    assert [n for n, _ in port] == [n for n in names if n not in dict(none)]
    assert [n for n, _ in sweep.VARIANTS][len(port):] == list(sweep.PORT_VARIANTS)
    assert sweep.VARIANTS[0] == ("baseline", {})


@pytest.mark.parametrize("name,overrides,reason", sweep.NO_COUNTERPART,
                         ids=[n for n, *_ in sweep.NO_COUNTERPART])
def test_each_no_counterpart_entry_has_a_key_without_one(name, overrides, reason):
    keys = [k for k in overrides if k in sweep.NO_COUNTERPART_KEYS]
    assert keys, name
    assert reason == "; ".join(sweep.NO_COUNTERPART_KEYS[k] for k in keys)


@pytest.mark.parametrize("name,overrides", sweep.VARIANTS, ids=[n for n, _ in sweep.VARIANTS])
def test_every_variant_is_a_config(name, overrides):
    fields = set(KernelConfig.__dataclass_fields__)
    assert set(overrides) <= fields | {"_PARTITION"}, name
    cfg = sweep.config_of(overrides)
    for k, v in overrides.items():
        if k != "_PARTITION":
            assert getattr(cfg, k) == v
    assert not set(overrides) & set(sweep.NO_COUNTERPART_KEYS)


def test_port_variants_are_the_jax_defaults():
    cfg = sweep.config_of(dict(sweep.VARIANTS)["jax-sweep"])
    assert (cfg.SQRT_GUARD, cfg.WINDOW_FUSE, cfg.SWEEP_WIDTH, cfg.MERGED_FETCH,
            cfg.LANE_GATE) == (False, True, 4, True, False)
    src = (REPO / "myraytracer_tpu" / "kernels" / "trace.py").read_text()
    for field, value in (("SQRT_GUARD", "False"), ("WINDOW_FUSE", "True"),
                         ("SWEEP_WIDTH", "4"), ("MERGED_FETCH", "True")):
        assert re.search(rf"^{field} = {value}$", src, re.M), field
    assert re.search(r"^    LANE_GATE: bool = False$", src, re.M)


# -- env and timing ------------------------------------------------------------


def test_env_defaults_are_the_jax_tools():
    src = JAX_TOOL.read_text()
    jax_defaults = dict(re.findall(r'os\.environ\.get\("(SWEEP_\w+)", "([^"]*)"\)', src))
    assert jax_defaults == {"SWEEP_SPP": "32", "SWEEP_REPS": "3", "SWEEP_DEPTH": "50",
                            "SWEEP_SCENE": "final", "SWEEP_WH": "1200x800"}
    assert 'os.environ.get("SWEEP_ONLY")' in src
    s = sweep.settings({})
    assert (s["spp"], s["reps"], s["depth"], s["scene"], s["width"], s["height"]) == (
        32, 3, 50, "final", 1200, 800)
    assert s["variants"] == sweep.VARIANTS
    only = sweep.settings({"SWEEP_ONLY": "w8,baseline,rsqrt"})["variants"]
    assert [n for n, _ in only] == ["baseline", "w8", "rsqrt"]  # the table's order
    with pytest.raises(ValueError, match="no variants"):
        sweep.settings({"SWEEP_ONLY": "baseline,tile8"})


def _run_jax_tool(monkeypatch, capsys, names, times):
    """The JAX tool's ``main`` on stub renders whose calls advance a stub
    clock by ``times[name]`` (seconds: the build call, each round, the
    segment read); its printed lines."""
    import myraytracer_tpu.kernels.trace as jtrace
    import myraytracer_tpu.scene.compile as jcompile

    spec = importlib.util.spec_from_file_location("jax_sweep_tool", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    now = [0.0]
    order = iter(names)

    class Clock:
        @staticmethod
        def perf_counter():
            return now[0]

    def make_renderer(*args, **kw):
        calls = iter(times[next(order)])

        def render(scene, key, sample):
            now[0] += next(calls)
            return np.zeros((2, 2, 3), np.float32), np.float32(1e6)

        return render

    monkeypatch.setattr(mod, "time", Clock)
    monkeypatch.setattr(jtrace, "make_renderer", make_renderer)
    monkeypatch.setattr(jcompile, "compile_scene", lambda *a, **kw: None)
    monkeypatch.setenv("SWEEP_ONLY", ",".join(names))
    monkeypatch.setenv("SWEEP_REPS", str(len(next(iter(times.values()))) - 2))
    assert mod.main() == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("reps", [3, 4])
def test_per_round_ratios_are_the_jax_tools(monkeypatch, capsys, reps):
    rng = np.random.default_rng(reps)
    names = ["baseline", "w2", "chunk32", "rsqrt"]
    times = {n: [float(x) for x in rng.uniform(0.02, 0.05, reps + 2)] for n in names}
    lines = _run_jax_tool(monkeypatch, capsys, names, times)
    rounds = {n: [1e3 * t for t in ts[1:-1]] for n, ts in times.items()}  # ms, as the port's
    ratios = sweep.round_ratios(rounds, "baseline")
    for n in names:
        (line,) = [ln for ln in lines if ln.startswith(f"{n} ")]
        ms = float(line.split()[1])
        assert f"{ms:8.1f}" == f"{sweep.median(rounds[n]):8.1f}", line
        if n == "baseline":
            assert ratios[n] == 1.0 and "%" not in line
        else:
            pct = re.search(r"\(([+-]\d+\.\d)% vs baseline, per-round median\)", line).group(1)
            assert pct == f"{(ratios[n] - 1) * 100:+.1f}", line
    assert sweep.median([3.0, 1.0, 2.0, 4.0]) == 3.0  # the upper median


# -- the builds ----------------------------------------------------------------


def test_the_default_config_is_the_default_build():
    assert ktrace.kernel_flags(KernelConfig()) == ktrace.kernel_flags(None) == kbuild.NVCC_FLAGS
    assert kbuild.library_path(ktrace.SOURCE, ktrace.kernel_flags(KernelConfig())) == \
        kbuild.library_path(ktrace.SOURCE)
    assert ktrace.kernels_for(KernelConfig()) == (ktrace.KERNEL, ktrace.ADAPTIVE)
    # The JAX entries that set the port's own defaults are the default build.
    for name in ("baseline", "guard", "w1", "window-old", "unmerged", "lane-gate", "kd-lane",
                 "chunk32", "morton"):
        cfg = sweep.config_of(dict(sweep.VARIANTS)[name])
        assert ktrace.kernels_for(cfg) == (ktrace.KERNEL, ktrace.ADAPTIVE), name


@pytest.mark.parametrize("field,macro", ktrace.BUILD_OPTIONS,
                         ids=[f for f, _ in ktrace.BUILD_OPTIONS])
def test_each_option_is_a_flag_and_a_build_of_its_own(field, macro):
    value = {"SQRT_RSQRT": True, **EXACT}[field]
    cfg = KernelConfig(**{field: value})
    flags = ktrace.kernel_flags(cfg)
    assert flags == kbuild.NVCC_FLAGS + (f"-D{macro}={int(value)}",)
    uniform, adaptive = ktrace.kernels_for(cfg)
    assert uniform.flags == adaptive.flags == flags
    assert (uniform, adaptive) != (ktrace.KERNEL, ktrace.ADAPTIVE)
    # Gate settings are no build option: equal option sets share one build.
    assert ktrace.kernels_for(KernelConfig(**{field: value}, CULL_CHUNK=32, SUPER=4)) == \
        (uniform, adaptive)
    both = KernelConfig(**{field: value}, ABLATE=("hit",))
    assert ktrace.kernel_flags(both) == kbuild.NVCC_FLAGS + ("-DMRT_ABLATE=1",
                                                             f"-D{macro}={int(value)}")


def test_build_variants_starts_one_nvcc_a_distinct_build(tmp_path, monkeypatch):
    started = []

    class Proc:
        def __init__(self, cmd, **kw):
            started.append(cmd)
            pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
            self.returncode = 0

        def communicate(self):
            return "ptxas info    : Used 80 registers", ""

    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kbuild, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kbuild.subprocess, "Popen", Proc)
    configs = [None, KernelConfig(SWEEP_WIDTH=4), KernelConfig(SWEEP_WIDTH=4, CULL_CHUNK=32),
               KernelConfig(), KernelConfig(TILE_W=8, ABLATE=("hit",))]
    paths = ktrace.build_variants(configs)
    assert len(started) == 3 and paths[0] == paths[3] and paths[1] == paths[2]
    assert [c[1:-3] for c in started] == [list(ktrace.kernel_flags(configs[i])) for i in (0, 1, 4)]
    assert ktrace.build_variants(configs) == paths and len(started) == 3  # built once


def test_every_option_macro_has_its_default_and_its_guard():
    src = ktrace.SOURCE.read_text()
    default = KernelConfig()
    for field, macro in ktrace.BUILD_OPTIONS:
        value = int(getattr(default, field))
        assert f"#ifndef {macro}\n#define {macro} {value}\n#endif" in src, macro
        assert re.search(rf"^#(el)?if .*\b{macro}\b", src, re.M), macro
    # The camera by value and its copy compile only into a STATIC_CAM build.
    assert re.search(r"^#if MRT_STATIC_CAM\n  int cam_static;", src, re.M)


@pytest.mark.parametrize("field,bad", [("SWEEP_WIDTH", 0), ("SWEEP_WIDTH", 3), ("SWEEP_WIDTH", 32),
                                       ("TILE_W", 4), ("TILE_W", 12), ("TILE_W", 64)])
def test_post_init_rejects_a_width_outside_its_set(field, bad):
    with pytest.raises(ValueError, match=field):
        KernelConfig(**{field: bad})
    good = SWEEP_WIDTHS if field == "SWEEP_WIDTH" else TILE_WIDTHS
    for v in good:
        assert getattr(KernelConfig(**{field: v}), field) == v


def test_tables_carry_the_config_and_the_root_form():
    scene = tcompile(tpresets.get_scene("three-sphere"))
    cfg = KernelConfig(SQRT_RSQRT=True, SWEEP_WIDTH=8)
    tables = ktrace.gate_tables(scene, cfg)
    assert tables.config is cfg and tables.gates.sqrt_rsqrt
    assert not ktrace.gate_tables(scene).gates.sqrt_rsqrt
    assert ktrace.gate_tables(scene).config == KernelConfig()


def test_static_cam_renderer_takes_the_construction_cameras_host_copy():
    world = tpresets.get_scene("final")
    packed = ktrace._runtime_cam(world.camera, 12, 8, static=True)
    scene = tcompile(world, spatial_sort=True)
    moved = scene._replace(cam=torch.zeros(19))
    for s in (scene, moved):  # whatever the scene carries, as JAX bakes it
        cam = packed(s)
        assert cam.device.type == "cpu" and torch.equal(
            cam, torch.from_numpy(ktrace.cam_mod.pack_camera(world.camera, 12, 8)))
    assert ktrace._runtime_cam(world.camera, 12, 8)(moved) is moved.cam
    assert ktrace._runtime_cam(tpresets.get_scene("reference").camera, 12, 8, True)(scene) is None


# -- the plain version ---------------------------------------------------------


@pytest.mark.parametrize("field", sorted(EXACT))
def test_plain_version_ignores_the_exact_options(field):
    """Each exact option renders, on the CPU's plain version, the default
    config's image and segments bit for bit."""
    world = tpresets.get_scene("final")
    scene = tcompile(world, spatial_sort=True)
    key = trng.key_from_seed(0)
    out = [ktrace.make_renderer(world.camera, 12, 8, 1, 3, config=cfg)(scene, key, 0)
           for cfg in (KernelConfig(), KernelConfig(**{field: EXACT[field]}))]
    assert torch.equal(out[0][0], out[1][0]) and float(out[0][1]) == float(out[1][1])


def _tangent_rays():
    """Seeded rays against seeded spheres, with discriminants below, at and
    above zero (exact tangents: rays offset by the radius along an axis)."""
    rng = np.random.default_rng(17)
    n = 256
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    o[:, 2] = 6.0
    d = np.tile(np.float32([0, 0, -1]), (n, 1))
    d[: n // 2] = rng.normal(size=(n // 2, 3)).astype(np.float32)
    d[: n // 2, 2] = -np.abs(d[: n // 2, 2]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = rng.uniform(-3, 3, (8, 3)).astype(np.float32)
    c[:, 2] = 0.0
    r = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    r[0] = 1.0
    o[-4:, :2] = c[0, :2] + np.float32([1.0, 0.0])  # grazing sphere 0: disc exactly 0
    return o, d.astype(np.float32), c, r


def test_rsqrt_form_matches_jaxs():
    o, d, c, r = _tangent_rays()
    world = tpresets.get_scene("reference")
    scene = tcompile(world)
    n = c.shape[0]
    scene = scene._replace(
        center=V3(*(torch.from_numpy(np.ascontiguousarray(c[:, k])) for k in range(3))),
        radius=torch.from_numpy(r), radius_sq=torch.from_numpy(r * r))
    ot = V3(*(torch.from_numpy(np.ascontiguousarray(o[:, k])) for k in range(3)))
    dt = V3(*(torch.from_numpy(np.ascontiguousarray(d[:, k])) for k in range(3)))
    t_min, t_max = np.float32(1e-3), np.float32(1e4)
    got = thit._sphere_t(ot, dt, scene, slice(0, n), torch.tensor(t_min), torch.tensor(t_max),
                         rsqrt=True).numpy()
    # The JAX kernel's rsqrt form (trace.py:848-852, 869-881), op by op.
    with jax.disable_jit():
        ocx, ocy, ocz = (jnp.asarray(o[None, :, k]) - jnp.asarray(c[:, None, k]) for k in range(3))
        b = ocx * d[None, :, 0] + ocy * d[None, :, 1] + ocz * d[None, :, 2]
        cc = ocx * ocx + ocy * ocy + ocz * ocz - jnp.asarray((r * r)[:, None])
        disc = b * b - cc
        sq = disc * jax.lax.rsqrt(disc)
        t1, t2 = -b - sq, -b + sq
        t_cand = jnp.where((t1 >= t_min) & (t1 < t_max), t1, t2)
        valid = (disc >= 0.0) & (t_cand >= t_min) & (t_cand < t_max)
        want = np.asarray(jnp.where(valid, t_cand, t_max))
    disc = np.asarray(disc)
    assert (disc == 0).any() and (disc < 0).any() and (disc > 0).any()
    miss = want == t_max
    assert np.array_equal(got == t_max, miss) and miss[disc == 0].all()
    np.testing.assert_allclose(got[~miss], want[~miss], rtol=1e-6, atol=0)
    # The guarded sqrt form keeps the tangent.
    plain = thit._sphere_t(ot, dt, scene, slice(0, n), torch.tensor(t_min),
                           torch.tensor(t_max)).numpy()
    assert (plain[disc == 0] < t_max).any()


# -- the tool ------------------------------------------------------------------


def test_tool_exits_nonzero_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, "-m", "myraytracer_tpu_torch.sweep", "--variants"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA GPU" in proc.stderr
    assert sweep.main(["--bogus"]) == 2


def test_tool_runs_on_the_plain_version(monkeypatch, capsys):
    """The tool's flow at 24x16 on the CPU: every variant checked against
    the plain version, the baseline's image compared, the rounds timed."""
    monkeypatch.setattr(sweep, "CHECK", (12, 8, 1, 3))
    env = {"SWEEP_WH": "24x16", "SWEEP_SPP": "1", "SWEEP_DEPTH": "3", "SWEEP_REPS": "2",
           "SWEEP_ONLY": "baseline,rsqrt,static-cam,chunk32,jax-sweep,no-cull-unrolled"}
    res = sweep.variants_run(sweep.settings(env), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "scene=final 24x16 spp=1 depth=3 reps=2"
    rows = {r["name"]: r for r in res["rows"]}
    assert list(rows) == ["baseline", "static-cam", "chunk32", "no-cull-unrolled", "rsqrt",
                          "jax-sweep"]
    assert res["baseline"] == "baseline" and rows["baseline"]["ratio"] == 1.0
    assert all(len(r["reps_ms"]) == 2 and r["segments"] > 0 for r in rows.values())
    assert rows["rsqrt"]["differing_px"] > 0 and rows["jax-sweep"]["differing_px"] == 0
    assert all(r["check_max_abs"] == 0.0 for r in rows.values())
    assert rows["jax-sweep"]["flags"] == ["-DMRT_SQRT_GUARD=0", "-DMRT_WINDOW_FUSE=1",
                                          "-DMRT_SWEEP_WIDTH=4", "-DMRT_LANE_GATE=0",
                                          "-DMRT_MERGED_FETCH=1"]
    assert sum(ln.startswith("!! rsqrt: differs from baseline") for ln in lines) == 1
    json.dumps(res)
