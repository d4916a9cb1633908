"""In-place attribution (``KernelConfig.ABLATE``, ``python -m
myraytracer_tpu_torch.ablate``) and the dense-scene parity stress
(``python -m myraytracer_tpu_torch.parity_stress``) against the JAX
package's ``tools/ablate.py`` and ``tools/parity_stress.py``.

Both tools need a card; here they are held to the JAX tools' names,
defaults and worlds, the ablated builds to their flags and their guards in
``csrc/trace.cu``, and the stress world's render to the JAX jnp oracle.
The card holds each ablated build bitwise the default build
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase q).

Tolerance of the stress render against JAX (32x16, spp 1, depth 4, 901
spheres). Run op by op (``jax.disable_jit()``, so XLA contracts no
multiply-add) it is held as the final-scene parity tests hold it: equal
segments, and pixels within rtol 1e-4, atol 1e-5 on at least 0.98 of the
image with the mean within 1e-4 relative (measured on this CPU: 506 of
512 pixels bit for bit, all but one within rtol 1e-4, atol 1e-5, the
last 1.2e-4 apart where torch's and XLA's CPU ``cos``/``sin`` differ by
ulps; the gated sweep is the ungated one bit for bit here). Jitted, it is
held to the JAX tool's own envelope: segments within 1e-3 relative and
mean |d| under 5e-3 (measured: equal segments, mean |d| 7.1e-7).
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import importlib.util
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu.render.integrator import make_renderer as make_jnp
from myraytracer_tpu.scene import api as japi
from myraytracer_tpu.scene.compile import compile_scene as jcompile
from myraytracer_tpu_torch import ablate, parity_stress
from myraytracer_tpu_torch.config import ABLATE_COMPONENTS, KernelConfig
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.kernels import build as kbuild
from myraytracer_tpu_torch.kernels import trace as ktrace
from myraytracer_tpu_torch.scene import presets as tpresets
from myraytracer_tpu_torch.scene.compile import compile_scene as tcompile

REPO = pathlib.Path(__file__).resolve().parents[1]
STRESS = (32, 16, 1, 4)  # width, height, spp, depth


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- KernelConfig.ABLATE and its builds ---------------------------------------


def test_ablate_accepts_exactly_the_jax_tools_components():
    components = _jax_tool("ablate").COMPONENTS
    assert ABLATE_COMPONENTS == components == ablate.COMPONENTS
    assert KernelConfig(ABLATE=components).ABLATE == components
    for c in components:
        assert KernelConfig(ABLATE=[c]).ABLATE == (c,)
    assert KernelConfig().ABLATE == ()


@pytest.mark.parametrize("bad", [("nope",), ("hit", "Hit"), "hit", ("fetch ",)])
def test_ablate_rejects_other_names(bad):
    with pytest.raises(ValueError, match="unknown components"):
        KernelConfig(ABLATE=bad)


def test_no_ablation_is_the_default_build():
    assert ktrace.kernel_flags(KernelConfig(ABLATE=())) == kbuild.NVCC_FLAGS
    assert kbuild.library_path(ktrace.SOURCE, ktrace.kernel_flags(KernelConfig())) == \
        kbuild.library_path(ktrace.SOURCE)
    assert ktrace.kernels_for(KernelConfig()) == (ktrace.KERNEL, ktrace.ADAPTIVE)
    assert ktrace.KERNEL.flags == ktrace.ADAPTIVE.flags == kbuild.NVCC_FLAGS
    scene = tcompile(tpresets.get_scene("three-sphere"))
    assert ktrace.gate_tables(scene).config.ABLATE == ()
    assert ktrace.gate_tables(scene, KernelConfig(ABLATE=("rng",))).config.ABLATE == ("rng",)


def test_each_mask_is_a_build_and_kernels_of_its_own():
    default = kbuild.library_path(ktrace.SOURCE)
    paths, kernels = {default}, {ktrace.KERNEL, ktrace.ADAPTIVE}
    builds = [(c,) for c in ABLATE_COMPONENTS] + [ABLATE_COMPONENTS]
    for i, b in enumerate(builds):
        mask = ktrace.ablate_mask(b)
        assert mask == (1 << i if i < len(ABLATE_COMPONENTS) else 127)
        flags = ktrace.kernel_flags(KernelConfig(ABLATE=b))
        assert flags == kbuild.NVCC_FLAGS + (f"-DMRT_ABLATE={mask}",)
        paths.add(kbuild.library_path(ktrace.SOURCE, flags))
        uniform, adaptive = ktrace.kernels_for(KernelConfig(ABLATE=b))
        assert uniform.flags == adaptive.flags == flags and uniform.launches == 0
        assert (uniform.symbol, adaptive.symbol) == (ktrace.KERNEL.symbol, ktrace.ADAPTIVE.symbol)
        # one pair a mask
        assert ktrace.kernels_for(KernelConfig(ABLATE=list(reversed(b)))) == (uniform, adaptive)
        kernels |= {uniform, adaptive}
    assert len(paths) == len(builds) + 1 and len(kernels) == 2 * (len(builds) + 1)


def test_every_component_has_its_guard_in_trace_cu():
    src = ktrace.SOURCE.read_text()
    for i, c in enumerate(ABLATE_COMPONENTS):
        name = f"MRT_ABLATE_{c.upper()}"
        (value,) = re.findall(rf"^#define {name} (0x[0-9a-f]+)\b", src, re.M)
        assert int(value, 16) == 1 << i == ktrace.ablate_mask([c])
        assert re.search(rf"^#if MRT_ABLATE & {name}$", src, re.M), name
    # The runtime zero and the code that sets it compile only into an
    # ablated build, so the default Params keeps its layout.
    assert re.search(r"^#if MRT_ABLATE\n  int abl_zero;", src, re.M)
    assert re.search(r"^#if MRT_ABLATE\n  p\.abl_zero = 0;\n#endif", src, re.M)
    assert "#ifndef MRT_ABLATE\n#define MRT_ABLATE 0\n#endif" in src


def test_build_many_starts_one_nvcc_a_build(tmp_path, monkeypatch):
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
    builds = [KernelConfig(ABLATE=b) for b in [(), ("hit",), ABLATE_COMPONENTS]]
    paths = ktrace.build_variants(builds)
    assert len(started) == 3 and [p.parent for p in paths] == [tmp_path] * 3
    assert [c[1:-3] for c in started] == [list(ktrace.kernel_flags(b)) for b in builds]
    assert all(p.exists() and p.with_suffix(".log").exists() for p in paths)
    assert ktrace.build_variants(builds) == paths and len(started) == 3  # built once


def test_registers_and_sass_of_the_variants():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_120trace_spheres_kernelILb1ELb0ELb0EEEvNS_6ParamsE' for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_121trace_adaptive_kernelILb1ELb1ELb1EEEvNS_6ParamsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers",
    ])
    assert ktrace.variant_registers(log) == {"spheres<1,0,0>": (80, 12),
                                             "adaptive<1,1,1>": (72, 0)}
    sass = "\n".join([
        "\tFunction : _ZN12_GLOBAL__N_120trace_spheres_kernelILb1ELb0ELb0EEEvNS_6ParamsE",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;    /* 0x00000a00ff017b82 */",
        "                                                              /* 0x000fe20000000800 */",
        "        /*0010*/                   S2R R0, SR_TID.X ;        /* 0x0000000000007919 */",
        "\tFunction : _ZN12_GLOBAL__N_120trace_spheres_kernelILb0ELb0ELb0EEEvNS_6ParamsE",
        "        /*0000*/                   EXIT ;                    /* 0x000000000000794d */",
    ])
    assert ktrace.sass_instructions(sass) == {"spheres<1,0,0>": 2, "spheres<0,0,0>": 1}


def test_plain_version_ignores_ablate():
    """On the CPU the plain version renders an ablated config bit for bit
    as the default one: a copy is inert by definition."""
    world = tpresets.get_scene("final")
    scene = tcompile(world, spatial_sort=True)
    key = trng.key_from_seed(0)
    out = [ktrace.make_renderer(world.camera, 12, 8, 1, 3, config=cfg)(scene, key, 0)
           for cfg in (None, KernelConfig(ABLATE=ABLATE_COMPONENTS))]
    assert torch.equal(out[0][0], out[1][0]) and float(out[0][1]) == float(out[1][1]) > 0


# -- the tools ----------------------------------------------------------------


def test_ablate_defaults_and_env_are_the_jax_tools():
    src = (REPO / "tools" / "ablate.py").read_text()
    knobs = dict(re.findall(r'"(ABLATE_[A-Z]+)",\s*(?:"([^"]*)"|",")', src))
    assert set(knobs) == {"ABLATE_SPP", "ABLATE_WIDTH", "ABLATE_HEIGHT", "ABLATE_REPS",
                          "ABLATE_COMPONENTS"}
    assert ablate.settings({}) == dict(spp=int(knobs["ABLATE_SPP"]),
                                       width=int(knobs["ABLATE_WIDTH"]),
                                       height=int(knobs["ABLATE_HEIGHT"]),
                                       reps=int(knobs["ABLATE_REPS"]),
                                       components=_jax_tool("ablate").COMPONENTS)
    assert ablate.settings({}) == dict(spp=32, width=1200, height=800, reps=3,
                                       components=ABLATE_COMPONENTS)
    env = dict(ABLATE_SPP="4", ABLATE_WIDTH="96", ABLATE_HEIGHT="64", ABLATE_REPS="2",
               ABLATE_COMPONENTS="hit,,regen")
    assert ablate.settings(env) == dict(spp=4, width=96, height=64, reps=2,
                                        components=("hit", "regen"))
    with pytest.raises(ValueError):
        ablate.settings(dict(ABLATE_COMPONENTS="hit,sweep"))
    assert ablate.DEPTH == 50  # as the JAX tool renders


def _jax_stress_world():
    """``tools/parity_stress.py:44-61``, with the JAX package's api."""
    rng = np.random.default_rng(7)
    mats = [
        japi.Lambertian(albedo=(0.5, 0.4, 0.3)),
        japi.Metal(albedo=(0.9, 0.8, 0.7), fuzz=0.2),
        japi.Dielectric(ior=1.5),
    ]
    spheres = [
        japi.Sphere(center=tuple(map(float, rng.uniform(-12, 12, 3))),
                    radius=float(rng.uniform(0.1, 0.4)), material=mats[i % 3])
        for i in range(900)
    ]
    spheres.append(japi.Sphere(center=(0, -1000.5, 0), radius=1000.0, material=mats[0]))
    return japi.World(tuple(spheres), camera=japi.Camera.reference())


def test_stress_world_is_the_jax_tools():
    got, want = parity_stress.world(), _jax_stress_world()
    assert len(got.spheres) == len(want.spheres) == 901
    for a, b in zip(got.spheres, want.spheres):
        assert tuple(a.center) == tuple(b.center) and a.radius == b.radius
        ma, mb = a.material, b.material
        assert (ma.type_id, type(ma).__name__) == (mb.type_id, type(mb).__name__)
        for field in ("albedo", "fuzz", "ior"):
            assert getattr(ma, field, None) == getattr(mb, field, None), field
    assert got.camera.reference_mode and want.camera.reference_mode
    assert (parity_stress.WIDTH, parity_stress.HEIGHT, parity_stress.SPP,
            parity_stress.DEPTH, parity_stress.MATERIALS) == (128, 64, 2, 8, (1, 2, 3))


@pytest.fixture(scope="module")
def stress_renders():
    """The port's render of the stress world on the CPU (the kernel's
    renderer, so its plain version with the kernel's gates) and the JAX
    oracle's, run op by op and jitted."""
    img, segs, _, _ = parity_stress.render("cpu", *STRESS)
    world = _jax_stress_world()
    oracle = make_jnp(world.camera, *STRESS, material_set=(1, 2, 3))
    scene = jcompile(world, spatial_sort=True)
    key = jrng.key_from_seed(0)
    with jax.disable_jit():
        eager, eager_segs = oracle(scene, key, 0)
    jitted, jit_segs = oracle(scene, key, 0)
    return (img.numpy(), segs, np.asarray(eager), float(eager_segs), np.asarray(jitted),
            float(jit_segs))


def test_stress_render_is_the_eager_jax_oracle(stress_renders):
    got, segs, want, want_segs, _, _ = stress_renders
    assert got.shape == want.shape == (STRESS[1], STRESS[0], 3) and np.isfinite(got).all()
    assert segs == want_segs > 0
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() >= 0.98, close.mean()
    assert abs(got.mean() - want.mean()) <= 1e-4 * abs(want.mean())


def test_stress_render_is_within_the_jax_tools_envelope_of_the_jitted_oracle(stress_renders):
    got, segs, _, _, want, want_segs = stress_renders
    assert abs(segs - want_segs) / want_segs < 1e-3
    assert float(np.abs(got - want).mean()) < 5e-3


@pytest.mark.parametrize("tool,args", [(ablate, ({},)), (ablate, (dict(ABLATE_SPP="1"),)),
                                       (parity_stress, ())])
def test_tools_exit_nonzero_without_a_gpu(tool, args, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(*args) != 0
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA GPU" in err

