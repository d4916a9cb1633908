"""Packaging of the PyTorch port: no JAX at run time, and the kernel build."""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import os
import pathlib
import subprocess
import sys

from myraytracer_tpu_torch.kernels import build as kbuild
from myraytracer_tpu_torch.kernels import trace as ktrace

REPO = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import myraytracer_tpu_torch
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.render.dispatch import make_session
from myraytracer_tpu_torch.scene.presets import get_scene
s = make_session(get_scene("defocus"), RenderConfig(width=8, height=4, ray_depth=3,
                                                    backend="torch"))
fb = s.run(1)
assert fb.shape == (4, 8, 3) and float(fb.mean()) > 0
import myraytracer_tpu_torch.cli, myraytracer_tpu_torch.sweep
import myraytracer_tpu_torch.kernels.trace, myraytracer_tpu_torch.kernels.build
from myraytracer_tpu_torch import microbench, mxu_probe
from myraytracer_tpu_torch.kernels import probes
from myraytracer_tpu_torch.render.denoise import Denoiser
assert probes.micro("carry-1-baseline", 1, device="cpu").shape == (1, 16, 128)
d = Denoiser(get_scene("defocus"), 8, 4, iterations=1, device="cpu")
assert d(fb, s.scene.cam).shape == (4, 8, 3)
from myraytracer_tpu_torch.render.adaptive import AdaptiveSession
a = AdaptiveSession(get_scene("defocus"), RenderConfig(width=8, height=4, ray_depth=3,
                                                       backend="torch"))
a.step()
assert a.framebuffer.shape == (4, 8, 3) and float(a.framebuffer.mean()) > 0
import tempfile
from myraytracer_tpu_torch.render.camera import orbit_camera
from myraytracer_tpu_torch.utils.profiling import enable_debug_nans, profile_trace
from myraytracer_tpu_torch.viewer import LiveViewer
v = LiveViewer(0)
v.update(fb.numpy(), 1, 1)
v.close()
s.set_camera(orbit_camera(s.world.camera, 0.5, 0.1, 1.2))
enable_debug_nans(True)
with tempfile.TemporaryDirectory() as d:
    with profile_trace(d):
        s.step()
enable_debug_nans(False)
import numpy as np
from myraytracer_tpu_torch import native
from myraytracer_tpu_torch.native import anchors, bvh_py, cpu_backend, meshdump, obj_py
from myraytracer_tpu_torch.scene.presets import obj_scene
assert native.native_available(), native.native_error()
assert native.build_bvh(np.zeros((3, 3), np.float32), np.ones((3, 3), np.float32)).count.size
with tempfile.TemporaryDirectory() as d:
    open(d + "/t.obj", "w").write("v 0 0 0\\nv 1 0 0\\nv 0 1 0\\nf 1 2 3\\n")
    obj = obj_scene(d + "/t.obj", ground_sphere=True)
c = make_session(obj, RenderConfig(width=8, height=4, ray_depth=3, backend="cpu"))
assert float(c.run(1).mean()) > 0 and c.routing_prediction > 0
from myraytracer_tpu_torch import (adaptive_bench, bench, denoise_bench, goldens, qmc_bench,
                                   quality, rr_bench)
from myraytracer_tpu_torch import (configs, cpu_mesh_baseline, ladder, meshscale, orbit,
                                   sort_probe, stream)
assert sort_probe.keys_of(sort_probe.initial_state(8, 1, "cpu")).shape == (8,)
assert len(orbit.cameras(get_scene("final").camera, 3)) == 3
# Every module of the package, walked (the entry point's __main__ aside).
import importlib, pkgutil
walked = [m.name for m in pkgutil.walk_packages(myraytracer_tpu_torch.__path__,
                                                "myraytracer_tpu_torch.")
          if not m.name.endswith("__main__")]
for name in walked:
    importlib.import_module(name)
tools = ("configs", "stream", "ladder", "meshscale", "cpu_mesh_baseline", "sort_probe", "orbit")
assert all(f"myraytracer_tpu_torch.{t}" in walked for t in tools), walked
from myraytracer_tpu_torch.utils import hwgolden
from myraytracer_tpu_torch.render.session import render
from myraytracer_tpu_torch.render.denoise import make_denoiser
assert render(get_scene("defocus"), RenderConfig(width=8, height=4, ray_depth=3,
                                                 backend="torch")).shape == (4, 8, 3)
assert hwgolden.frame_hash(fb.numpy()) == hwgolden.frame_hash(fb)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "myraytracer_tpu.")))
bad += [m for m in ("myraytracer_tpu", "jaxlib") if m in sys.modules]
print("LOADED", bad)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


def test_chip_smoke_imports_no_jax():
    """The smoke script names neither JAX nor the JAX package in an import,
    and it refuses to run once ``jax`` is loaded."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "myraytracer_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "myraytracer_tpu", "tools"}, roots


def test_nvcc_command_targets_hopper_without_fast_math():
    cmd = kbuild.nvcc_command("nvcc", ktrace.SOURCE, pathlib.Path("out.so"))
    text = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in text
    assert "-fmad=false" in cmd
    assert "use_fast_math" not in text and "ftz=true" not in text
    assert cmd[-1] == str(ktrace.SOURCE) and ktrace.SOURCE.exists()
    assert "-shared" in cmd and "-fPIC" in cmd


def test_build_is_keyed_by_source_and_flags():
    lib = kbuild.library_path(ktrace.SOURCE)
    assert lib.parent == REPO / "build" / "kernels"
    assert lib.name.startswith("trace_") and lib.suffix == ".so"
    assert kbuild.library_path(ktrace.SOURCE) == lib  # stable for one source


def test_every_source_builds_the_same_way():
    """The probes' source is compiled like the trace kernels': the same
    flags, a library keyed by source and flags beside its ptxas report."""
    from myraytracer_tpu_torch.kernels import probes

    assert probes.SOURCE.exists() and probes.SOURCE.parent == ktrace.SOURCE.parent == kbuild.CSRC
    lib = kbuild.library_path(probes.SOURCE)
    assert lib.parent == REPO / "build" / "kernels"
    assert lib.name.startswith("probes_") and lib.suffix == ".so"
    assert lib != kbuild.library_path(ktrace.SOURCE)
    assert kbuild.library_path(probes.SOURCE, ("-O0",)) != lib  # the flags are in the key
    cmd = kbuild.nvcc_command("nvcc", probes.SOURCE, lib)
    assert cmd[1:-3] == list(kbuild.NVCC_FLAGS) and cmd[-1] == str(probes.SOURCE)
    assert {k.source for k in probes.KERNELS.values()} == {probes.SOURCE}
    assert ktrace.KERNEL.source == ktrace.ADAPTIVE.source == ktrace.SOURCE
