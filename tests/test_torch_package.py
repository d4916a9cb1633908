"""Packaging of the PyTorch port: no JAX at run time, and the kernel build."""

import os
import pathlib
import subprocess
import sys

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
import myraytracer_tpu_torch.kernels.trace
from myraytracer_tpu_torch.render.adaptive import AdaptiveSession
a = AdaptiveSession(get_scene("defocus"), RenderConfig(width=8, height=4, ray_depth=3,
                                                       backend="torch"))
a.step()
assert a.framebuffer.shape == (4, 8, 3) and float(a.framebuffer.mean()) > 0
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


def test_nvcc_command_targets_hopper_without_fast_math():
    cmd = ktrace.nvcc_command("nvcc", ktrace.SOURCE, pathlib.Path("out.so"))
    text = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in text
    assert "-fmad=false" in cmd
    assert "use_fast_math" not in text and "ftz=true" not in text
    assert cmd[-1] == str(ktrace.SOURCE) and ktrace.SOURCE.exists()
    assert "-shared" in cmd and "-fPIC" in cmd


def test_build_is_keyed_by_source_and_flags():
    lib = ktrace.library_path()
    assert lib.parent == REPO / "build" / "kernels"
    assert lib.name.startswith("trace_") and lib.suffix == ".so"
    assert ktrace.library_path() == lib  # stable for one source
