"""The tests' share of the CPU (``tests/cpu_share.py``) and what it could hide.

Each test process runs torch on ``cpu_share.THREADS`` threads, the CPUs it
may use over the xdist workers that share them, and passes that count on
to the Python processes it starts. With one thread ATen's parallel loops
run inline, so two things no longer show in a pinned worker: the race
that ``core/rng._init_cpu_math`` removes (a process's first parallel math
call, set up from several threads at once, made one stripe differ from the
whole render) and any result that depends on the thread count. The second
test renders in a fresh process with every CPU of its affinity.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

_THREADS_PROBE = """
import os, torch
print(os.environ.get("OMP_NUM_THREADS"), os.environ.get("MKL_NUM_THREADS"), torch.get_num_threads())
"""

# A fresh process's first CPU render is the tile stripes' (one entry of
# ``["cpu"] * ndev`` a stripe); the whole render follows, and the two must
# be bitwise equal with equal segment counts.
_STRIPES_PROBE = """
import os, sys
import torch
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.parallel import sharding as sh
from myraytracer_tpu_torch.render import integrator
from myraytracer_tpu_torch.scene import presets
from myraytracer_tpu_torch.scene.compile import compile_scene

w, h, spp, depth, ndev, batch, frames = map(int, sys.argv[1:])
print("THREADS", torch.get_num_threads(), len(os.sched_getaffinity(0)))
world = presets.get_scene("reference")
scene, key = compile_scene(world), trng.key_from_seed(0)
stripes = sh.make_tile_sharded_renderer(
    world.camera, w, h, spp, depth, sample_batch=batch, mesh=sh.default_mesh(["cpu"] * ndev),
    block_factory="torch", sky=world.ambient, frames=frames)(scene, key, 0)
whole = integrator.make_renderer(world.camera, w, h, spp, depth, sample_batch=batch,
                                 sky=world.ambient, frames=frames)(scene, key, 0)
print("SEGMENTS", float(stripes[1]), float(whole[1]))
print("VALUES_APART", int((stripes[0].numpy() != whole[0].numpy()).sum()))
"""


def _python(code, *args, env=None):
    res = subprocess.run([sys.executable, "-c", code, *map(str, args)], cwd=REPO,
                         env=dict(env or os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_workers_and_their_children_run_their_share_of_the_cpu():
    """Under xdist each of the N workers runs torch on the CPUs of its
    affinity over N threads (at least one), and a Python process it starts
    inherits that count; a file run alone gets every CPU."""
    n = max(1, len(os.sched_getaffinity(0)) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    assert cpu_share.THREADS == n
    assert torch.get_num_threads() == n
    assert _python(_THREADS_PROBE).split() == [str(n), str(n), str(n)]


@pytest.mark.parametrize("w, h, spp, depth, ndev, batch, frames", [
    # test_torch_sharding's tiles: 8 stripes of 2 rows, the last two empty
    (16, 12, 4, 4, 8, 1, 1),
    (16, 12, 4, 4, 8, 1, 2),
    # 2 stripes of 49,152 lanes, past ATen's grain: the loops split
    (128, 96, 8, 4, 2, 8, 1),
])
def test_first_multithreaded_stripes_are_the_whole_render_bitwise(w, h, spp, depth, ndev, batch,
                                                                  frames):
    """The race ``core/rng._init_cpu_math`` removes, and any result that
    depends on the thread count, under torch's default pool: every CPU of
    the child's affinity, whatever this worker's share."""
    cpus = str(len(os.sched_getaffinity(0)))
    env = dict(os.environ, OMP_NUM_THREADS=cpus, MKL_NUM_THREADS=cpus)
    out = _python(_STRIPES_PROBE, w, h, spp, depth, ndev, batch, frames, env=env)
    out = dict(line.split(" ", 1) for line in out.splitlines())
    assert out["THREADS"].split() == [cpus, cpus]
    segments = out["SEGMENTS"].split()
    assert segments[0] == segments[1]
    assert out["VALUES_APART"] == "0"
