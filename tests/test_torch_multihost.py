"""Two processes of the port's CLI joined through ``torch.distributed``.

Each test starts two OS processes of ``python -m myraytracer_tpu_torch
--backend torch --shard tiles --multihost 127.0.0.1:P,2,R`` (collectives on
gloo: the CPU has no NCCL), each with its own ``--out`` and
``--checkpoint`` names, and holds what rank 0 writes bitwise to the
single-process CLI's files on a mesh of the same two stripes; rank 1 writes
nothing. Every process has its own timeout and is killed when it runs
out, so a hung collective fails the test instead of stalling the suite.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from myraytracer_tpu_torch import cli
from myraytracer_tpu_torch.parallel import sharding

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
FLAGS = ["--backend", "torch", "--scene", "three-sphere", "--width", "128", "--height", "64",
         "--samples-per-frame", "2", "--ray-depth", "4", "--shard", "tiles"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp, argv_of):
    """Run rank 0 and rank 1 (``argv_of(rank)``: the CLI's arguments) and
    return their logs; a rank that fails or outlives its timeout fails the
    test, and both are killed. The logs go to files, so a full pipe cannot
    stall a rank inside a collective."""
    spec = f"127.0.0.1:{_free_port()},2"
    # The ranks inherit this process's share of the CPU (``cpu_share``):
    # they share the host with the test's own process and other workers,
    # and torch's spinning thread pools slow down many times over when
    # they ask for more threads than there are cores.
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    logs = [tmp / f"rank{r}-{_free_port()}.log" for r in (0, 1)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "myraytracer_tpu_torch", *argv_of(r),
                 "--multihost", f"{spec},{r}"],
                cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = [log.read_text() for log in logs]
    for r, (p, t) in enumerate(zip(procs, text)):
        assert p.returncode == 0, f"rank {r} failed:\n{t}"
    return text


@pytest.fixture
def two_stripes(monkeypatch):
    """The single-process CLI's mesh as the two ranks' two CPU stripes."""
    orig = sharding.default_mesh
    monkeypatch.setattr(sharding, "default_mesh",
                        lambda devices=None, axis="tiles", device_type=None:
                        orig(["cpu", "cpu"], axis))


def _files(tmp, stem, rank):
    return tmp / f"{stem}{rank}.npy", tmp / f"{stem}{rank}.npz"


@pytest.mark.parametrize("mode", ["uniform", "adaptive"])
def test_two_ranks_write_the_single_process_render_through_a_resume(tmp_path, two_stripes,
                                                                    mode):
    extra = ["--adaptive"] if mode == "adaptive" else []
    frames = ["--frames", "4" if mode == "adaptive" else "3"]

    def first(r):
        out, ck = _files(tmp_path, "a", r)
        return FLAGS + extra + frames + ["--out", str(out), "--checkpoint", str(ck)]

    def resumed(r):
        out, ck = _files(tmp_path, "b", r)
        return FLAGS + extra + ["--frames", "2", "--resume", str(tmp_path / "a0.npz"),
                                "--out", str(out), "--checkpoint", str(ck)]

    logs = run_ranks(tmp_path, first)
    assert all("collectives on gloo" in log for log in logs)
    assert "shard=tiles x2" in logs[0]
    run_ranks(tmp_path, resumed)

    # The same runs in this process, on a mesh of the same two stripes.
    ref = tmp_path / "ref"
    ref.mkdir()
    assert cli.main(first(0)[:-4] + ["--out", str(ref / "a.npy"),
                                     "--checkpoint", str(ref / "a.npz")]) == 0
    assert cli.main(resumed(0)[:-6] + ["--resume", str(ref / "a.npz"),
                                       "--out", str(ref / "b.npy"),
                                       "--checkpoint", str(ref / "b.npz")]) == 0
    for stem in ("a", "b"):
        out, ck = _files(tmp_path, stem, 0)
        np.testing.assert_array_equal(np.load(out), np.load(ref / f"{stem}.npy"))
        with np.load(ck) as got, np.load(ref / f"{stem}.npz") as want:
            assert got.files == want.files
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        # Only rank 0 writes.
        assert not any(p.exists() for p in _files(tmp_path, stem, 1))
