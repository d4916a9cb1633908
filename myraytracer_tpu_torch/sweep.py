"""Batch sweeps of the CUDA kernels on one GPU.

    python -m myraytracer_tpu_torch.sweep

The auto policies of ``config.resolve_frame_batch`` and
``config.resolve_adaptive_windows`` come from these numbers, taken on the
final scene at 1200x800, depth 50 (PERF.md):

* frames: the uniform kernel at spp 1 with K in FRAMES frames a launch --
  kernel ms per frame (CUDA events around whole launches) and Mrays/s;
* windows: an adaptive session at spp 8 with F in WINDOWS windows a round
  -- kernel ms per window of one round's launch, and the session's ms per
  round (launch, fold and scores, host clock to a device sync) with its
  Mrays/s;
* staging: the uniform kernel at spp 1 on STAGING_SCENES with the gate
  tables staged in shared memory (the default plan) and left in global
  memory (``KernelConfig(SMEM_LIMIT=0)``: nothing staged), in turns -- what
  the kernel variant that reads its gates from global memory costs.

The sweeps run PASSES times in turn, so drift spreads over every point.
Each measurement is one JSON line on stdout; the line before them gives the
card's name and power limit as ``nvidia-smi`` reports them. It needs a CUDA
GPU and exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from myraytracer_tpu_torch.config import KernelConfig, RenderConfig
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.kernels import trace
from myraytracer_tpu_torch.render.adaptive import (
    AdaptiveSession, _block_scores, select_blocks,
)
from myraytracer_tpu_torch.render.camera import pack_camera
from myraytracer_tpu_torch.render.session import wants_spatial_sort
from myraytracer_tpu_torch.scene.compile import compile_scene
from myraytracer_tpu_torch.scene.presets import get_scene

WIDTH, HEIGHT, DEPTH = 1200, 800, 50
FRAMES = (1, 4, 16, 64)
WINDOWS = (1, 2, 4, 8, 16)
PASSES = 2
STAGING_SCENES = ("final", "spheres:100", "mesh:5")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def scene_args(name: str, width: int, height: int, device):
    """(compiled scene on ``device``, packed camera or None, sky) as the
    session builds them."""
    world = get_scene(name)
    scene = compile_scene(world, spatial_sort=wants_spatial_sort(world), device=device)
    cam = None
    if not world.camera.reference_mode:
        cam = torch.from_numpy(pack_camera(world.camera, width, height)).to(device)
    return scene, cam, world.ambient


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds of ``reps`` calls of ``fn`` on the current stream (CUDA
    events around them all), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def frame_ms(k: int):
    """The uniform kernel on the final scene at spp 1 with ``k`` frames a
    launch, about 64 frames in all: (ms per frame, Mrays/s)."""
    scene, cam, sky = scene_args("final", WIDTH, HEIGHT, "cuda")
    tables = trace.gate_tables(scene)
    key = crng.key_from_seed(0)
    launches = max(1, 64 // k)
    segs = []

    def launch():
        _, s = trace.trace_spheres(scene, cam, key, WIDTH, HEIGHT, 0, HEIGHT, 0, 1,
                                   DEPTH, 1e-3, 1e4, sky, frames=k, tables=tables)
        segs.append(s)

    ms = cuda_ms(launch, launches)
    seg_per_launch = float(segs[-1].sum(dtype=torch.float64).item())
    return ms / (launches * k), seg_per_launch * launches / ms / 1e3


def adaptive_ms(windows: int, rounds: int = 3):
    """An adaptive session on the final scene at spp 8 with ``windows``
    windows a round, after its bootstrap: (kernel ms per window of one
    round's launch, session ms per round over ``rounds`` rounds, session
    Mrays/s, n_sel)."""
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples_per_frame=8,
                       ray_depth=DEPTH, backend="cuda", frame_batch=windows)
    s = AdaptiveSession(get_scene("final"), cfg)
    s.bootstrap()
    _, s1, s2, _, r_b, cursor = s._state
    ids = select_blocks(_block_scores(s1, s2, r_b)[: s.n_blocks], s.n_sel)
    kern = cuda_ms(lambda: s._render(s.scene, s.key, ids, cursor[ids]), 2) / 2
    segs0 = s.segments_traced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        s.step()
    segs = s.segments_traced - segs0  # waits for the rounds
    dt = time.perf_counter() - t0
    return kern / windows, dt * 1e3 / rounds, segs / dt / 1e6, s.n_sel


def staging_ms(name: str, reps: int = 5, width: int = WIDTH, height: int = HEIGHT,
               depth: int = DEPTH) -> dict:
    """The uniform kernel on scene ``name`` at spp 1 with the default
    staging plan and with nothing staged (gate and primitive tables read
    from global memory), ``reps`` one-launch CUDA-event times each, in
    turns, each after a warm-up launch. The two launches must be bitwise equal.
    Returns the plans (gates, spheres, triangles, bytes) and the times."""
    scene, cam, sky = scene_args(name, width, height, "cuda")
    key = crng.key_from_seed(0)
    tables = {"staged": trace.gate_tables(scene),
              "global": trace.gate_tables(scene, KernelConfig(SMEM_LIMIT=0))}
    out, ms = {}, {k: [] for k in tables}

    def launch(k):
        out[k] = trace.trace_spheres(scene, cam, key, width, height, 0, height, 0, 1, depth,
                                     1e-3, 1e4, sky, tables=tables[k])

    for _ in range(reps):
        for k in tables:
            ms[k].append(cuda_ms(lambda: launch(k), 1))
    if not all(torch.equal(a, b) for a, b in zip(out["staged"], out["global"])):
        raise AssertionError(f"{name}: the launch that stages nothing differs from the default")
    return {"scene": name, "width": width, "height": height, "depth": depth,
            "plan": {k: [int(v) for v in trace.staging_of(t, "cuda")] for k, t in tables.items()},
            "ms": ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep: no CUDA GPU", file=sys.stderr)
        return 2
    print(card(), flush=True)
    for rep in range(PASSES):
        for name in STAGING_SCENES:
            print(json.dumps({"sweep": "staging", "rep": rep, **staging_ms(name)}), flush=True)
        for k in FRAMES:
            ms, mrays = frame_ms(k)
            print(json.dumps({"sweep": "frames", "rep": rep, "K": k, "spp": 1,
                              "ms_per_frame": ms, "kernel_mrays_s": mrays}), flush=True)
        for f in WINDOWS:
            kms, rms, mrays, n_sel = adaptive_ms(f)
            print(json.dumps({"sweep": "windows", "rep": rep, "F": f, "spp": 8,
                              "n_sel": n_sel, "kernel_ms_per_window": kms,
                              "session_ms_per_round": rms,
                              "session_mrays_s": mrays}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
