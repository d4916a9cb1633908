"""The port's benchmark: traced ray segments per second on one CUDA card.

    python -m myraytracer_tpu_torch.bench

The counterpart of the JAX package's root ``bench.py``. It renders the
RTiOW final scene at 1200x800, 500 samples a pixel in one kernel launch,
depth 50 (the headline configuration), through the session's build path
(``compile_scene``, ``dispatch.resolve_backend`` and ``renderer_factory``,
``kernels/trace.make_renderer``, ``csrc/trace.cu:trace_spheres_kernel``),
and prints ONE JSON line on stdout, with detail on stderr:

    {"metric": ..., "value": N, "unit": "Mrays/s", "vs_baseline": r,
     "phases": {"build_s": ..., "tables_s": ..., "first_frame_s": ...},
     "golden": "match" | "mismatch" | "absent" | "recorded" | null}

``value`` counts traced ray segments (shadow rays too) over the timed
frames' wall time. ``vs_baseline`` divides it by the rate recorded beside
this card's headline golden entry (``tests/golden/cuda_hashes.json``,
written by ``BENCH_RECORD_GOLDEN=1``); null where the table has none.
``golden`` checks the first frame's bits against that table
(``utils/hwgolden.py``); null off the card.

Environment knobs (all optional): BENCH_SCENE, BENCH_SPP (samples a pixel
in one launch), BENCH_WIDTH/BENCH_HEIGHT, BENCH_DEPTH, BENCH_BACKEND
(``auto`` = ``cuda``, or ``torch``: the plain integrator on the CPU, by
default at 200x112, spp 2), BENCH_WARMUP (frames before the timed ones, 1),
BENCH_FRAMES (timed frames, 3), BENCH_PIPELINE (1: launch every timed frame,
then force them in order with a host read; 0: each frame alone, timed with
CUDA events), BENCH_RECORD_GOLDEN (1: record the first frame's hash and the
rate). Without a GPU, ``auto`` and ``cuda`` exit non-zero and print no
result; nothing falls back to the CPU.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

import torch

from myraytracer_tpu_torch import quality
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.kernels import trace
from myraytracer_tpu_torch.render import dispatch
from myraytracer_tpu_torch.render.session import session_scene
from myraytracer_tpu_torch.scene.presets import get_scene
from myraytracer_tpu_torch.utils import hwgolden

# The headline configuration (BASELINE.md config 4): its golden entry holds
# the rate vs_baseline divides by.
HEADLINE = dict(scene="final", width=1200, height=800, spp=500, depth=50)
# The plain integrator's default size on the CPU: the JAX bench's off-TPU one.
CPU_SIZE = dict(width=200, height=112, spp=2)
# The stderr line that gives the timed frames' segments a camera ray.
SEGMENTS_LINE = re.compile(r"([0-9.]+) segments/camera ray")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settings(env) -> dict:
    """The run's knobs from the ``BENCH_*`` variables of ``env``."""
    backend = env.get("BENCH_BACKEND", "auto")
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"BENCH_BACKEND={backend!r}: use auto|cuda|torch")
    size = CPU_SIZE if backend == "torch" else HEADLINE
    return dict(
        scene=env.get("BENCH_SCENE", HEADLINE["scene"]),
        width=int(env.get("BENCH_WIDTH", size["width"])),
        height=int(env.get("BENCH_HEIGHT", size["height"])),
        spp=int(env.get("BENCH_SPP", size["spp"])),
        depth=int(env.get("BENCH_DEPTH", HEADLINE["depth"])),
        backend=backend,
        warmup=int(env.get("BENCH_WARMUP", 1)),
        frames=int(env.get("BENCH_FRAMES", 3)),
        pipeline=env.get("BENCH_PIPELINE", "1") != "0",
        record=env.get("BENCH_RECORD_GOLDEN", "0") == "1",
    )


def headline_key(device_kind: str) -> str:
    h = HEADLINE
    return hwgolden.entry_key(h["scene"], h["width"], h["height"], h["spp"], h["depth"],
                              "cuda", device_kind)


def run(s: dict):
    """Build, render and time as ``s`` says: (the result line's dict, the
    first frame [H, W, 3] on the host)."""
    w, h, spp, depth = s["width"], s["height"], s["spp"], s["depth"]
    config = RenderConfig(backend=s["backend"])
    resolved = dispatch.resolve_backend(config)  # raises without a GPU
    on_card = resolved == "cuda"
    phases = {}

    if on_card:
        t0 = time.perf_counter()
        torch.zeros(1, device="cuda")  # the CUDA context, outside the phases
        torch.cuda.synchronize()
        log(f"bench: device init {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    if on_card:
        trace.KERNEL.load()  # nvcc through kernels/build.py, unless built
    phases["build_s"] = round(time.perf_counter() - t0, 3)

    world = get_scene(s["scene"], seed=0)
    t0 = time.perf_counter()
    scene = session_scene(world, resolved, w, h)
    render = quality.renderer(world, resolved, w, h, spp, depth)
    if render.tables is not None:
        render.tables(scene)
    if on_card:
        torch.cuda.synchronize()
    phases["tables_s"] = round(time.perf_counter() - t0, 3)
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    log(f"bench: device={kind} backend={resolved} scene={s['scene']} {w}x{h} spp={spp} "
        f"depth={depth} spheres={len(world.spheres)} triangles={world.triangle_count}")

    key = crng.key_from_seed(config.seed)
    launches0 = trace.KERNEL.launches if on_card else 0
    t0 = time.perf_counter()
    img, _ = render(scene, key, 0)
    first = img.cpu().numpy()  # a host read: waits for the frame
    phases["first_frame_s"] = round(time.perf_counter() - t0, 3)
    log(f"bench: build {phases['build_s']} s, tables {phases['tables_s']} s, first frame "
        f"{phases['first_frame_s']} s")

    for i in range(s["warmup"]):
        t0 = time.perf_counter()
        img, _ = render(scene, key, (i + 1) * spp)
        img.cpu()
        log(f"bench: warm-up frame {time.perf_counter() - t0:.3f} s")

    # Timed frames: distinct sample windows, real progressive work.
    warmed = 1 + s["warmup"]
    windows = range(warmed, warmed + s["frames"])
    rates, total_segs = [], 0.0
    if s["pipeline"]:
        # Launch every frame, then force them in order: host work overlaps
        # the card's, as in the session's accumulation loop. A host read
        # waits for everything queued on the stream, so each frame's end is
        # an event recorded after its launch.
        t0 = time.perf_counter()
        frames = []
        for i in windows:
            _, segs = render(scene, key, i * spp)
            done = torch.cuda.Event() if on_card else None
            if on_card:
                done.record()
            frames.append((segs, done))
        ends = []
        for _, done in frames:
            if on_card:
                done.synchronize()  # waits for this frame only
            ends.append(time.perf_counter())
        dt_total = ends[-1] - t0
        counts = [float(segs) for segs, _ in frames]  # all done: no wait
        for n, begin, end in zip(counts, [t0] + ends[:-1], ends):
            rates.append(n / max(end - begin, 1e-9) / 1e6)
        total_segs = sum(counts)
        mrays = total_segs / dt_total / 1e6
    else:
        # Each frame alone; the median rejects an outlier.
        dt_total = 0.0
        for i in windows:
            if on_card:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                e0.record()
                _, segs = render(scene, key, i * spp)
                e1.record()
                e1.synchronize()
                dt = e0.elapsed_time(e1) / 1e3
            else:
                t0 = time.perf_counter()
                _, segs = render(scene, key, i * spp)
                dt = time.perf_counter() - t0
            n = float(segs)
            rates.append(n / dt / 1e6)
            total_segs += n
            dt_total += dt
        mrays = sorted(rates)[len(rates) // 2]
    camera_rays = s["frames"] * spp * w * h
    log(f"bench: {dt_total:.3f} s for {s['frames']} frames "
        f"({'pipelined' if s['pipeline'] else 'synced'}); "
        f"{total_segs / camera_rays:.4f} segments/camera ray; "
        f"per-frame Mrays/s {[round(r, 1) for r in rates]}")
    if on_card:
        log(f"bench: trace_spheres_kernel launches {trace.KERNEL.launches - launches0}")

    golden, vs_baseline = None, None
    if on_card:
        gkey = hwgolden.entry_key(s["scene"], w, h, spp, depth, resolved, kind)
        digest = hwgolden.frame_hash(first)
        table = hwgolden.load_table()
        if s["record"]:
            table[gkey] = hwgolden.make_entry(digest, first.mean(), mrays=mrays)
            hwgolden.save_table(table)
            golden = "recorded"
            log(f"bench: recorded hardware golden {gkey}: {digest[:16]}.. at {mrays:.3f} Mrays/s")
        else:
            golden, rec = hwgolden.check(gkey, digest, table)
            log("bench: " + hwgolden.describe(golden, gkey, digest, rec))
        base = table.get(headline_key(kind), {}).get("mrays")
        if base:
            vs_baseline = mrays / base

    result = {
        "metric": (f"Mrays/s (scene={s['scene']} {w}x{h}, spp {spp}, depth {depth}, "
                   f"backend={resolved}, device={kind})"),
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": vs_baseline,
        "phases": phases,
        "golden": golden,
    }
    return result, first


def main() -> int:
    s = settings(os.environ)
    if s["backend"] != "torch" and not torch.cuda.is_available():
        log(f"bench: backend {s['backend']} renders on a CUDA GPU and "
            "torch.cuda.is_available() is False; BENCH_BACKEND=torch runs the plain "
            "integrator on the CPU")
        return 2
    result, _ = run(s)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
