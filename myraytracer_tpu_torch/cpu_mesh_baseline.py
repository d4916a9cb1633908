"""BASELINE config 5's CPU comparison: the C++ BVH renderer against the card.

    python -m myraytracer_tpu_torch.cpu_mesh_baseline

The counterpart of the JAX package's ``tools/cpu_mesh_baseline.py``. The
north star ("faster per chip than a native runner on a 32-core CPU",
``BASELINE.json``) names a baseline the reference cannot supply for
meshes, so this harness produces it: the port's C++ renderer
(``native.cpu_backend``: binned-SAH BVH, Möller-Trumbore; in process, on
the host's cores) renders ``mesh_scene(subdivisions)`` with the world's own
camera, the same world and camera the card renders.

For each subdivision level it reports:

* the CPU-BVH Mrays/s a core (the best of CC_REPS frames, each timed alone,
  over the threads it ran on), and the x32 projection of it, labelled as a
  projection (a real 32-core part would also clock differently);
* the uniform CUDA kernel's Mrays/s on the same scene, camera and size
  (the session's renderer: a forced warm-up call, then the best of
  CC_REPS calls, each ended by reading the whole image), and the card over
  the projected 32 cores.

Prints the card's name and power limit first (with the card column), the
JAX tool's lines with the card in the TPU's columns, and last one JSON
line of the numbers. With the card column on and no GPU it exits non-zero
and prints nothing on stdout; so it does when the native library does not
build.

Env knobs (the JAX tool's): CC_SUBDIVS ("2,3,4,5"), CC_WH ("480x270"),
CC_SPP (8), CC_DEPTH (20), CC_THREADS (0: every core), CC_REPS (2),
CC_CARD (1: the card column; 0: the CPU columns only), with CC_TPU its
old name.
"""

from __future__ import annotations

import json
import os
import sys
import time

from myraytracer_tpu_torch import quality
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.native import anchors, cpu_backend
from myraytracer_tpu_torch.scene.presets import mesh_scene

PROJECTED_CORES = 32


def settings(env) -> dict:
    w, h = (int(x) for x in env.get("CC_WH", "480x270").split("x"))
    return dict(
        subdivs=[int(s) for s in env.get("CC_SUBDIVS", "2,3,4,5").split(",")],
        width=w, height=h,
        spp=int(env.get("CC_SPP", "8")),
        depth=int(env.get("CC_DEPTH", "20")),
        threads=int(env.get("CC_THREADS", "0")) or cpu_backend.host_cores(),
        reps=int(env.get("CC_REPS", "2")),
        card=env.get("CC_CARD", env.get("CC_TPU", "1")) != "0",
    )


def card_rate(sub: int, s: dict) -> float:
    """The card's best Mrays/s on ``mesh:sub`` (module docstring)."""
    world, scene = quality.setup(f"mesh:{sub}", "cuda", s["width"], s["height"])
    render = quality.renderer(world, "cuda", s["width"], s["height"], s["spp"], s["depth"])
    key = crng.key_from_seed(0)
    img, _ = render(scene, key, 0)
    img.cpu()  # the tables and a warm frame
    best = 0.0
    for i in range(s["reps"]):
        t0 = time.perf_counter()
        img, segs = render(scene, key, (i + 1) * s["spp"])
        img.cpu()
        dt = time.perf_counter() - t0
        best = max(best, float(segs) / dt / 1e6)
    return best


def run(s: dict, out=print) -> dict:
    w, h, spp, depth, threads = s["width"], s["height"], s["spp"], s["depth"], s["threads"]
    out(f"# {w}x{h} spp={spp} depth={depth} cpu_threads={threads}")
    out("subdiv  tris    cpu-bvh(1x)  cpu-bvh(x32 extrap)  card-kernel  card/cpu32")
    rows = []
    for sub in s["subdivs"]:
        world = mesh_scene(subdivisions=sub)
        cpu = anchors.cpu_rate(world, w, h, spp, depth, s["reps"], threads)
        cpu1 = max(cpu["cpu_mrays_each"]) / threads  # a core, best of reps
        cpu32 = cpu1 * PROJECTED_CORES
        row = dict(subdiv=sub, tris=world.triangle_count, cpu_threads=threads,
                   cpu_mrays_each=cpu["cpu_mrays_each"], cpu_mrays_per_core=cpu1,
                   cpu_x32_projected=cpu32, card_mrays=None, card_over_cpu32=None)
        card_s = ratio_s = "-"
        if s["card"]:
            best = card_rate(sub, s)
            row.update(card_mrays=best, card_over_cpu32=best / cpu32)
            card_s, ratio_s = f"{best:.2f}", f"{best / cpu32:.2f}x"
        rows.append(row)
        out(f"{sub:>6}  {world.triangle_count:>6}  {cpu1:>10.3f}  {cpu32:>18.2f}  "
            f"{card_s:>11}  {ratio_s:>10}")
    return {"tool": "cpu_mesh_baseline", "width": w, "height": h, "spp": spp, "depth": depth,
            "reps": s["reps"], "host_cpu": anchors.host_cpu(), "projected_cores": PROJECTED_CORES,
            "rows": rows}


def main(env=None) -> int:
    s = settings(os.environ if env is None else env)
    if s["card"] and quality.card_missing("cpu_mesh_baseline"):
        return 2
    if not cpu_backend.cpu_available():
        print(f"cpu_mesh_baseline: the native library is unavailable: "
              f"{cpu_backend.native.native_error()}", file=sys.stderr)
        return 2
    if s["card"]:
        print(quality.device_line("cuda"), flush=True)
    res = run(s, out=lambda line: print(line, flush=True))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
