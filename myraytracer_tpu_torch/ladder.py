"""Sample-window (spp) scaling ladder on the final scene, on one CUDA GPU.

    python -m myraytracer_tpu_torch.ladder

The counterpart of the JAX package's ``tools/ladder.py``: one renderer per
spp point (the session's, ``quality.renderer``), each built by a first
forced call, then all timed in interleaved reps (forward, then backward) so
that drift spreads over every point; a rep is one call ended by reading
the whole image to the host. Prints the card's name and power limit, the
JAX tool's lines (the median of the reps a point), and last one JSON line
with every rep. Without a GPU it exits non-zero and prints nothing on
stdout.

Env knobs (the JAX tool's): LADDER_SPP ("32,125,500"), LADDER_REPS (3),
LADDER_WH (1200x800).
"""

from __future__ import annotations

import json
import os
import sys
import time

from myraytracer_tpu_torch import quality
from myraytracer_tpu_torch.core import rng as crng

DEPTH = 50


def settings(env) -> dict:
    width, height = (int(x) for x in env.get("LADDER_WH", "1200x800").split("x"))
    return dict(spps=[int(s) for s in env.get("LADDER_SPP", "32,125,500").split(",")],
                reps=int(env.get("LADDER_REPS", "3")), width=width, height=height)


def run(s: dict, out=print) -> dict:
    width, height, reps = s["width"], s["height"], s["reps"]
    world, scene = quality.setup("final", "cuda", width, height)
    key = crng.key_from_seed(0)

    built = []
    for spp in s["spps"]:
        render = quality.renderer(world, "cuda", width, height, spp, DEPTH)
        t0 = time.perf_counter()
        img, segs = render(scene, key, 0)
        img.cpu()
        out(f"built spp={spp} (first call+frame {time.perf_counter() - t0:.0f}s)")
        built.append((spp, render, float(segs)))

    times = {spp: [] for spp, *_ in built}
    for r in range(reps):
        order = built if r % 2 == 0 else list(reversed(built))
        for spp, render, _ in order:
            t0 = time.perf_counter()
            img, _ = render(scene, key, 0)
            img.cpu()
            times[spp].append(time.perf_counter() - t0)

    out(f"{width}x{height} depth={DEPTH}, median of {reps} interleaved reps:")
    rows = []
    for spp, _, segs in built:
        ts = sorted(times[spp])
        med = ts[len(ts) // 2]
        rows.append(dict(spp=spp, segments=segs, seconds=times[spp], median_ms=med * 1e3,
                         mrays_s=segs / med / 1e6))
        out(f"spp {spp:4d}: {med * 1e3:8.1f} ms  {segs / med / 1e6:6.1f} Mrays/s")
    return {"tool": "ladder", "width": width, "height": height, "depth": DEPTH, "reps": reps,
            "rows": rows}


def main(env=None) -> int:
    if quality.card_missing("ladder"):
        return 2
    s = settings(os.environ if env is None else env)
    print(quality.device_line("cuda"), flush=True)
    res = run(s, out=lambda line: print(line, flush=True))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
