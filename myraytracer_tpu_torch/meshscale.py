"""Large-mesh scaling of the chunk gates, on one CUDA GPU.

    python -m myraytracer_tpu_torch.meshscale

The counterpart of the JAX package's ``tools/meshscale.py``: the uniform
kernel on ``mesh_scene`` at growing triangle counts (20·4^n icosphere and
props), with the two-level gates (chunk boxes under SUPER-wide outer
boxes, the default ``KernelConfig``) against flat ones
(``KernelConfig(SUPER_MIN=10**9)``: chunk boxes only). Both renderers are
built by a first call, which must give the same image bit for bit and the
same segments (else the tool raises: the gates change what is tested,
never the result), then timed in interleaved reps, a rep one call ended by
reading the whole image to the host.

Where the JAX tool tests the TPU's SMEM budget, this one says where the
launch's plan (``kernels.trace.staging_of``) puts each table: a line names
the tables read from global memory, past a block's shared memory.

Prints the card's name and power limit, the JAX tool's lines, and last one
JSON line with every plan and rep. Without a GPU it exits non-zero and
prints nothing on stdout.

Env knobs (the JAX tool's): MS_SUBDIVS ("2,3,4"), MS_SPP (8), MS_WH
(480x270), MS_REPS (2), MS_DEPTH (20).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from myraytracer_tpu_torch import quality
from myraytracer_tpu_torch.config import KernelConfig
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.kernels import trace

GATES = (("super", KernelConfig()), ("flat", KernelConfig(SUPER_MIN=10 ** 9)))


def settings(env) -> dict:
    width, height = (int(x) for x in env.get("MS_WH", "480x270").split("x"))
    return dict(subdivs=[int(s) for s in env.get("MS_SUBDIVS", "2,3,4").split(",")],
                spp=int(env.get("MS_SPP", "8")), depth=int(env.get("MS_DEPTH", "20")),
                reps=int(env.get("MS_REPS", "2")), width=width, height=height)


def run(s: dict, out=print) -> dict:
    width, height, spp, depth = s["width"], s["height"], s["spp"], s["depth"]
    key = crng.key_from_seed(0)
    out(f"{width}x{height} spp={spp} depth={depth}")
    rows = []
    for sub in s["subdivs"]:
        world, scene = quality.setup(f"mesh:{sub}", "cuda", width, height)
        n_tris = world.triangle_count
        mats = tuple(sorted({m.material.type_id for m in world.meshes}))
        row = [f"subdiv={sub} tris={n_tris}"]
        # Build both variants first, then time them interleaved.
        built, plans = [], {}
        base = None
        for label, config in GATES:
            render = trace.make_renderer(world.camera, width, height, spp, depth,
                                         material_set=mats, sky=world.ambient, config=config)
            t0 = time.perf_counter()
            img, segs = render(scene, key, 0)
            img = img.cpu()
            first_s = time.perf_counter() - t0
            if base is None:
                base = (img, float(segs))
            elif not (torch.equal(img, base[0]) and float(segs) == base[1]):
                raise AssertionError(f"subdiv={sub}: the {label} gates' image or segments "
                                     f"differ from the {GATES[0][0]} gates'")
            plans[label] = trace.staging_of(render.tables(scene), scene.device)
            built.append((label, render, float(segs), first_s))
        in_global = {label: [t for t, staged in zip(("gates", "spheres", "triangles"), plan[:3])
                             if not staged] for label, plan in plans.items()}
        if any(in_global.values()):
            out(f"subdiv={sub} tris={n_tris}: in global memory, past a block's shared memory: "
                + "; ".join(f"{label} {', '.join(t) or 'nothing'}"
                            for label, t in in_global.items()))
        times = {label: [] for label, *_ in built}
        for r in range(s["reps"]):
            order = built if r % 2 == 0 else list(reversed(built))
            for label, render, _, _ in order:
                t0 = time.perf_counter()
                img, _ = render(scene, key, 0)
                img.cpu()
                times[label].append(time.perf_counter() - t0)
        numbers = {}
        for label, render, segs_f, first_s in built:
            ts = sorted(times[label])
            med = ts[len(ts) // 2]
            numbers[label] = dict(seconds=times[label], median_ms=med * 1e3,
                                  mrays_s=segs_f / med / 1e6, first_call_s=first_s,
                                  staging=[int(v) for v in plans[label]])
            row.append(f"{label}: {med * 1e3:7.1f} ms {segs_f / med / 1e6:6.1f} "
                       f"Mrays/s (first call {first_s:.0f}s)")
        rows.append(dict(subdiv=sub, tris=n_tris, segments=base[1], bitwise=True, **numbers))
        out("  ".join(row))
    return {"tool": "meshscale", "width": width, "height": height, "spp": spp, "depth": depth,
            "reps": s["reps"], "rows": rows}


def main(env=None) -> int:
    if quality.card_missing("meshscale"):
        return 2
    s = settings(os.environ if env is None else env)
    print(quality.device_line("cuda"), flush=True)
    res = run(s, out=lambda line: print(line, flush=True))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
