"""In-place attribution of the trace kernel's components, on one CUDA GPU.

    python -m myraytracer_tpu_torch.ablate

The counterpart of the JAX package's ``tools/ablate.py``. Where
``microbench`` times primitives alone, this tool times each component of
the kernel's bounce where it runs: it renders the final scene (spatially
sorted, depth 50) with ``KernelConfig(ABLATE=(component,))``, a build of
``csrc/trace.cu`` that runs a second copy of that component, its inputs
nudged by a runtime zero (so ``nvcc`` can neither fold nor merge it) and
its outputs folded into the segment count through a mask that is zero at
run time (so it cannot be dropped). Iterations, gate decisions, the image
and the segments stay the default build's bit for bit, so

    t(copy) - t(baseline)  =  that component's cost in place.

Components (``config.ABLATE_COMPONENTS``):
  hit       the path ray's closest-hit sweep, behind its gates
  gates     its outer and chunk box tests with empty chunk bodies
  fetch     the winner's record gather and normal
  rng       three more threefry draws a bounce (slots +101..+103)
  samplers  unit_sphere and cbrt01 from their uniforms
  scatter   the material scatter (Lambertian, metal, dielectric)
  regen     the camera ray of a path's start (its draws and ray math)

``fetch`` is measured here where the JAX tool skips it: the TPU kernel
merges the fetch into the sweep, while this kernel's sweep carries (t,
index) and gathers the winner's record once after it.

Every build is compiled first, one ``nvcc`` each, all together. A run is
a first call (its seconds printed, as the JAX tool prints compile
seconds), then the minimum of REPS calls timed with CUDA events. A
baseline runs before every component and after the last, and each copy
is compared with the mean of the baselines on either side of it, as the
JAX tool does. Where that tool prints ``!!`` and goes on, a copy that
changes the segments or a pixel raises here. Each line gives the build's
registers and spill bytes of final's kernel variant (``-Xptxas -v``); a
build that spills more than the baseline is marked, since its delta then
holds the spill. A delta within the baselines' own spread reads "within
noise".

Prints the card's name and power limit, the JAX tool's lines, and last one
JSON line with every reading. Without a GPU it exits non-zero and prints
nothing on stdout.

Env knobs (the JAX tool's): ABLATE_SPP (32), ABLATE_WIDTH/HEIGHT
(1200x800), ABLATE_REPS (3), ABLATE_COMPONENTS (comma list; default all).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from myraytracer_tpu_torch import quality
from myraytracer_tpu_torch.config import ABLATE_COMPONENTS, KernelConfig
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.kernels import trace
from myraytracer_tpu_torch.scene.compile import compile_scene
from myraytracer_tpu_torch.scene.presets import get_scene

COMPONENTS = ABLATE_COMPONENTS
DEPTH = 50
VARIANT = "spheres<1,0,0>"  # final's kernel: the general sweep, no extras, gates staged


def settings(env) -> dict:
    comps = tuple(c for c in env.get("ABLATE_COMPONENTS", ",".join(COMPONENTS)).split(",") if c)
    KernelConfig(ABLATE=comps)  # an unknown name raises
    return dict(spp=int(env.get("ABLATE_SPP", "32")), width=int(env.get("ABLATE_WIDTH", "1200")),
                height=int(env.get("ABLATE_HEIGHT", "800")), reps=int(env.get("ABLATE_REPS", "3")),
                components=comps)


def registers(components=()) -> tuple:
    """(registers, spill bytes) of final's kernel variant in the build that
    runs ``components`` twice."""
    (lib,) = trace.build_variants([KernelConfig(ABLATE=components)])
    return trace.variant_registers(lib.with_suffix(".log").read_text())[VARIANT]


def run(s: dict, out=print) -> dict:
    width, height, spp, reps = s["width"], s["height"], s["spp"], s["reps"]
    world = get_scene("final", seed=0)
    scene = compile_scene(world, spatial_sort=True, device="cuda")
    mats = tuple(sorted({sp.material.type_id for sp in world.spheres}))
    key = crng.key_from_seed(0)
    t0 = time.perf_counter()
    trace.build_variants([None] + [KernelConfig(ABLATE=(c,)) for c in s["components"]])
    build_s = time.perf_counter() - t0

    def measure(ablate: tuple) -> dict:
        render = trace.make_renderer(world.camera, width, height, spp, DEPTH, material_set=mats,
                                     config=KernelConfig(ABLATE=ablate))
        t0 = time.perf_counter()
        img, segs = render(scene, key, 0)
        img = img.cpu()
        first_s = time.perf_counter() - t0
        ms = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            render(scene, key, 0)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        regs, spill = registers(ablate)
        return dict(ms=min(ms), reps_ms=ms, segments=float(segs), first_call_s=first_s,
                    registers=regs, spill_bytes=spill, img=img)

    out(f"scene=final {width}x{height} spp={spp} depth={DEPTH} reps={reps}")
    base = measure(())
    bases, rows = [base["ms"]], []
    for comp in s["components"]:
        r = measure((comp,))
        nxt = measure(())
        bases.append(nxt["ms"])
        if r["segments"] != base["segments"]:
            raise AssertionError(f"{comp}: segments changed ({r['segments']} vs "
                                 f"{base['segments']}): the copy is not inert")
        if not torch.equal(r["img"], base["img"]):
            raise AssertionError(f"{comp}: the image changed: the copy is not inert")
        local = (bases[-2] + bases[-1]) / 2
        rows.append(dict(component=comp, local_baseline_ms=local, delta_ms=r["ms"] - local,
                         share=(r["ms"] - local) / local,
                         **{k: v for k, v in r.items() if k != "img"}))
    spread = max(bases) - min(bases)
    mrays = base["segments"] / base["ms"] / 1e3
    out(f"baseline: {base['ms']:8.1f} ms  ({base['segments'] / 1e6:.0f} M segs, {mrays:.1f} "
        f"Mrays/s; first call {base['first_call_s']:.1f}s; {base['registers']} regs, "
        f"{base['spill_bytes']} B spill)")
    out(f"baselines: {len(bases)} runs, {min(bases):.2f}-{max(bases):.2f} ms (spread "
        f"{spread:.2f} ms, {spread / min(bases) * 100:.1f}%)")
    for r in rows:
        r["within_noise"] = abs(r["delta_ms"]) <= spread
        r["spills_more"] = r["spill_bytes"] > base["spill_bytes"]
        out(f"+{r['component']:9s} {r['ms']:8.1f} ms  Δ={r['delta_ms']:7.1f} ms "
            f"({r['share'] * 100:5.1f}% of local baseline {r['local_baseline_ms']:.0f} ms; "
            f"first call {r['first_call_s']:.1f}s; {r['registers']} regs, {r['spill_bytes']} B "
            f"spill)" + ("  within noise" if r["within_noise"] else "")
            + ("  SPILLS MORE than the baseline: the delta holds the spill"
               if r["spills_more"] else ""))
    total = sum(r["delta_ms"] for r in rows)
    mean_base = sum(r["local_baseline_ms"] for r in rows) / max(1, len(rows))
    out(f"sum of component deltas: {total:.1f} ms ({total / mean_base * 100:.1f}% of mean "
        f"baseline) — the remainder is bookkeeping (miss/sky, the queue, the sums) + the "
        f"loop and launch")
    del base["img"]
    return {"tool": "ablate", "scene": "final", "width": width, "height": height, "spp": spp,
            "depth": DEPTH, "reps": reps, "build_s": build_s, "baseline": base,
            "baselines_ms": bases, "spread_ms": spread, "rows": rows,
            "sum_delta_ms": total}


def main(env=None) -> int:
    if quality.card_missing("ablate"):
        return 2
    s = settings(os.environ if env is None else env)
    print(quality.device_line("cuda"), flush=True)
    res = run(s, out=lambda line: print(line, flush=True))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
