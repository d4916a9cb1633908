"""The trace kernel against its plain version on a dense random scene, on
one CUDA GPU.

    python -m myraytracer_tpu_torch.parity_stress

The counterpart of the JAX package's ``tools/parity_stress.py``: 900
spheres from ``default_rng(7)`` (radius 0.1-0.4, centers in [-12, 12]^3,
Lambertian, metal and glass in turn) over a ground sphere at -1000.5,
compiled with the spatial sort, rendered at 128x64, spp 2, depth 8 under
the reference camera. Such a scene piles up near-tangent hits, where a
discriminant lies within an ulp of zero. The JAX tool holds its TPU
kernel to its XLA oracle within an envelope there (segments within 1e-3
relative, mean |d| under 5e-3), since the two compilers contract
multiply-adds differently. The port builds its kernel without contraction
and holds it to its plain PyTorch version on the same card, with the same
gates, bit for bit: max|d| 0 and equal segments.

The JAX tool's ``static_ior=1.5`` has no counterpart: the kernel reads
each sphere's IOR off the scene.

Prints the card's name and power limit, the JAX tool's lines, and last one
JSON line; exits 1 if the kernel differs from the plain version. Without a
GPU it exits non-zero and prints nothing on stdout.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from myraytracer_tpu_torch import quality
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.kernels import trace
from myraytracer_tpu_torch.scene import api
from myraytracer_tpu_torch.scene.compile import compile_scene

WIDTH, HEIGHT, SPP, DEPTH = 128, 64, 2, 8
MATERIALS = (1, 2, 3)


def world() -> api.World:
    """The JAX tool's stress world (``tools/parity_stress.py:44-61``)."""
    rng = np.random.default_rng(7)
    mats = [
        api.Lambertian(albedo=(0.5, 0.4, 0.3)),
        api.Metal(albedo=(0.9, 0.8, 0.7), fuzz=0.2),
        api.Dielectric(ior=1.5),
    ]
    spheres = [
        api.Sphere(center=tuple(map(float, rng.uniform(-12, 12, 3))),
                   radius=float(rng.uniform(0.1, 0.4)), material=mats[i % 3])
        for i in range(900)
    ]
    # Ground at -1000.5, not -1000: a camera on a sphere's surface makes
    # every primary ray a grazing case (the JAX tool's note).
    spheres.append(api.Sphere(center=(0, -1000.5, 0), radius=1000.0, material=mats[0]))
    return api.World(tuple(spheres), camera=api.Camera.reference())


def render(device, width: int = WIDTH, height: int = HEIGHT, spp: int = SPP,
           depth: int = DEPTH):
    """The stress world through the kernel's renderer on ``device`` (the
    plain version on the CPU): (image [H, W, 3], segments, the renderer's
    tables of the scene)."""
    w = world()
    scene = compile_scene(w, spatial_sort=True, device=device)
    render = trace.make_renderer(w.camera, width, height, spp, depth, material_set=MATERIALS)
    img, segs = render(scene, crng.key_from_seed(0), 0)
    return img, float(segs), scene, render.tables(scene)


def run(width: int = WIDTH, height: int = HEIGHT, spp: int = SPP, depth: int = DEPTH,
        out=print) -> dict:
    a, sa, scene, tables = render("cuda", width, height, spp, depth)
    sums, segs = trace.trace_spheres_plain(scene, None, crng.key_from_seed(0), width, height, 0,
                                           height, 0, spp, depth, 1e-3, 1e4, tables=tables)
    b, sb = sums * (1.0 / spp), float(segs.sum(dtype=torch.float64))
    a, b = a.cpu().numpy(), b.cpu().numpy()
    seg_rel = abs(sa - sb) / sb
    max_abs = float(np.abs(a - b).max())
    mean_abs = float(np.abs(a - b).mean())
    flipped = float((~np.isclose(a, b, rtol=1e-5, atol=1e-6)).mean())
    out(f"segments: kernel {sa:.0f} vs plain {sb:.0f} (rel {seg_rel:.2e})\n"
        f"max |Δ| {max_abs:.2e}, mean |Δ| {mean_abs:.2e}; pixels beyond 1e-5 tolerance: "
        f"{flipped * 100:.1f}%")
    ok = max_abs == 0.0 and sa == sb and bool(np.isfinite(a).all())
    out("parity stress: " + ("OK (bitwise: max|Δ| 0, equal segments)" if ok
                             else "FAIL (the kernel is not bitwise its plain version)"))
    return {"tool": "parity_stress", "width": width, "height": height, "spp": spp,
            "depth": depth, "spheres": len(world().spheres), "segments_kernel": sa,
            "segments_plain": sb, "seg_rel": seg_rel, "max_abs": max_abs,
            "mean_abs": mean_abs, "flipped": flipped, "ok": ok}


def main(env=None) -> int:
    del env  # no knobs, as the JAX tool
    if quality.card_missing("parity_stress"):
        return 2
    print(quality.device_line("cuda"), flush=True)
    res = run(out=lambda line: print(line, flush=True))
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
