"""Measure the routing model's anchors on one CUDA GPU and its host CPU.

    python -m myraytracer_tpu_torch.native.anchors [--skip-cuda] [--ladder mesh|spheres|both]

For each world of the two ladders (triangles: one triangle, then ``mesh:1``
to ``mesh:7``; spheres: one sphere, then ``spheres:N`` up to N = 330) at
1200x800, depth 50: the CUDA kernel's Mrays/s (the uniform kernel at spp 4,
one launch, the median of three timed with CUDA events after a warm-up)
and the C++ renderer's Mrays/s a core (spp 1, one frame on every core of
the host, the median of three, divided by the thread count). Mrays/s is
traced ray segments a second, as the CLI reports it.

Prints the card's name and power limit as nvidia-smi gives them, the host's
CPU, one JSON line a world, and last the four anchor lists of
``native/cpu_backend.py`` as Python. Without a GPU it exits non-zero,
unless ``--skip-cuda``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from myraytracer_tpu_torch.native import cpu_backend
from myraytracer_tpu_torch.scene import api, meshgen, presets

WIDTH, HEIGHT, DEPTH = 1200, 800, 50
CUDA_SPP, CPU_SPP, REPS = 4, 1, 3
MESH_LADDER = ("tri:1",) + tuple(f"mesh:{n}" for n in range(1, 8))
SPHERE_LADDER = ("sphere:1",) + tuple(f"spheres:{n}" for n in (1, 2, 5, 10, 20, 50, 100, 200, 330))


def anchor_world(name: str) -> api.World:
    """A ladder's world: ``tri:1`` is one ground triangle under
    ``mesh_scene``'s camera, ``sphere:1`` the ground sphere of
    ``sphere_field`` under its camera; the rest are presets."""
    if name == "tri:1":
        v, f = meshgen.quad((-6.0, -0.5, 4.0), (6.0, -0.5, 4.0), (6.0, -0.5, -8.0),
                            (-6.0, -0.5, -8.0))
        return api.World(spheres=[], meshes=[api.Mesh(v, f[:1], api.Lambertian((0.8, 0.8, 0.0)))],
                         camera=presets.mesh_scene(1).camera)
    if name == "sphere:1":
        field = presets.sphere_field(1)
        ground = max(field.spheres, key=lambda s: abs(s.radius))
        return api.World([ground], camera=field.camera)
    return presets.get_scene(name)


def host_cpu() -> str:
    """The host's processor, as ``platform`` names it, and its cores."""
    import os
    import platform

    return f"{platform.processor() or platform.machine()}, {os.cpu_count()} cores"


def cuda_rate(world: api.World) -> dict:
    """The uniform CUDA kernel's Mrays/s on ``world`` (module docstring)."""
    from myraytracer_tpu_torch.core import rng as crng
    from myraytracer_tpu_torch.kernels import trace
    from myraytracer_tpu_torch.render.camera import pack_camera
    from myraytracer_tpu_torch.render.session import wants_spatial_sort
    from myraytracer_tpu_torch.scene.compile import compile_scene

    scene = compile_scene(world, spatial_sort=wants_spatial_sort(world), device="cuda")
    cam = torch.from_numpy(pack_camera(world.camera, WIDTH, HEIGHT)).to("cuda")
    tables = trace.gate_tables(scene)
    args = (scene, cam, crng.key_from_seed(0), WIDTH, HEIGHT, 0, HEIGHT, 0, CUDA_SPP, DEPTH,
            1e-3, 1e4, world.ambient)
    trace.trace_spheres(*args, tables=tables)  # warm-up
    ms, segs = [], 0.0
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        _, s = trace.trace_spheres(*args, tables=tables)
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
        segs = float(s.sum(dtype=torch.float64).item())
    med = statistics.median(ms)
    return {"cuda_ms": ms, "cuda_segs": segs, "cuda_mrays": segs / med / 1e3}


def cpu_rate(world: api.World, width: int = WIDTH, height: int = HEIGHT, spp: int = CPU_SPP,
             depth: int = DEPTH, reps: int = REPS, threads: int = 0) -> dict:
    """The C++ renderer's Mrays/s a core on ``world`` (module docstring):
    ``reps`` frames on ``threads`` threads (0: ``host_cores()``), rep ``i``
    from sample ``i``, each timed alone; the rate a core from the median
    time, and each rep's Mrays/s on all its threads."""
    from myraytracer_tpu_torch.core import rng as crng
    from myraytracer_tpu_torch.render.camera import pack_camera

    threads = threads or cpu_backend.host_cores()
    render = cpu_backend.make_cpu_factory(world, threads)(world.camera, width, height, spp, depth)

    class Scene:
        cam = torch.from_numpy(pack_camera(world.camera, width, height))

    secs, each = [], []
    for i in range(reps):
        t0 = time.perf_counter()
        _, s = render(Scene, crng.key_from_seed(0), i)
        secs.append(time.perf_counter() - t0)
        each.append(float(s) / secs[-1] / 1e6)
    segs = float(s)
    med = statistics.median(secs)
    return {"cpu_s": secs, "cpu_segs": segs, "cpu_threads": threads,
            "cpu_mrays_per_core": segs / med / 1e6 / threads, "cpu_mrays_each": each}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--skip-cuda", action="store_true", help="measure the CPU renderer only")
    p.add_argument("--ladder", choices=["mesh", "spheres", "both"], default="both")
    args = p.parse_args(argv)
    if not args.skip_cuda:
        if not torch.cuda.is_available():
            print("anchors: no CUDA GPU (torch.cuda.is_available() is False)", file=sys.stderr)
            return 2
        from myraytracer_tpu_torch.sweep import card

        print(card(), flush=True)
    if not cpu_backend.cpu_available():
        print(f"anchors: the native library is unavailable: "
              f"{cpu_backend.native.native_error()}", file=sys.stderr)
        return 2
    print(json.dumps({"host_cpu": host_cpu()}), flush=True)
    ladders = {"mesh": MESH_LADDER, "spheres": SPHERE_LADDER}
    suffix = {"mesh": "MESH", "spheres": "SPH"}
    lists = {}
    for kind in (("mesh", "spheres") if args.ladder == "both" else (args.ladder,)):
        for name in ladders[kind]:
            world = anchor_world(name)
            n = world.triangle_count if kind == "mesh" else len(world.spheres)
            row = {"world": name, "prims": n, "width": WIDTH, "height": HEIGHT, "depth": DEPTH}
            row.update(cpu_rate(world))
            if not args.skip_cuda:
                row.update(cuda_rate(world))
                torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
            lists.setdefault(f"_CPU_{suffix[kind]}", []).append(
                (n, round(row["cpu_mrays_per_core"], 3)))
            if not args.skip_cuda:
                lists.setdefault(f"_CUDA_{suffix[kind]}", []).append(
                    (n, round(row["cuda_mrays"], 1)))
    for name, pts in sorted(lists.items()):
        print(f"{name} = {pts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
