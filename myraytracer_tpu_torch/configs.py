"""All five BASELINE configs and the two emissive scenes, timed in one process.

    python -m myraytracer_tpu_torch.configs

The counterpart of the JAX package's ``tools/configs.py``: its configs
(``CONFIGS``, and ``SMALL`` at ``CFG_SMALL=1``), its knobs, its line a
config and its markdown table. Each config's renderer is the JAX tool's
(``renderer_args``) on the port's backend; its first call builds the
kernel's tables and renders frame 0, and its seconds stand where the JAX
tool prints its compile. The kernels are built before the first config.
Then CFG_FRAMES frames are dispatched back to back and forced in order by
a host read of a few values of each image and of its segments: the
pipelined loop a session runs. On the card the dispatch loop refuses host
syncs (``quality.no_host_sync``): a call that waits for the device fails
the tool rather than serialize the loop it times. Each row also records
the dispatch loop's own seconds (``dispatch_s``), which stay a small share
of the timed window when nothing waits for the card.

Env knobs (the JAX tool's): CFG_BACKEND (``cuda``, or ``torch`` at
CFG_SMALL=1; ``pallas`` and ``jnp`` name them too), CFG_FRAMES (4; 2 at
CFG_SMALL=1), CFG_SMALL=1 (48x32, spp 2, depth 4), CFG_ONLY (a comma list
of config names), CFG_NEE (``1``: next-event estimation on the scenes that
have lights; ``both``: each such scene off, then on).

Prints the card's name and power limit first (or that the plain version
runs on the CPU), then the JAX tool's lines, and last one JSON line with
every run's numbers and the segments of each of its frames. On ``cuda``
without a GPU it exits non-zero and prints nothing on stdout.
"""

from __future__ import annotations

import json
import os
import sys
import time

from myraytracer_tpu_torch import quality
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.render import dispatch
from myraytracer_tpu_torch.render.lights import extract_lights
from myraytracer_tpu_torch.scene import api
from myraytracer_tpu_torch.scene.presets import get_scene

CONFIGS = [
    # name, scene, W, H, spp, depth
    ("lambertian", "lambertian", 400, 225, 100, 50),
    ("three-sphere", "three-sphere", 1200, 800, 125, 50),
    ("defocus", "defocus", 1200, 800, 125, 50),
    ("final", "final", 1200, 800, 500, 50),
    ("mesh", "mesh", 480, 270, 64, 20),
    ("light", "light", 1200, 800, 125, 50),
    ("cornell", "cornell", 512, 512, 125, 50),
]

SMALL = [(n, s, 48, 32, 2, 4) for (n, s, *_rest) in CONFIGS]


def settings(env) -> dict:
    small = env.get("CFG_SMALL", "0") == "1"
    configs = SMALL if small else CONFIGS
    only = env.get("CFG_ONLY")
    if only:
        names = {n.strip() for n in only.split(",")}
        configs = [c for c in configs if c[0] in names]
    return dict(
        backend=quality.backend_name(env.get("CFG_BACKEND", "jnp" if small else "pallas")),
        frames=int(env.get("CFG_FRAMES", "2" if small else "4")),
        runs=runs(configs, env.get("CFG_NEE", "0")),
    )


def runs(configs, nee_env: str) -> list:
    """``(config, nee)`` in the JAX tool's order: ``CFG_NEE=1`` turns NEE on
    for a config whose scene has lights, ``both`` times it off, then on."""
    out = []
    for cfg in configs:
        out.append((cfg, False))
        if nee_env in ("1", "both") and extract_lights(get_scene(cfg[1], seed=0)):
            if nee_env == "1":
                out[-1] = (cfg, True)
            else:
                out.append((cfg, True))
    return out


def renderer_args(world: api.World, nee: bool, backend: str, spp: int) -> dict:
    """The renderer arguments the JAX tool derives from a config's world
    (``tools/configs.py:88-114``): the material types, the one dielectric
    IOR if there is one, the sky, the lights under NEE, and on the plain
    version ``sample_batch = min(spp, 2)``."""
    mats = {s.material.type_id for s in world.spheres}
    mats |= {m.material.type_id for m in world.meshes}
    iors = {s.material.ior for s in world.spheres
            if s.material.type_id == api.MATERIAL_DIELECTRIC}
    iors |= {m.material.ior for m in world.meshes
             if m.material.type_id == api.MATERIAL_DIELECTRIC}
    kw = dict(
        material_set=tuple(sorted(mats)) or None,
        static_ior=(iors.pop() if len(iors) == 1 else None),
        sky=world.ambient,
    )
    if nee:
        kw["nee_lights"] = extract_lights(world)
    if backend != "cuda":
        kw["sample_batch"] = min(spp, 2)
    return kw


def make_renderer(world: api.World, backend: str, width: int, height: int, spp: int,
                  depth: int, args: dict):
    """The frame renderer of ``backend`` with a config's ``renderer_args``."""
    kw = dict(args)
    del kw["static_ior"]  # the port's kernel and integrator read the IOR off the scene
    return dispatch.renderer_factory(backend)(world.camera, width, height, spp, depth, **kw)


def run(s: dict, out=print) -> dict:
    backend, n_frames = s["backend"], s["frames"]
    if backend == "cuda":
        from myraytracer_tpu_torch.kernels import trace

        trace.KERNEL.load()  # nvcc before the first config, not in its first call
    key = crng.key_from_seed(0)
    rows = []
    for (name, scene_name, w, h, spp, depth), nee in s["runs"]:
        world, scene = quality.setup(scene_name, backend, w, h)
        render = make_renderer(world, backend, w, h, spp, depth,
                               renderer_args(world, nee, backend, spp))
        if nee:
            name = name + "+nee"
        t0 = time.perf_counter()
        img, segs = render(scene, key, 0)
        quality.force(img)
        first_s = time.perf_counter() - t0
        segments = [float(segs)]

        # Pipelined timing: dispatch all frames, force in order (the
        # production accumulation loop's overlap).
        outs = []
        t0 = time.perf_counter()
        with quality.no_host_sync(backend):
            for f in range(n_frames):
                outs.append(render(scene, key, (f + 1) * spp))
        dispatch_s = time.perf_counter() - t0
        for img, segs in outs:
            quality.force(img)
            segments.append(float(segs))
        dt = time.perf_counter() - t0
        del outs
        ms = dt / n_frames * 1e3
        mrays = sum(segments[1:]) / dt / 1e6
        rows.append(dict(config=name, scene=scene_name, width=w, height=h, spp=spp,
                         depth=depth, nee=nee, ms_per_frame=ms, mrays_s=mrays,
                         first_call_s=first_s, dispatch_s=dispatch_s,
                         sample_bases=[f * spp for f in range(n_frames + 1)], segments=segments))
        out(f"{name:>12} {w}x{h} spp={spp} depth={depth}: "
            f"{ms:8.1f} ms/frame {mrays:8.1f} Mrays/s "
            f"(first call {first_s:.0f}s)")

    out("\n| config | setup | ms/frame | Mrays/s/chip |")
    out("|---|---|---|---|")
    for r in rows:
        out(f"| {r['config']} | {r['width']}×{r['height']}, {r['spp']} spp, depth {r['depth']} "
            f"| {r['ms_per_frame']:.1f} | {r['mrays_s']:.1f} |")
    return {"tool": "configs", "backend": backend, "frames": n_frames, "rows": rows}


def main(env=None) -> int:
    s = settings(os.environ if env is None else env)
    if quality.card_missing("configs", s["backend"]):
        return 2
    print(quality.device_line(s["backend"]), flush=True)
    res = run(s, out=lambda line: print(line, flush=True))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
