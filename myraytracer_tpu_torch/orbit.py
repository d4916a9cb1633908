"""Orbit demo: a camera animation through one renderer, on one CUDA GPU.

    python -m myraytracer_tpu_torch.orbit

The counterpart of the JAX package's ``tools/orbit.py``. The kernel reads
the thin-lens camera from the scene's packed [19] f32 camera
(``render.camera.pack_camera``), so one renderer serves every camera. The
tool orbits the final scene's camera about its look-at point
(``cameras``, the JAX tool's formula): frame 0 is rendered and forced
first, then the other frames are dispatched back to back, each with its
own camera, and forced in order. The rate counts the segments of those
frames over their time (the JAX tool adds frame 0's segments to it).

Prints the card's name and power limit, the JAX tool's lines, and last one
JSON line of the numbers. Without a GPU it exits non-zero and prints
nothing on stdout.

Env knobs (the JAX tool's): ORBIT_FRAMES (8), ORBIT_SPP (8), ORBIT_WH
(480x270), ORBIT_OUT (a directory for PNGs, ``orbit_NNN.png`` through
``output.image``; unset: none).
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import sys
import time

import torch

from myraytracer_tpu_torch import quality
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.output.image import to_u8, write_png
from myraytracer_tpu_torch.render.camera import PACKED_CAMERA_SIZE, pack_camera
from myraytracer_tpu_torch.scene.api import Camera

DEPTH = 50


def settings(env) -> dict:
    width, height = (int(x) for x in env.get("ORBIT_WH", "480x270").split("x"))
    return dict(frames=int(env.get("ORBIT_FRAMES", "8")), spp=int(env.get("ORBIT_SPP", "8")),
                width=width, height=height, out_dir=env.get("ORBIT_OUT"))


def cameras(base: Camera, frames: int) -> list:
    """``frames`` cameras at even steps of a full turn about ``base``'s
    look-at point, at its height and horizontal distance (the JAX tool's
    ``frame_camera``)."""
    la, lf = base.lookat, base.lookfrom
    radius = math.dist((lf[0], lf[2]), (la[0], la[2]))
    phi0 = math.atan2(lf[2] - la[2], lf[0] - la[0])

    def frame_camera(i):
        phi = phi0 + 2.0 * math.pi * i / frames
        return Camera(
            lookfrom=(la[0] + radius * math.cos(phi), lf[1], la[2] + radius * math.sin(phi)),
            lookat=la, vup=base.vup, vfov_degrees=base.vfov_degrees,
            aperture=base.aperture, focus_dist=base.focus_dist,
        )

    return [frame_camera(i) for i in range(frames)]


def run(s: dict, out=print) -> dict:
    frames, spp, width, height = s["frames"], s["spp"], s["width"], s["height"]
    world, scene = quality.setup("final", "cuda", width, height)
    key = crng.key_from_seed(0)
    render = quality.renderer(world, "cuda", width, height, spp, DEPTH)
    cams = cameras(world.camera, frames)
    # Each frame's camera goes to the card from pinned memory without a
    # wait, so the dispatch loop stays pipelined.
    staged = torch.empty((frames, PACKED_CAMERA_SIZE), dtype=torch.float32).pin_memory()

    def view(i):
        staged[i] = torch.from_numpy(pack_camera(cams[i], width, height))
        return scene._replace(cam=staged[i].to(scene.device, non_blocking=True))

    t0 = time.perf_counter()
    img0, segs0 = render(view(0), key, 0)
    img0 = img0.cpu()
    first_s = time.perf_counter() - t0
    out(f"first call+frame 0: {first_s * 1e3:8.1f} ms ({first_s:.1f}s)")

    t0 = time.perf_counter()
    handles = [render(view(i), key, 0) for i in range(1, frames)]
    images = [img0] + [img.cpu() for img, _ in handles]  # force in order
    segments = [float(segs0)] + [float(segs) for _, segs in handles]
    dt = time.perf_counter() - t0
    res = {"tool": "orbit", "width": width, "height": height, "spp": spp, "depth": DEPTH,
           "frames": frames, "first_call_s": first_s, "segments": segments}
    if frames > 1:
        mrays = sum(segments[1:]) / dt / 1e6
        res.update(pipelined_s=dt, ms_per_frame=dt * 1e3 / (frames - 1), mrays_s=mrays)
        out(f"{frames - 1} more frames pipelined: {dt * 1e3:.1f} ms total, "
            f"{dt * 1e3 / (frames - 1):.1f} ms/frame, {mrays:.1f} Mrays/s")
    if s["out_dir"]:
        pathlib.Path(s["out_dir"]).mkdir(parents=True, exist_ok=True)
        for i, img in enumerate(images):
            write_png(pathlib.Path(s["out_dir"]) / f"orbit_{i:03d}.png", to_u8(img.numpy(), 2.0))
    return res


def main(env=None) -> int:
    if quality.card_missing("orbit"):
        return 2
    s = settings(os.environ if env is None else env)
    print(quality.device_line("cuda"), flush=True)
    res = run(s, out=lambda line: print(line, flush=True))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
