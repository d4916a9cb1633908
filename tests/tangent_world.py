"""Sphere worlds whose camera rays meet every class of discriminant that the
trace kernels' fast root (``sqrt_fast``) does not cover, so that the
kernels' second, exact sweep (``kernels/trace.py``'s ``sqrt_fast_missed``)
decides their images.

``CAMERA`` is a packed camera ([19] f32, ``render/camera.pack_camera``'s
layout) with a zero horizontal and vertical span and no lens: every camera
ray of every pixel and jitter starts at the origin along (0, 0, -1),
exactly. Against it:

* the tangent sphere, centre (1, 0, -5) and radius 1, has b = -5, c = 25
  and a discriminant of exactly +0: the ray grazes it at t = 5, which only
  the IEEE root finds (``sqrt_fast(+0)`` is NaN);
* the tiny sphere at the origin, radius ``TINY_R``, has a discriminant of
  ``TINY_R**2`` rounded, about 2^-118, under 2^-101 and outside the range
  on which ``sqrt_fast`` is checked: its root counts where ``t_min`` is 0;
* the giant sphere of ``"inf"``, radius 1e20, has a radius squared of +inf
  in f32 and a discriminant of +inf on every ray, which both roots miss.

Eight filler spheres come first, so a table of ``LEADERS`` = 8 leaders
puts the special spheres behind the gates when the sweep is gated
(``GATED``). ``tangent_scene`` compiles a world on a device. The module
imports only the port.
"""

import numpy as np

from myraytracer_tpu_torch.config import KernelConfig
from myraytracer_tpu_torch.scene.api import Lambertian, Metal, Sphere, World
from myraytracer_tpu_torch.scene.compile import compile_scene

CAMERA = np.array([0.0, 0.0, -1.0] + [0.0] * 16, np.float32)
TINY_R = 1.7e-18
# A sweep that gates the worlds' sphere tables (8 leaders, then a chunk).
GATED = KernelConfig(UNROLL_MAX=8, FORCE_CULL=True)
KINDS = ("tangent", "inf")


def tangent_world(kind: str = "tangent") -> World:
    """The tangent and tiny spheres behind eight fillers; ``"inf"`` adds
    the giant sphere."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    fillers = [Sphere((0.0, -1000.5, -5.0), 1000.0, Lambertian((0.5, 0.5, 0.5)))]
    for k in range(7):
        x = -3.0 + k
        fillers.append(Sphere((x, 0.6 + 0.1 * k, -4.0 - 0.5 * k), 0.45,
                              Metal((0.8, 0.7, 0.6), 0.1 * k) if k % 2
                              else Lambertian((0.2 + 0.1 * k, 0.4, 0.6))))
    special = [
        Sphere((1.0, 0.0, -5.0), 1.0, Lambertian((0.8, 0.3, 0.3))),
        Sphere((0.0, 0.0, 0.0), TINY_R, Lambertian((0.3, 0.8, 0.3))),
    ]
    if kind == "inf":
        special.append(Sphere((0.0, 0.0, 0.0), 1e20, Lambertian((0.3, 0.3, 0.8))))
    return World(fillers + special)


def tangent_scene(kind: str, device):
    """``tangent_world(kind)`` compiled on ``device`` (the giant sphere's
    radius squared overflows to +inf on purpose)."""
    with np.errstate(over="ignore"):
        return compile_scene(tangent_world(kind), device=device)
