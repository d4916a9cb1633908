"""Frozen copy of ``myraytracer_tpu_torch/render/camera.py`` at commit 32ae5bc, for
the benchmark's reference; imports made local. Edits: pixel coordinates in the float type of ``vec.computing_in``.

Camera ray generation over the pixel/sample lane axis.

Port of ``myraytracer_tpu.render.camera``. Two modes:

* **Reference mode** reproduces the reference's fixed pinhole
  (``shader.wgsl:360-361,373-381``): origin camera looking down -Z, focal
  length 1, viewport height 2, image row 0 at viewport y = -1, and the
  half-pixel-shifted jitter window ``[px+0.5, px+1.5)``.
* **General mode** is the positionable thin-lens camera of RTiOW ch. 12-13:
  lookfrom/lookat/vup/vfov basis, focus-plane viewport, aperture disk
  sampling. Image row 0 is the top.

The general basis also packs into 19 floats (``pack_camera``) that
``rays_from_packed`` and the CUDA kernel read at run time; both evaluate
the same expression tree as ``general_rays``, so the images agree bit for
bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from . import rng as crng
from .vec import V3, float_dtype
from .api import Camera

PACKED_CAMERA_SIZE = 19


def reference_rays(
    width: int,
    height: int,
    ix: torch.Tensor,
    iy: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    lens_u1,
    lens_u2,
) -> Tuple[V3, V3]:
    """Reference pinhole mapping (shader.wgsl:373-381). Lens draws unused."""
    del lens_u1, lens_u2
    pixel_side = 2.0 / float(height)
    vx = (ix.to(float_dtype()) + 0.5 + u1 - 0.5 * width) * pixel_side
    vy = (iy.to(float_dtype()) + 0.5 + u2 - 0.5 * height) * pixel_side
    zero = torch.zeros_like(vx)
    direction = V3(vx, vy, torch.full_like(vx, -1.0)).normalize()
    return V3(zero, zero, zero), direction


class GeneralCameraParams:
    """Host-precomputed thin-lens basis (Python floats)."""

    def __init__(self, cam: Camera, width: int, height: int):
        aspect = width / height
        theta = math.radians(cam.vfov_degrees)
        h = math.tan(theta / 2.0)
        viewport_h = 2.0 * h
        viewport_w = aspect * viewport_h
        focus = cam.resolved_focus_dist()

        lf = cam.lookfrom
        la = cam.lookat
        w = _norm3((lf[0] - la[0], lf[1] - la[1], lf[2] - la[2]))
        cu = _cross3(cam.vup, w)
        if cu[0] ** 2 + cu[1] ** 2 + cu[2] ** 2 < 1e-12:
            raise ValueError(
                f"camera vup {cam.vup} is (nearly) parallel to the view "
                f"direction {w}; choose a non-parallel vup"
            )
        u = _norm3(cu)
        v = _cross3(w, u)

        self.origin = lf
        self.u = u
        self.v = v
        self.horizontal = tuple(focus * viewport_w * c for c in u)
        self.vertical = tuple(focus * viewport_h * c for c in v)
        self.lower_left = tuple(
            lf[i] - self.horizontal[i] / 2 - self.vertical[i] / 2 - focus * w[i]
            for i in range(3)
        )
        self.lens_radius = cam.aperture / 2.0


def _cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _norm3(a):
    n = math.sqrt(a[0] ** 2 + a[1] ** 2 + a[2] ** 2)
    return (a[0] / n, a[1] / n, a[2] / n)


def general_rays(
    params: GeneralCameraParams,
    width: int,
    height: int,
    ix: torch.Tensor,
    iy: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    lens_u1: torch.Tensor,
    lens_u2: torch.Tensor,
) -> Tuple[V3, V3]:
    """Thin-lens rays; image row 0 = top of frame (RTiOW orientation)."""
    s = (ix.to(float_dtype()) + u1) * (1.0 / width)
    t = 1.0 - (iy.to(float_dtype()) + u2) * (1.0 / height)

    dx, dy = crng.unit_disk_from_uniforms(lens_u1, lens_u2)
    rdx = params.lens_radius * dx
    rdy = params.lens_radius * dy
    offset = V3(
        params.u[0] * rdx + params.v[0] * rdy,
        params.u[1] * rdx + params.v[1] * rdy,
        params.u[2] * rdx + params.v[2] * rdy,
    )
    origin = V3(
        offset.x + params.origin[0],
        offset.y + params.origin[1],
        offset.z + params.origin[2],
    )
    direction = V3(
        params.lower_left[0] + s * params.horizontal[0] + t * params.vertical[0]
        - origin.x,
        params.lower_left[1] + s * params.horizontal[1] + t * params.vertical[1]
        - origin.y,
        params.lower_left[2] + s * params.horizontal[2] + t * params.vertical[2]
        - origin.z,
    ).normalize()
    return origin, direction


def make_ray_generator(cam: Camera, width: int, height: int):
    """Return ``gen(ix, iy, u1, u2, l1, l2) -> (origin V3, dir V3)``."""
    if cam.reference_mode:
        return lambda ix, iy, u1, u2, l1, l2: reference_rays(
            width, height, ix, iy, u1, u2, l1, l2
        )
    params = GeneralCameraParams(cam, width, height)
    return lambda ix, iy, u1, u2, l1, l2: general_rays(
        params, width, height, ix, iy, u1, u2, l1, l2
    )


def orbit_camera(base: Camera, yaw: float, pitch: float, dist_scale: float) -> Camera:
    """Orbit ``base`` about its look-at point (the viewer's camera controls).

    ``yaw`` and ``pitch`` are radians added to the base azimuth and
    elevation; ``dist_scale`` multiplies the base distance (floored at
    1e-3). The elevation is clamped to ±1.45 rad, short of the poles, so the
    vup basis stays defined. An explicit ``focus_dist`` moves by the change
    in distance, so the depth it focuses stays in focus; ``None`` resolves
    to the new distance. Python float math, as the JAX package's.
    """
    lf, la = base.lookfrom, base.lookat
    dx, dy, dz = lf[0] - la[0], lf[1] - la[1], lf[2] - la[2]
    r = math.sqrt(dx * dx + dy * dy + dz * dz) or 1.0
    az = math.atan2(dz, dx) + yaw
    el = max(-1.45, min(1.45, math.asin(dy / r) + pitch))
    r2 = r * max(1e-3, dist_scale)
    focus = base.focus_dist
    if focus is not None:
        focus = max(1e-3, focus + (r2 - r))
    return dataclasses.replace(
        base,
        lookfrom=(
            la[0] + r2 * math.cos(el) * math.cos(az),
            la[1] + r2 * math.sin(el),
            la[2] + r2 * math.cos(el) * math.sin(az),
        ),
        focus_dist=focus,
    )


def pack_camera(cam: Camera, width: int, height: int) -> np.ndarray:
    """Pack a general-mode camera into the [19] f32 runtime vector.

    Layout: lower_left[3] horizontal[3] vertical[3] origin[3] u[3] v[3]
    lens_radius[1].
    """
    if cam.reference_mode:
        raise ValueError("reference-mode camera is fixed; nothing to pack")
    p = GeneralCameraParams(cam, width, height)
    return np.asarray(
        [*p.lower_left, *p.horizontal, *p.vertical, *p.origin,
         *p.u, *p.v, p.lens_radius],
        np.float32,
    )


def rays_from_packed(
    cam: torch.Tensor,
    width: int,
    height: int,
    ix: torch.Tensor,
    iy: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    lens_u1: torch.Tensor,
    lens_u2: torch.Tensor,
) -> Tuple[V3, V3]:
    """``general_rays`` reading the basis from a packed [19] f32 tensor.

    Same expression tree as ``general_rays`` (term order preserved), so a
    packed camera reproduces the closure camera bit for bit.
    """
    s = (ix.to(float_dtype()) + u1) * (1.0 / width)
    t = 1.0 - (iy.to(float_dtype()) + u2) * (1.0 / height)

    dx, dy = crng.unit_disk_from_uniforms(lens_u1, lens_u2)
    rdx = cam[18] * dx
    rdy = cam[18] * dy
    offset = V3(
        cam[12] * rdx + cam[15] * rdy,
        cam[13] * rdx + cam[16] * rdy,
        cam[14] * rdx + cam[17] * rdy,
    )
    origin = V3(offset.x + cam[9], offset.y + cam[10], offset.z + cam[11])
    direction = V3(
        cam[0] + s * cam[3] + t * cam[6] - origin.x,
        cam[1] + s * cam[4] + t * cam[7] - origin.y,
        cam[2] + s * cam[5] + t * cam[8] - origin.z,
    ).normalize()
    return origin, direction
