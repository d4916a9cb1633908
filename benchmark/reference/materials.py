"""Frozen copy of ``myraytracer_tpu_torch/render/materials.py`` at commit 32ae5bc, for
the benchmark's reference; imports made local. Edits: none.

Masked material scatter.

Port of ``myraytracer_tpu.render.materials``: every lane computes each
material branch and selects by type, with the same expression trees.

* **Lambertian** (shader.wgsl:203-216): ``dir = normal + unit_sphere``;
  an exactly-zero direction falls back to the normal; attenuation is the
  albedo; always scatters.
* **Metal** (shader.wgsl:228-242): ``dir = reflect(in, n) + fuzz * ball``;
  absorbed when ``dot(dir, normal) <= 0``.
* **Dielectric** (RTiOW ch. 10): Schlick reflectance, total internal
  reflection, refraction ratio 1/ior on front faces; attenuation 1.

Scatter directions are returned un-normalized; the bounce loop normalizes
(shader.wgsl:354).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vec import V3, lerp, reflect
from .hit import Hit
from . import api


class Scatter(NamedTuple):
    ok: torch.Tensor  # bool: False = absorbed (black path)
    direction: V3  # un-normalized next direction
    attenuation: V3


def pow5(x: torch.Tensor) -> torch.Tensor:
    """``x**5`` as the products JAX's integer_pow lowers it to:
    ``x * ((x*x) * (x*x))``. ``torch.pow`` may round differently."""
    x2 = x * x
    return x * (x2 * x2)


def scatter(
    d: V3,
    hit: Hit,
    sphere_sample: V3,
    ball_sample: V3,
    u_reflect: torch.Tensor,
) -> Scatter:
    """Compute-all-select scatter for normalized incoming direction ``d``.

    ``sphere_sample``/``ball_sample`` are pre-drawn unit-sphere / unit-ball
    vectors; ``u_reflect`` a pre-drawn U[0,1) for the dielectric branch.
    """
    n = hit.normal
    ty = hit.mat_ty

    # Dielectric (RTiOW ch. 10)
    ratio = torch.where(hit.front_face, torch.reciprocal(hit.ior), hit.ior)
    cos_theta = torch.clamp_max(-d.dot(n), 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ratio * sin_theta > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    reflectance = r0 + (1.0 - r0) * pow5(1.0 - cos_theta)
    do_reflect = cannot_refract | (reflectance > u_reflect)
    refr_perp = (d + n * cos_theta) * ratio
    refr_par = n * (-torch.sqrt(torch.abs(1.0 - refr_perp.length_sq())))
    refr_dir = refr_perp + refr_par
    diel_dir = V3.where(do_reflect, reflect(d, n), refr_dir)
    is_diel = ty == api.MATERIAL_DIELECTRIC
    direction = V3.where(is_diel, diel_dir, n)
    ok = is_diel

    # Metal (shader.wgsl:228-242)
    metal_dir = reflect(d, n) + ball_sample * hit.fuzz
    metal_ok = metal_dir.dot(n) > 0.0
    is_metal = ty == api.MATERIAL_METAL
    direction = V3.where(is_metal, metal_dir, direction)
    ok = ok | (is_metal & metal_ok)

    # Lambertian (shader.wgsl:203-216)
    lamb_dir = n + sphere_sample
    degenerate = lamb_dir.length_sq() == 0.0
    lamb_dir = V3.where(degenerate, n, lamb_dir)
    is_lamb = ty == api.MATERIAL_LAMBERTIAN
    direction = V3.where(is_lamb, lamb_dir, direction)
    ok = ok | is_lamb

    # Unknown/pad material type: absorbed, like the reference's dispatch
    # fall-through (shader.wgsl:249-251).
    one = torch.ones_like(hit.fuzz)
    attenuation = V3.where(is_diel, V3(one, one, one), hit.albedo)
    return Scatter(ok=ok, direction=direction, attenuation=attenuation)


def color_sky(y_normalized: torch.Tensor) -> V3:
    """Sky gradient (shader.wgsl:331-334): mix(white, blue, 0.5*y + 0.5)."""
    t = 0.5 * y_normalized + 0.5
    return lerp(V3(1.0, 1.0, 1.0), V3(0.5, 0.7, 1.0), t)
