"""Frozen copy of ``myraytracer_tpu_torch/render/lights.py`` at commit 32ae5bc, for
the benchmark's reference; imports made local. Edits: none.

Next-event estimation with MIS: direct-light sampling (opt-in ``nee``).

Port of ``myraytracer_tpu.render.lights``. At every Lambertian hit one
light is picked uniformly and sampled (a cone toward a sphere light, a
uniform point on a triangle light), one shadow ray tests it, and the two
techniques -- the light sample and the BSDF path that happens to reach a
light -- are combined with the balance heuristic:

* the shadow-ray term is ``throughput * albedo * emit * cos / (pi*q +
  cos)``, with ``q`` the light technique's solid-angle density (including
  the ``1/N`` pick) and ``cos/pi`` the cosine lobe's;
* a BSDF path from a diffuse vertex that reaches a light keeps its
  emission weighted by ``cos_prev / (cos_prev + pi*q)``, with ``q``
  evaluated for the direction it traced (:func:`light_pdf_at_hit`).

Draw slots: the light pick is the dielectric word (slot 2, second word) and
the light-point sample slot 3; slots are absolute, so nothing else moves.

The light list is static (:func:`extract_lights`), as in the JAX package.
Its constants enter the f32 arithmetic where JAX's weak typing puts them:
a Python-float subexpression (``(r * r) * (1.0 + 1e-6)``, a triangle's unit
normal and area, ``math.pi / nl``) is computed in double and rounded to f32
once, and a Python float meeting an f32 array becomes ``f32(c)``.
:func:`light_table` does that rounding once and packs the values into the
f32 table the CUDA kernel reads (``csrc/trace.cu``, one row a light); the
plain functions here read the same values back as Python floats, which are
exact f32 values, so both evaluate the same f32 expressions.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .vec import V3
from . import api

# Shadow-ray slack: the sampled point lies on the light, so anything
# strictly nearer than ``t_point * (1 - SHADOW_EPS)`` occludes it.
SHADOW_EPS = 1e-3
# Relative tolerance matching a BSDF hit distance to a light's analytic
# re-intersection in light_pdf_at_hit.
PICKUP_T_TOL = 1e-3
TWO_PI = 2.0 * math.pi

# Columns of the light table (csrc/trace.cu LightCol): the kind, the
# emission, the geometry (a sphere's center, r*r and its inside test; a
# triangle's v0, e1, e2, unit normal and area), and pi / n_lights.
LIGHT_SPHERE, LIGHT_TRI = 0, 1
(LT_KIND, LT_ER, LT_EG, LT_EB, LT_X, LT_Y, LT_Z, LT_RR, LT_RR_OK,
 LT_E1X, LT_E1Y, LT_E1Z, LT_E2X, LT_E2Y, LT_E2Z, LT_NX, LT_NY, LT_NZ,
 LT_AREA, LT_PI_N) = range(20)
LIGHT_COLS = 20


def extract_lights(world: api.World) -> Tuple[tuple, ...]:
    """Static light list of the API world (spheres, then mesh triangles --
    independent of the compiled scene's order), as the JAX package's:
    ``("sphere", (cx,cy,cz), r, (er,eg,eb))`` or ``("tri", v0, e1, e2,
    (er,eg,eb))``."""
    lights = []
    for s in world.spheres:
        if s.material.type_id == api.MATERIAL_LIGHT:
            lights.append((
                "sphere",
                tuple(float(c) for c in s.center),
                abs(float(s.radius)),
                tuple(float(c) for c in s.material.emit),
            ))
    for m in world.meshes:
        if m.material.type_id != api.MATERIAL_LIGHT:
            continue
        emit = tuple(float(c) for c in m.material.emit)
        for (a, b, c) in m.triangles:
            v0, v1, v2 = m.vertices[a], m.vertices[b], m.vertices[c]
            e1 = tuple(v1[i] - v0[i] for i in range(3))
            e2 = tuple(v2[i] - v0[i] for i in range(3))
            lights.append(("tri", tuple(v0), e1, e2, emit))
    return tuple(lights)


def _tri_consts(v0, e1, e2):
    """A triangle's unit normal, normal length and area, in double."""
    nx = e1[1] * e2[2] - e1[2] * e2[1]
    ny = e1[2] * e2[0] - e1[0] * e2[2]
    nz = e1[0] * e2[1] - e1[1] * e2[0]
    nlen = math.sqrt(nx * nx + ny * ny + nz * nz)
    area = 0.5 * nlen
    inv_nlen = 1.0 / max(nlen, 1e-12)
    return (nx * inv_nlen, ny * inv_nlen, nz * inv_nlen), nlen, area


def light_table(lights) -> np.ndarray:
    """The lights as an f32 ``[n, LIGHT_COLS]`` table, each constant rounded
    once from the double value JAX's weak typing rounds."""
    nl = len(lights)
    table = np.zeros((nl, LIGHT_COLS), np.float64)
    for i, light in enumerate(lights):
        row = table[i]
        row[LT_PI_N] = math.pi / nl
        if light[0] == "sphere":
            _, c, r, emit = light
            row[LT_KIND] = LIGHT_SPHERE
            row[LT_X:LT_Z + 1] = c
            row[LT_RR] = r * r
            row[LT_RR_OK] = (r * r) * (1.0 + 1e-6)
        elif light[0] == "tri":
            _, v0, e1, e2, emit = light
            row[LT_KIND] = LIGHT_TRI
            row[LT_X:LT_Z + 1] = v0
            row[LT_E1X:LT_E1Z + 1] = e1
            row[LT_E2X:LT_E2Z + 1] = e2
            nu, _, area = _tri_consts(v0, e1, e2)
            row[LT_NX:LT_NZ + 1] = nu
            row[LT_AREA] = area
        else:
            raise ValueError(f"unknown light kind {light[0]!r}")
        row[LT_ER:LT_EB + 1] = emit
    return table.astype(np.float32)


def _rows(lights):
    """The table's rows as Python floats (exact f32 values)."""
    return light_table(lights).astype(np.float64).tolist()


def _div(c: float, x: torch.Tensor) -> torch.Tensor:
    """``f32(c) / x``, correctly rounded (``c / x`` in torch is ``c *
    reciprocal(x)``, which rounds twice)."""
    return torch.div(torch.tensor(c, dtype=x.dtype, device=x.device), x)


def _onb(w: V3):
    """Branchless orthonormal basis around unit ``w``, NaN-free for a
    degenerate ``w`` (the normalize is epsilon-guarded)."""
    use_y = w.x.abs() > 0.9
    zero = torch.zeros_like(w.x)
    ax = torch.where(use_y, 0.0, zero + 1.0)
    ay = torch.where(use_y, zero + 1.0, 0.0)
    u = V3(ax, ay, zero).cross(w)
    u = u * torch.rsqrt(torch.clamp_min(u.length_sq(), 1e-24))
    return u, w.cross(u)


def _sample_one(row, p: V3, u1, u2):
    """Direction sample toward one light (a table row) from points ``p``:
    ``(omega, t_point, pdf, ok, emit)``; ``pdf`` is solid-angle density
    before the 1/N pick, and ``ok`` False where the sampler cannot
    generate a path (inside a sphere light, a grazing triangle)."""
    emit = row[LT_ER:LT_EB + 1]
    if row[LT_KIND] == LIGHT_SPHERE:
        rr = row[LT_RR]
        lv = V3(row[LT_X] - p.x, row[LT_Y] - p.y, row[LT_Z] - p.z)
        d2 = lv.length_sq()
        d = torch.sqrt(d2)
        ok = d2 > row[LT_RR_OK]
        inv_d2 = 1.0 / torch.clamp_min(d2, 1e-12)
        cos_max = torch.sqrt(torch.clamp_min(1.0 - rr * inv_d2, 0.0))
        cos_t = 1.0 + u1 * (cos_max - 1.0)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        phi = TWO_PI * u2
        w = lv * (1.0 / torch.clamp_min(d, 1e-12))
        ub, vb = _onb(w)
        omega = ub * (sin_t * torch.cos(phi)) + vb * (sin_t * torch.sin(phi)) + w * cos_t
        t_point = d * cos_t - torch.sqrt(torch.clamp_min(rr - d2 * (1.0 - cos_t * cos_t), 0.0))
        solid = TWO_PI * (1.0 - cos_max)
        ok = ok & (solid > 1e-9)
        pdf = 1.0 / torch.clamp_min(solid, 1e-12)
        return omega, t_point, pdf, ok, emit
    flip = u1 + u2 > 1.0
    su = torch.where(flip, 1.0 - u1, u1)
    sv = torch.where(flip, 1.0 - u2, u2)
    q = [row[LT_X + k] + su * row[LT_E1X + k] + sv * row[LT_E2X + k] for k in range(3)]
    lv = V3(q[0] - p.x, q[1] - p.y, q[2] - p.z)
    d2 = lv.length_sq()
    d = torch.sqrt(torch.clamp_min(d2, 1e-12))
    omega = lv * (1.0 / d)
    cos_l = (omega.x * row[LT_NX] + omega.y * row[LT_NY] + omega.z * row[LT_NZ]).abs()
    ok = (cos_l > 1e-4) & (d2 > 1e-9)
    pdf = d2 / torch.clamp_min(cos_l * row[LT_AREA], 1e-12)
    return omega, d, pdf, ok, emit


def sample_lights(lights, p: V3, n: V3, pick_u, u1, u2):
    """Pick one light uniformly with ``pick_u`` and sample it with ``u1,
    u2`` (compute-all-select, as the JAX package does; the CUDA kernel
    evaluates only the picked light, which is the same select).

    Returns ``(omega, t_point, contrib V3, add)``: ``contrib`` is the
    MIS-weighted direct term ``emit * cos / (pi*q + cos)``, to be multiplied
    by ``throughput * albedo`` where ``add`` and the shadow test pass.
    """
    rows = _rows(lights)
    nl = len(rows)
    pick = torch.clamp_max((pick_u * float(nl)).to(torch.int32), nl - 1)
    zero = torch.zeros_like(u1)
    omega = V3(zero, zero, zero + 1.0)
    t_point = zero
    contrib = V3(zero, zero, zero)
    add = zero > 1.0
    for i, row in enumerate(rows):
        o_i, t_i, pdf_i, ok_i, emit = _sample_one(row, p, u1, u2)
        cos_i = o_i.dot(n)
        piq = pdf_i * row[LT_PI_N]
        w_scale = cos_i / torch.clamp_min(piq + cos_i, 1e-12)
        sel = pick == i
        omega = V3.where(sel, o_i, omega)
        t_point = torch.where(sel, t_i, t_point)
        contrib = V3.where(sel, V3(emit[0] * w_scale, emit[1] * w_scale,
                                   emit[2] * w_scale), contrib)
        add = add | (sel & ok_i & (cos_i > 0.0))
    omega = V3.where(add, omega, V3(zero, zero, zero + 1.0))
    t_point = torch.where(add, t_point, 1.0)
    contrib = V3.where(add, contrib, V3(zero, zero, zero))
    return omega, t_point, contrib, add


def light_pdf_at_hit(lights, o: V3, d: V3, t_hit) -> torch.Tensor:
    """``pi * q`` of the BSDF ray ``(o, d)`` that hit a light at ``t_hit``:
    the density with which :func:`sample_lights` from ``o`` would have
    generated it, 0 where the sampler cannot. Every light is re-intersected
    in order and the last match wins."""
    piq = torch.zeros_like(t_hit)
    tol = PICKUP_T_TOL
    for row in _rows(lights):
        if row[LT_KIND] == LIGHT_SPHERE:
            rr = row[LT_RR]
            lv = V3(row[LT_X] - o.x, row[LT_Y] - o.y, row[LT_Z] - o.z)
            d2c = lv.length_sq()
            b = lv.dot(d)
            disc = b * b - (d2c - rr)
            near = b - torch.sqrt(torch.clamp_min(disc, 0.0))
            outside = d2c > row[LT_RR_OK]
            cos_max = torch.sqrt(torch.clamp_min(1.0 - _div(rr, torch.clamp_min(d2c, 1e-12)),
                                                 0.0))
            solid = TWO_PI * (1.0 - cos_max)
            match = ((disc > 0.0) & (near > 0.0)
                     & ((near - t_hit).abs() <= tol * torch.clamp_min(t_hit, 1e-3)))
            ok = outside & (solid > 1e-9) & match
            piq_i = _div(row[LT_PI_N], torch.clamp_min(solid, 1e-12))
        else:
            e1 = row[LT_E1X:LT_E1Z + 1]
            e2 = row[LT_E2X:LT_E2Z + 1]
            px = d.y * e2[2] - d.z * e2[1]
            py = d.z * e2[0] - d.x * e2[2]
            pz = d.x * e2[1] - d.y * e2[0]
            det = e1[0] * px + e1[1] * py + e1[2] * pz
            inv = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
            tx = o.x - row[LT_X]
            ty = o.y - row[LT_Y]
            tz = o.z - row[LT_Z]
            u = (tx * px + ty * py + tz * pz) * inv
            qx = ty * e1[2] - tz * e1[1]
            qy = tz * e1[0] - tx * e1[2]
            qz = tx * e1[1] - ty * e1[0]
            v = (d.x * qx + d.y * qy + d.z * qz) * inv
            t_i = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv
            cos_l = (d.x * row[LT_NX] + d.y * row[LT_NY] + d.z * row[LT_NZ]).abs()
            match = ((det.abs() >= 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                     & (t_i > 0.0)
                     & ((t_i - t_hit).abs() <= tol * torch.clamp_min(t_hit, 1e-3)))
            ok = match & (cos_l > 1e-4) & (t_hit * t_hit > 1e-9)
            piq_i = (t_hit * t_hit) * _div(row[LT_PI_N],
                                           torch.clamp_min(cos_l * row[LT_AREA], 1e-12))
        piq = torch.where(ok, piq_i, piq)
    return piq
