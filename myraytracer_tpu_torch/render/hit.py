"""Batched ray-sphere closest hit.

Port of the sphere part of ``myraytracer_tpu.render.hit``. The reference's
per-thread linear scan with a shrinking ``t_sup`` window
(``shader.wgsl:314-329``) becomes a min-reduction over the sphere axis,
vectorized over all ray lanes, in chunks of spheres so the ``[chunk, rays]``
intermediates stay bounded at full image size.

Semantics kept from the reference and the JAX package:

* half-b quadratic with ``a = 1`` (ray directions are normalized);
* nearer root first, the farther root only when the nearer one is outside
  the window;
* strict ``t < t_best``: on equal t the lowest sphere index wins;
* outward normal ``(at - center) * (1 / radius)`` with the signed radius,
  front-face test ``dot(normal, dir) <= 0`` and the back-face flip.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from myraytracer_tpu_torch.core.vec import V3
from myraytracer_tpu_torch.scene.compile import CompiledScene


class Hit(NamedTuple):
    """Per-lane closest-hit record (analog of shader.wgsl:134-140)."""

    t: torch.Tensor  # f32; == t_max where there is no hit
    idx: torch.Tensor  # int64 sphere index (0 when no hit; see mask)
    mask: torch.Tensor  # bool, True = hit something
    point: V3
    normal: V3  # flipped to oppose the ray (shader.wgsl:305-307)
    front_face: torch.Tensor  # bool
    mat_ty: torch.Tensor  # i32
    albedo: V3
    fuzz: torch.Tensor
    ior: torch.Tensor


def _chunk_size(n_prims: int, n_lanes: int) -> int:
    """Spheres per chunk, bounding each [chunk, lanes] temporary to ~16M
    f32 elements (64 MB), as the JAX package does."""
    budget = 16 << 20
    c = max(8, min(n_prims, budget // max(1, n_lanes)))
    return max(8, (c // 8) * 8)


def _sphere_candidates(
    o: V3, d: V3, scene: CompiledScene, t_min: float, t_max: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_best, i_best) over all spheres; t_best == t_max on a miss."""
    n_lanes = o.x.shape[0]
    n = scene.padded_size
    dev = o.x.device
    chunk = _chunk_size(n, n_lanes)
    t_minf = torch.tensor(t_min, dtype=torch.float32, device=dev)
    big = torch.tensor(t_max, dtype=torch.float32, device=dev)

    t_best = torch.full((n_lanes,), t_max, dtype=torch.float32, device=dev)
    i_best = torch.zeros((n_lanes,), dtype=torch.int64, device=dev)
    for base in range(0, n, chunk):
        sl = slice(base, min(n, base + chunk))
        ocx = o.x[None, :] - scene.center.x[sl, None]
        ocy = o.y[None, :] - scene.center.y[sl, None]
        ocz = o.z[None, :] - scene.center.z[sl, None]
        b = ocx * d.x[None, :] + ocy * d.y[None, :] + ocz * d.z[None, :]
        c = ocx * ocx + ocy * ocy + ocz * ocz - scene.radius_sq[sl, None]
        disc = b * b - c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t1 = -b - sq
        t2 = -b + sq
        t1_ok = (t1 >= t_minf) & (t1 < big)
        t_cand = torch.where(t1_ok, t1, t2)
        valid = (disc >= 0.0) & (t_cand >= t_minf) & (t_cand < big)
        t_cand = torch.where(valid, t_cand, big)
        # First-index-wins min over the chunk: the smallest t, then the
        # lowest row holding it (no reliance on argmin's tie order).
        t_chunk = torch.amin(t_cand, dim=0)
        rows = torch.arange(base, sl.stop, device=dev)[:, None]
        i_chunk = torch.where(t_cand == t_chunk[None, :], rows, n).amin(dim=0)
        better = t_chunk < t_best
        t_best = torch.where(better, t_chunk, t_best)
        i_best = torch.where(better, i_chunk, i_best)
    return t_best, i_best


def closest_hit(o: V3, d: V3, scene: CompiledScene, t_min: float, t_max: float) -> Hit:
    """Closest hit for normalized ray directions ``d`` over 1-D lanes."""
    t_best, idx = _sphere_candidates(o, d, scene, t_min, t_max)
    mask = t_best < t_max
    point = o + d * t_best

    # One denormalized fetch of the winner's record.
    take = lambda a: a[idx]  # noqa: E731
    center = V3(take(scene.center.x), take(scene.center.y), take(scene.center.z))
    normal = (point - center) * torch.reciprocal(take(scene.radius))
    front = normal.dot(d) <= 0.0  # shader.wgsl:303
    normal = V3.where(front, normal, -normal)
    return Hit(
        t=t_best,
        idx=idx,
        mask=mask,
        point=point,
        normal=normal,
        front_face=front,
        mat_ty=take(scene.mat_ty),
        albedo=V3(take(scene.albedo.x), take(scene.albedo.y), take(scene.albedo.z)),
        fuzz=take(scene.fuzz),
        ior=take(scene.ior),
    )
