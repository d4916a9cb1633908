"""The closest-hit sweep's gates, worked out again from the compiled scene.

Frozen copy of ``myraytracer_tpu_torch/kernels/trace.py`` (``pack_table``,
``pack_tri_table``, ``_super_aabb``, ``_chunk_boxes`` and the gate part of
``gate_tables``) and of the default ``KernelConfig`` of
``myraytracer_tpu_torch/config.py``, at commit 32ae5bc. The plain sweep
(``hit.closest_hit`` with these gates) is the CUDA kernel's sweep lane by
lane. ``table_bytes`` counts the tables a launch reads, for the roofline's
byte term.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .compile import LEADERS, CompiledScene, _auto_tri_chunk
from .hit import SweepGates

TABLE_ROWS = 11
TRI_ROWS = 15
PAD_CENTER = 3e30
_BIG = 3e38  # an inverted box's bounds: no ray enters it

# The default KernelConfig's gate fields.
UNROLL_MAX = 64
CULL_MIN = 64
CULL_CHUNK = 48
SUPER = 8
SUPER_MIN = 24


class Gates(NamedTuple):
    """The sweep's gates and the sizes of the tables the kernel reads."""

    gates: SweepGates
    n_spheres: int  # sphere table slots, padded to LEADERS + k * CULL_CHUNK
    n_tris: int  # triangle table slots, padded to whole chunks (0: none)
    n_boxes: int  # gate boxes the kernel reads (6 floats each)

    @property
    def table_bytes(self) -> int:
        return 4 * (TABLE_ROWS * self.n_spheres + TRI_ROWS * self.n_tris + 6 * self.n_boxes)


def _pack_table(scene: CompiledScene) -> torch.Tensor:
    return torch.stack([
        scene.center.x, scene.center.y, scene.center.z,
        scene.radius, scene.radius_sq,
        scene.albedo.x, scene.albedo.y, scene.albedo.z,
        scene.fuzz, scene.ior, scene.mat_ty.to(torch.float32),
    ]).contiguous()


def _pack_tri_table(scene: CompiledScene) -> torch.Tensor:
    tr = scene.tris
    return torch.stack([
        tr.v0.x, tr.v0.y, tr.v0.z, tr.e1.x, tr.e1.y, tr.e1.z,
        tr.e2.x, tr.e2.y, tr.e2.z, tr.albedo.x, tr.albedo.y, tr.albedo.z,
        tr.fuzz, tr.ior, tr.mat_ty.to(torch.float32),
    ]).contiguous()


def _super_aabb(aabb: torch.Tensor) -> torch.Tensor:
    n_chunks = aabb.shape[1]
    if n_chunks < SUPER_MIN:
        return aabb.new_zeros((6, 1))
    pad = (-n_chunks) % SUPER
    if pad:
        inv = torch.tensor([_BIG] * 3 + [-_BIG] * 3, dtype=torch.float32,
                           device=aabb.device).view(6, 1)
        aabb = torch.cat([aabb, inv.expand(6, pad)], dim=1)
    n_super = aabb.shape[1] // SUPER
    lo = aabb[:3].reshape(3, n_super, SUPER).amin(dim=2)
    hi = aabb[3:].reshape(3, n_super, SUPER).amax(dim=2)
    return torch.cat([lo, hi])


def _chunk_boxes(lo_rows, hi_rows, skip, width: int) -> torch.Tensor:
    n = skip.shape[0] // width
    lo = [torch.where(skip, _BIG, r).reshape(n, width).amin(dim=1) for r in lo_rows]
    hi = [torch.where(skip, -_BIG, r).reshape(n, width).amax(dim=1) for r in hi_rows]
    return torch.stack(lo + hi)


def gate_tables(scene: CompiledScene) -> Gates:
    """The default config's gates of ``scene``, on its device."""
    dev = scene.device
    f32 = torch.float32
    table = _pack_table(scene)
    table[0] = torch.where(scene.radius_sq < 0.0, PAD_CENTER, table[0])
    pad = (LEADERS - table.shape[1]) % CULL_CHUNK
    if pad:
        extra = torch.zeros((TABLE_ROWS, pad), dtype=f32, device=dev)
        extra[0], extra[3], extra[4] = PAD_CENTER, 1.0, -1.0
        table = torch.cat([table, extra], dim=1)
    n_spheres = table.shape[1]
    ck = table[:, LEADERS:]
    n_chunks = ck.shape[1] // CULL_CHUNK
    if n_chunks:
        r_abs = ck[3].abs()
        aabb = _chunk_boxes([ck[k] - r_abs for k in range(3)],
                            [ck[k] + r_abs for k in range(3)],
                            ck[0] > 1e29, CULL_CHUNK)
        saabb = _super_aabb(aabb)
    else:
        aabb = saabb = torch.zeros((6, 1), dtype=f32, device=dev)

    n_tris = tn_chunks = 0
    tri_chunk = _auto_tri_chunk(scene.tris.padded_size if scene.has_triangles else 0)
    if scene.has_triangles:
        tri = _pack_tri_table(scene)
        tpad = (-tri.shape[1]) % tri_chunk
        if tpad:
            tri = torch.cat([tri, tri.new_zeros((TRI_ROWS, tpad))], dim=1)
        n_tris = tri.shape[1]
        tn_chunks = n_tris // tri_chunk
        v0, e1, e2 = tri[0:3], tri[3:6], tri[6:9]
        v1, v2 = v0 + e1, v0 + e2
        deg = (e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2]
               + e2[0] * e2[0] + e2[1] * e2[1] + e2[2] * e2[2]) == 0.0
        traabb = _chunk_boxes(
            [torch.minimum(torch.minimum(v0[k], v1[k]), v2[k]) for k in range(3)],
            [torch.maximum(torch.maximum(v0[k], v1[k]), v2[k]) for k in range(3)],
            deg, tri_chunk)
    else:
        traabb = torch.zeros((6, 1), dtype=f32, device=dev)
    tsaabb = _super_aabb(traabb)

    sph_cull = n_spheres > UNROLL_MAX and n_spheres > CULL_MIN
    tri_cull = n_tris > UNROLL_MAX
    sph_super = sph_cull and n_chunks >= SUPER_MIN
    tri_super = tri_cull and tn_chunks >= SUPER_MIN
    gates = SweepGates(
        sph_cull=sph_cull, chunk=CULL_CHUNK,
        aabb=aabb[:, :n_chunks], saabb=saabb if sph_super else None,
        tri_cull=tri_cull, tri_chunk=tri_chunk, traabb=traabb[:, :tn_chunks],
        tsaabb=tsaabb if tri_super else None, super_w=SUPER,
    )
    staged = [gates.aabb if sph_cull else None, gates.saabb,
              gates.traabb if tri_cull else None, gates.tsaabb]
    n_boxes = sum(0 if b is None else b.shape[1] for b in staged)
    return Gates(gates, n_spheres, n_tris, n_boxes)
