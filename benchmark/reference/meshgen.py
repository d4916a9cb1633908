"""Frozen copy of ``myraytracer_tpu_torch/scene/meshgen.py`` at commit 32ae5bc, for
the benchmark's reference; imports made local. Edits: none.

Procedural mesh generators (for the triangle-mesh benchmark config).

The reference has no meshes at all (spheres only, lib.rs:611-639); these
generators provide deterministic triangle content for BASELINE config 5.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def box(center, half_extents) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned box: 8 vertices, 12 triangles (outward CCW winding)."""
    cx, cy, cz = center
    hx, hy, hz = half_extents
    v = np.array(
        [
            [cx - hx, cy - hy, cz - hz],
            [cx + hx, cy - hy, cz - hz],
            [cx + hx, cy + hy, cz - hz],
            [cx - hx, cy + hy, cz - hz],
            [cx - hx, cy - hy, cz + hz],
            [cx + hx, cy - hy, cz + hz],
            [cx + hx, cy + hy, cz + hz],
            [cx - hx, cy + hy, cz + hz],
        ],
        np.float32,
    )
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # -z
            [4, 5, 6], [4, 6, 7],  # +z
            [0, 1, 5], [0, 5, 4],  # -y
            [3, 7, 6], [3, 6, 2],  # +y
            [0, 4, 7], [0, 7, 3],  # -x
            [1, 2, 6], [1, 6, 5],  # +x
        ],
        np.int32,
    )
    return v, f


def rotate_y(vertices: np.ndarray, degrees: float, about=None) -> np.ndarray:
    """Rotate vertices about a vertical axis through ``about`` (default:
    the vertex centroid). Instance transforms bake into the geometry —
    the compiled scene stays plain triangles (no per-instance machinery,
    which RTiOW book 2 needs only because its primitives are implicit)."""
    v = np.asarray(vertices, np.float32)
    c = v.mean(axis=0) if about is None else np.asarray(about, np.float32)
    a = math.radians(degrees)
    ca, sa = math.cos(a), math.sin(a)
    x = v[:, 0] - c[0]
    z = v[:, 2] - c[2]
    out = v.copy()
    out[:, 0] = ca * x + sa * z + c[0]
    out[:, 2] = -sa * x + ca * z + c[2]
    return out


def quad(p0, p1, p2, p3) -> Tuple[np.ndarray, np.ndarray]:
    """Two-triangle quad with vertices in CCW order."""
    v = np.asarray([p0, p1, p2, p3], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, f


def icosphere(center, radius, subdivisions: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron subdivided ``subdivisions`` times, then scaled.

    Triangle count = 20 * 4^subdivisions (deterministic vertex order).
    """
    phi = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [
        (-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
        (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
        (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]

    def norm(p):
        l = math.sqrt(p[0] ** 2 + p[1] ** 2 + p[2] ** 2)
        return (p[0] / l, p[1] / l, p[2] / l)

    verts = [norm(v) for v in verts]
    cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            pa, pb = verts[a], verts[b]
            verts.append(
                norm(((pa[0] + pb[0]) / 2, (pa[1] + pb[1]) / 2, (pa[2] + pb[2]) / 2))
            )
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdivisions):
        new_faces = []
        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces

    v = np.asarray(verts, np.float32) * np.float32(radius) + np.asarray(
        center, np.float32
    )
    return v, np.asarray(faces, np.int32)
