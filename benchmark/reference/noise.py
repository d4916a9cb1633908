"""Frozen copy of ``myraytracer_tpu_torch/core/noise.py`` at commit 32ae5bc, for
the benchmark's reference; imports made local. Edits: none.

Tableless procedural noise (exact integer-hash lattice noise).

Port of ``myraytracer_tpu.core.noise``: lattice corner values come from
``lowbias32`` over the integer lattice coordinates, smoothed with the
Hermite cubic RTiOW book 2 uses, and the marble band is an exact triangle
wave. No random draws are consumed, so textures never shift the sample
stream.

uint32 values are carried in int64 tensors (or Python ints) and masked
with ``M32`` after every operation that can leave 32 bits: torch has few
uint32 ops, and int64 holds every u32 product's low word after the mask.
"""

from __future__ import annotations

import torch

from .vec import V3

M32 = 0xFFFFFFFF

# Octaves of the turbulence sum (RTiOW book 2 uses 7).
TURBULENCE_OCTAVES = 7


def _mul32(a, c: int):
    """Low 32 bits of ``a * c`` for u32 ``a`` and a u32 constant ``c``.

    Split into 16-bit halves so the int64 intermediate never overflows.
    """
    lo = (a * (c & 0xFFFF)) & M32
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def lowbias32(h):
    """lowbias32: a well-distributed 32-bit integer finalizer (u32 → u32)."""
    h = h & M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    """u32 hash of integer lattice coordinates (i32 tensors, wrapping)."""
    u = lambda a: a.to(torch.int64) & M32  # noqa: E731  (i32 → u32 bits)
    h = (
        _mul32(u(ix), 0x8DA6B343)
        ^ _mul32(u(iy), 0xD8163841)
        ^ _mul32(u(iz), 0xCB1AB31F)
    )
    return lowbias32(h)


def _corner(ix, iy, iz) -> torch.Tensor:
    """Lattice corner value in [0, 1): top 24 hash bits scaled (exact)."""
    h24 = (hash3(ix, iy, iz) >> 8).to(torch.int32)
    return h24.to(torch.float32) * (1.0 / (1 << 24))


def value_noise(p: V3) -> torch.Tensor:
    """Smooth lattice value noise in [0, 1) (analog of book-2 perlin.h)."""
    fx, fy, fz = torch.floor(p.x), torch.floor(p.y), torch.floor(p.z)
    ix = fx.to(torch.int32)
    iy = fy.to(torch.int32)
    iz = fz.to(torch.int32)
    tx, ty, tz = p.x - fx, p.y - fy, p.z - fz
    ux = tx * tx * (3.0 - 2.0 * tx)
    uy = ty * ty * (3.0 - 2.0 * ty)
    uz = tz * tz * (3.0 - 2.0 * tz)

    c000 = _corner(ix, iy, iz)
    c100 = _corner(ix + 1, iy, iz)
    c010 = _corner(ix, iy + 1, iz)
    c110 = _corner(ix + 1, iy + 1, iz)
    c001 = _corner(ix, iy, iz + 1)
    c101 = _corner(ix + 1, iy, iz + 1)
    c011 = _corner(ix, iy + 1, iz + 1)
    c111 = _corner(ix + 1, iy + 1, iz + 1)

    x00 = c000 + ux * (c100 - c000)
    x10 = c010 + ux * (c110 - c010)
    x01 = c001 + ux * (c101 - c001)
    x11 = c011 + ux * (c111 - c011)
    y0 = x00 + uy * (x10 - x00)
    y1 = x01 + uy * (x11 - x01)
    return y0 + uz * (y1 - y0)


def turbulence(p: V3, octaves: int = TURBULENCE_OCTAVES) -> torch.Tensor:
    """Sum of halved-weight, doubled-frequency noise octaves, in ~[0, 1)."""
    acc = None
    weight = 0.5
    freq = 1.0
    for _ in range(octaves):
        n = value_noise(p * freq) * 2.0 - 1.0
        acc = n * weight if acc is None else acc + n * weight
        weight *= 0.5
        freq *= 2.0
    return torch.abs(acc)


def triangle_wave(x: torch.Tensor) -> torch.Tensor:
    """Exact triangle wave in [-1, 1] with period 4 (``sin``-band stand-in)."""
    u = x * 0.25
    u = u - torch.floor(u)
    return torch.abs(u * 4.0 - 2.0) - 1.0
