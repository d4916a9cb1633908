"""Frozen copy of ``myraytracer_tpu_torch/core/vec.py`` at commit 32ae5bc, for
the benchmark's reference; imports made local. Edits: the float type of ``computing_in`` (float32 outside it) as the constructors' default.

Component-SoA 3-vectors on torch tensors.

Per-ray vector quantities are three same-shaped tensors (struct of arrays
over the ray axis), as in ``myraytracer_tpu.core.vec``. ``V3`` is a
NamedTuple of the three components with component-wise algebra; every
operation is one elementwise torch op per component, so each product and
sum rounds on its own exactly as the JAX package's f32 ops do (no fused
multiply-add), and the CUDA kernel (``csrc/trace.cu``) repeats the same
expression trees.

A component may also be a Python float (constant vectors such as the sky
colors); Python then does the constant arithmetic in double, the same as
the JAX package does before its weak-typed constants meet f32 arrays.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Union

import torch

Scalar = Union[float, int, torch.Tensor]

# The float type the reference computes in: float32, the configuration's,
# or a lower one for the benchmark's control (``computing_in``).
_DTYPE: contextvars.ContextVar = contextvars.ContextVar("float_dtype", default=torch.float32)


def float_dtype() -> torch.dtype:
    """The float type of the open ``computing_in`` block (float32 outside)."""
    return _DTYPE.get()


@contextlib.contextmanager
def computing_in(dtype: torch.dtype):
    """Make the reference's draws, rays, accumulators and sweeps ``dtype``
    inside the block (the scene's tables are cast by the caller)."""
    token = _DTYPE.set(dtype)
    try:
        yield
    finally:
        _DTYPE.reset(token)


class V3(NamedTuple):
    """A 3-vector stored as three same-shaped component tensors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- constructors -------------------------------------------------------

    @staticmethod
    def full(shape, value: float, device=None, dtype=None) -> "V3":
        # Three distinct tensors: a component may be written in place.
        return V3(*(
            torch.full(shape, value, dtype=dtype or float_dtype(), device=device)
            for _ in range(3)
        ))

    @staticmethod
    def zeros(shape, device=None, dtype=None) -> "V3":
        return V3.full(shape, 0.0, device, dtype)

    @staticmethod
    def ones(shape, device=None, dtype=None) -> "V3":
        return V3.full(shape, 1.0, device, dtype)

    @staticmethod
    def const(x: float, y: float, z: float, device=None, dtype=None) -> "V3":
        """A constant vector of three 0-d tensors."""
        return V3(*(torch.tensor(c, dtype=dtype or float_dtype(), device=device) for c in (x, y, z)))

    @staticmethod
    def from_stacked(a: torch.Tensor, dim: int = -1) -> "V3":
        """Split a tensor with a size-3 dimension into its components."""
        parts = torch.movedim(a, dim, 0)
        return V3(parts[0], parts[1], parts[2])

    def stacked(self, dim: int = -1) -> torch.Tensor:
        """Materialize as a tensor with a size-3 dimension."""
        return torch.stack([self.x, self.y, self.z], dim=dim)

    # -- algebra -------------------------------------------------------------

    def __add__(self, o: "V3") -> "V3":
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "V3") -> "V3":
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "V3":
        return V3(-self.x, -self.y, -self.z)

    def __mul__(self, o: Union["V3", Scalar]) -> "V3":
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o: Scalar) -> "V3":
        return V3(self.x * o, self.y * o, self.z * o)

    def dot(self, o: "V3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self) -> torch.Tensor:
        return self.dot(self)

    def length(self) -> torch.Tensor:
        return torch.sqrt(self.length_sq())

    def normalize(self) -> "V3":
        # WGSL normalize(): no epsilon guard. The reciprocal is the
        # correctly rounded 1/x, as the JAX package's ``1.0 / sqrt``.
        inv = torch.reciprocal(torch.sqrt(self.dot(self)))
        return V3(self.x * inv, self.y * inv, self.z * inv)

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def where(mask: torch.Tensor, a: "V3", b: "V3") -> "V3":
        return V3(
            torch.where(mask, a.x, b.x),
            torch.where(mask, a.y, b.y),
            torch.where(mask, a.z, b.z),
        )

    def index(self, idx) -> "V3":
        """Select lanes (a boolean mask or an index tensor) of each component."""
        return V3(self.x[idx], self.y[idx], self.z[idx])


def reflect(d: V3, n: V3) -> V3:
    """Mirror reflection, matching WGSL ``reflect`` (shader.wgsl:230):
    ``d - (2 d·n) n``, the same products as the JAX package's."""
    return d - n * (2.0 * d.dot(n))


def lerp(a: V3, b: V3, t) -> V3:
    """WGSL ``mix(a, b, t)`` (shader.wgsl:333)."""
    return a + (b - a) * t
