"""Frozen copy of ``myraytracer_tpu_torch/scene/api.py`` at commit 32ae5bc, for
the benchmark's reference; imports made local. Edits: ``ImageTexture.from_png`` left out.

Public scene-description API.

Python mirror of the reference's user-facing ``api`` module
(``raytracer/src/lib.rs:611-639``): ``Lambertian { albedo }``,
``Metal { albedo, fuzz }``, ``Sphere { center, radius, material }`` and
``World { spheres }``. Extended — per the framework's scope
(SURVEY.md §7.0 / BASELINE.md configs) — with ``Dielectric`` (glass) and a
positionable thin-lens ``Camera`` with defocus blur, neither of which
exists in the reference (its camera is fixed at the origin,
``shader.wgsl:360-361``).

Material type ids match the reference (``lib.rs:644-648``,
``shader.wgsl:126-127``): 1 = Lambertian, 2 = Metal; 3 = Dielectric and
4 = DiffuseLight (emissive) are extensions; 0 is reserved for padding /
"no material" (scatters to black, like the reference's fall-through at
``shader.wgsl:249-251``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

Vec3 = Tuple[float, float, float]

MATERIAL_NONE = 0
MATERIAL_LAMBERTIAN = 1  # lib.rs:644
MATERIAL_METAL = 2  # lib.rs:646
MATERIAL_DIELECTRIC = 3  # extension
MATERIAL_LIGHT = 4  # extension (emissive)

# Procedural texture type ids (extension; RTiOW book 2 ch. 4-5 analog —
# the reference has constant colors only). Evaluated by render/textures.py.
TEXTURE_SOLID = 0
TEXTURE_CHECKER = 1
TEXTURE_MARBLE = 2
TEXTURE_IMAGE = 3


def _check_nonnegative(name: str, *values: float) -> None:
    # Albedo/fuzz nonnegativity is part of the API contract (they are
    # physically meaningless negative, and the reference's RTiOW scenes
    # never produce one). The JAX package's TPU kernel additionally relies
    # on it: it packs the material type into the sign bits of
    # albedo_r/fuzz (myraytracer_tpu/kernels/trace.py _pack_mat_bits), so a
    # negative value would decode as the wrong material there. The same
    # worlds must be valid in both packages: reject loudly at construction.
    for v in values:
        if v < 0:
            raise ValueError(f"{name} must be nonnegative, got {values}")


@dataclasses.dataclass(frozen=True)
class Checker:
    """3-D checker texture (extension; RTiOW book 2 ch. 4.3 semantics).

    ``even``/``odd`` are the two cell colors; ``scale`` is cells per unit
    length (the book's ``inv_scale`` is ``1/scale``). Usable as a
    ``Lambertian`` albedo. Colors must be nonnegative and ``scale``
    positive: the kernel packs the texture type into the sign bits of the
    odd color / scale rows (the ``_pack_mat_bits`` idiom).
    """

    even: Vec3
    odd: Vec3
    scale: float = 1.0

    tex_id = TEXTURE_CHECKER

    def __post_init__(self):
        _check_nonnegative("Checker.even", *self.even)
        _check_nonnegative("Checker.odd", *self.odd)
        if not self.scale > 0:
            raise ValueError(f"Checker.scale must be positive, got {self.scale}")


@dataclasses.dataclass(frozen=True)
class Marble:
    """Turbulent band texture (extension; RTiOW book 2 ch. 5.7 semantics,
    with tableless hash noise and an exact triangle-wave band —
    core/noise.py). ``color`` is the base color, ``scale`` the band
    frequency along z. Usable as a ``Lambertian`` albedo.
    """

    color: Vec3 = (1.0, 1.0, 1.0)
    scale: float = 1.0

    tex_id = TEXTURE_MARBLE

    def __post_init__(self):
        _check_nonnegative("Marble.color", *self.color)
        if not self.scale > 0:
            raise ValueError(f"Marble.scale must be positive, got {self.scale}")


@dataclasses.dataclass(frozen=True)
class ImageTexture:
    """Bitmap texture, sphere-UV mapped (RTiOW book 2 ch. 4.2 semantics).

    ``data`` is an ``[H, W, 3]`` float array in [0, 1] (load PNGs with
    :meth:`from_png`). The hit's OUTWARD unit normal maps to
    ``u = (atan2(-z, x) + pi) / 2pi``, ``v = acos(-y) / pi`` and the
    texel is the nearest pixel (the book's lookup), with v flipped so
    image row 0 is the top. One image texture per scene (the compiled
    scene carries the bitmap as a single device array; no atlas).

    Spheres only — the framework's meshes carry no UVs (like the book's,
    which maps only its earth sphere). ``scale`` tiles the map
    (``scale=2`` wraps the image twice around the equator; the book's
    plain mapping is ``scale=1``).
    """

    data: object  # np.ndarray-like [H, W, 3] float in [0, 1]
    scale: float = 1.0

    tex_id = TEXTURE_IMAGE

    def __post_init__(self):
        import numpy as np

        arr = np.asarray(self.data, np.float32)
        if arr.ndim != 3 or arr.shape[-1] != 3 or min(arr.shape[:2]) < 1:
            raise ValueError(
                f"ImageTexture.data must be [H, W, 3], got {arr.shape}"
            )
        if not np.isfinite(arr).all() or arr.min() < 0:
            raise ValueError("ImageTexture.data must be finite and >= 0")
        if not self.scale > 0:
            raise ValueError(
                f"ImageTexture.scale must be positive, got {self.scale}"
            )
        object.__setattr__(self, "data", arr)

    # Hashable identity for frozen-dataclass equality (numpy arrays are
    # unhashable); scenes compare textures by content.
    def __hash__(self):
        import numpy as np

        return hash((self.data.shape, float(np.sum(self.data)), self.scale))

    def __eq__(self, other):
        import numpy as np

        return (
            isinstance(other, ImageTexture)
            and self.scale == other.scale
            and self.data.shape == other.data.shape
            and bool(np.array_equal(self.data, other.data))
        )


Texture = Union[Checker, Marble, ImageTexture]


@dataclasses.dataclass(frozen=True)
class Lambertian:
    """Diffuse material (reference api::Lambertian, lib.rs:613-615).

    ``albedo`` is a constant color (the reference's contract) or a
    procedural :class:`Checker`/:class:`Marble` texture (extension).
    """

    albedo: Union[Vec3, Texture]

    type_id = MATERIAL_LAMBERTIAN

    def __post_init__(self):
        if not isinstance(self.albedo, (Checker, Marble, ImageTexture)):
            _check_nonnegative("Lambertian.albedo", *self.albedo)

    @property
    def tex_id(self) -> int:
        return getattr(self.albedo, "tex_id", TEXTURE_SOLID)


@dataclasses.dataclass(frozen=True)
class Metal:
    """Fuzzy mirror (reference api::Metal, lib.rs:618-621).

    ``albedo`` (the reflection tint) is a constant color or, as with
    :class:`Lambertian`, a procedural texture (extension) — the tint is
    then evaluated at the hit point.
    """

    albedo: Union[Vec3, Texture]
    fuzz: float = 0.0

    type_id = MATERIAL_METAL

    def __post_init__(self):
        if not isinstance(self.albedo, (Checker, Marble, ImageTexture)):
            _check_nonnegative("Metal.albedo", *self.albedo)
        _check_nonnegative("Metal.fuzz", self.fuzz)

    @property
    def tex_id(self) -> int:
        return getattr(self.albedo, "tex_id", TEXTURE_SOLID)


@dataclasses.dataclass(frozen=True)
class Dielectric:
    """Glass with refractive index ``ior`` (extension beyond the reference)."""

    ior: float = 1.5

    type_id = MATERIAL_DIELECTRIC


@dataclasses.dataclass(frozen=True)
class DiffuseLight:
    """Emissive surface (extension; RTiOW book 2 ch. 7 semantics).

    A hit adds ``throughput * emit`` to the path radiance and terminates
    the path (lights do not scatter). ``emit`` components may exceed 1
    (light intensity) but must be nonnegative: emission rides the albedo
    rows of the kernel's packed scene table, whose sign bits carry the
    material type (kernels/trace.py ``_pack_mat_bits``).
    """

    emit: Vec3

    type_id = MATERIAL_LIGHT

    def __post_init__(self):
        _check_nonnegative("DiffuseLight.emit", *self.emit)


Material = Union[Lambertian, Metal, Dielectric, DiffuseLight]


@dataclasses.dataclass(frozen=True)
class Sphere:
    """Reference api::Sphere (lib.rs:629-633).

    A negative radius yields inward-facing normals (the hollow-glass trick:
    normals are computed as ``(hit - center) / radius``, shader.wgsl:299).
    """

    center: Vec3
    radius: float
    material: Material


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Indexed triangle mesh (extension; the reference supports only spheres).

    ``vertices`` is a sequence of 3-tuples; ``triangles`` a sequence of
    vertex-index 3-tuples (counter-clockwise winding gives the outward
    geometric normal via the right-hand rule).
    """

    vertices: Tuple[Vec3, ...]
    triangles: Tuple[Tuple[int, int, int], ...]
    material: Material

    def __init__(self, vertices, triangles, material):
        object.__setattr__(self, "vertices", tuple(tuple(map(float, v)) for v in vertices))
        object.__setattr__(self, "triangles", tuple(tuple(map(int, t)) for t in triangles))
        object.__setattr__(self, "material", material)

    def __len__(self) -> int:
        return len(self.triangles)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Positionable thin-lens camera (extension; RTiOW ch. 12-13 semantics).

    The reference hard-codes a pinhole at the origin looking down -Z with a
    viewport of height 2 at focal length 1 (shader.wgsl:360-361,373-374) —
    that fixed camera is ``Camera.reference()``, reproduced exactly
    including its image-space conventions (see render/camera.py).
    """

    lookfrom: Vec3 = (0.0, 0.0, 0.0)
    lookat: Vec3 = (0.0, 0.0, -1.0)
    vup: Vec3 = (0.0, 1.0, 0.0)
    vfov_degrees: float = 90.0
    aperture: float = 0.0
    focus_dist: Optional[float] = None  # None: distance lookfrom→lookat
    # When True, use the reference's exact ray mapping (origin pinhole,
    # viewport height 2, focal length 1, its y orientation and its
    # half-pixel-shifted jitter window — shader.wgsl:373-381).
    reference_mode: bool = False

    @staticmethod
    def reference() -> "Camera":
        return Camera(reference_mode=True)

    def resolved_focus_dist(self) -> float:
        if self.focus_dist is not None:
            return float(self.focus_dist)
        dx = self.lookfrom[0] - self.lookat[0]
        dy = self.lookfrom[1] - self.lookat[1]
        dz = self.lookfrom[2] - self.lookat[2]
        return math.sqrt(dx * dx + dy * dy + dz * dz)


@dataclasses.dataclass(frozen=True)
class World:
    """Reference api::World (lib.rs:635-637) plus camera, meshes, ambient.

    ``ambient`` replaces the reference's sky gradient (shader.wgsl:331-334)
    with a constant background color when set — ``(0, 0, 0)`` makes
    emissive materials the only illumination (RTiOW book 2 ch. 7's
    ``background`` knob). ``None`` keeps the reference gradient.
    """

    spheres: Tuple[Sphere, ...]
    camera: Camera = dataclasses.field(default_factory=Camera.reference)
    meshes: Tuple[Mesh, ...] = ()
    ambient: Optional[Vec3] = None

    def __init__(
        self, spheres, camera: Optional[Camera] = None, meshes=(), ambient=None
    ):
        object.__setattr__(self, "spheres", tuple(spheres))
        object.__setattr__(
            self, "camera", camera if camera is not None else Camera.reference()
        )
        object.__setattr__(self, "meshes", tuple(meshes))
        object.__setattr__(
            self,
            "ambient",
            None if ambient is None else tuple(float(c) for c in ambient),
        )

    def __len__(self) -> int:
        return len(self.spheres)

    @property
    def triangle_count(self) -> int:
        return sum(len(m) for m in self.meshes)

    @property
    def material_set(self) -> Tuple[int, ...]:
        """Sorted material-type ids present (kernel specialization knob)."""
        mats = {s.material.type_id for s in self.spheres}
        mats |= {m.material.type_id for m in self.meshes}
        return tuple(sorted(mats))

    @property
    def texture_set(self) -> Tuple[int, ...]:
        """Sorted procedural-texture ids present (empty = untextured)."""
        texs = {getattr(s.material, "tex_id", TEXTURE_SOLID) for s in self.spheres}
        texs |= {getattr(m.material, "tex_id", TEXTURE_SOLID) for m in self.meshes}
        texs.discard(TEXTURE_SOLID)
        return tuple(sorted(texs))

    @property
    def static_ior(self) -> Optional[float]:
        """The scene-uniform dielectric IOR, or None if mixed/absent."""
        iors = {
            p.material.ior
            for p in (*self.spheres, *self.meshes)
            if p.material.type_id == MATERIAL_DIELECTRIC
        }
        return iors.pop() if len(iors) == 1 else None
