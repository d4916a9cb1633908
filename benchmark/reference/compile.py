"""Frozen copy of ``myraytracer_tpu_torch/scene/compile.py`` at commit 32ae5bc, for
the benchmark's reference; imports made local. Edits: the triangle BVH left out (the reference sweeps behind the gates).

Scene compiler: API World → SoA tensors (spheres and triangles).

Port of ``myraytracer_tpu.scene.compile``. Every sphere and triangle row
carries its own material parameters (albedo, fuzz, ior, type) beside its
geometry, so one index fetches the whole hit record.

Padding: the sphere tensors are padded to a multiple of ``SPHERE_PAD``
with ``radius_sq = -1`` slots. For a normalized ray direction,
Cauchy-Schwarz gives ``b^2 = (oc·d)^2 <= |oc|^2``, so the discriminant
``b^2 - (|oc|^2 - r^2)`` of a pad slot is ``<= -1``: pad slots never hit.

``spatial_sort`` reorders the spheres exactly as the JAX package does (a
Morton curve, the ``LEADERS`` largest spheres hoisted to the front, the
rest in kd-partitioned chunks). The order decides which sphere wins an
equal-t tie, so the port must build the same order for the same image.
Triangles past 64 are sorted by centroid into kd groups of the kernel's
triangle chunk width (``TRI_CHUNK_AUTO``) in the same way.

Triangle rows are ``v0`` and the edges ``e1 = v1 - v0``, ``e2 = v2 - v0``;
padding slots have zero edges, so their Möller-Trumbore determinant is 0
and they never hit. ``triangle_bvh`` builds the flat skip-link BVH
(``CompiledTriangleBVH``, by the native builder, ``native.build_bvh``) and
orders the triangles by its leaves instead of the centroid sort, as the
JAX package does; the plain integrator traverses it
(``render/hit.py``), the CUDA kernel sweeps behind its own gates and never
gets one.

Textured worlds get three more rows a primitive (``tex_ty``, ``albedo2``,
``tex_scale``; ``render/textures.py``), spheres and triangles alike, and
an image-textured one its bitmap (``tex_image``); the sorts carry them
with their primitives. Untextured scenes have ``None`` there, as in JAX.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .vec import V3
from . import api

# Row-count multiple of the padded sphere tensors (the JAX package's).
SPHERE_PAD = 8

# Spheres hoisted to the front of the spatially-sorted order (the LEADERS
# largest by |radius|), as in the JAX package.
LEADERS = 8


class CompiledTriangleBVH(NamedTuple):
    """Flat skip-link BVH over the (reordered) triangle tensors, [M] each.

    Traversal contract: node i descends to i+1 on a box hit (or tests its
    leaf range ``[first, first + count)``), else jumps to ``skip[i]``; done
    when the cursor reaches M.
    """

    lo: V3  # [M] f32 each
    hi: V3
    first: torch.Tensor  # [M] i32
    count: torch.Tensor  # [M] i32 (0 = interior)
    skip: torch.Tensor  # [M] i32


# Triangles a BVH leaf holds at most (the JAX package's).
BVH_MAX_LEAF = 4


class CompiledTriangles(NamedTuple):
    """SoA triangle tensors, each [T] on the scene's device; padding slots
    have zero edges (degenerate: they never hit)."""

    v0: V3  # [T] f32 each
    e1: V3  # v1 - v0
    e2: V3  # v2 - v0
    albedo: V3
    fuzz: torch.Tensor
    ior: torch.Tensor
    mat_ty: torch.Tensor  # i32
    # Texture rows (None on untextured scenes; see CompiledScene).
    tex_ty: Optional[torch.Tensor] = None  # [T] i32
    albedo2: Optional[V3] = None  # [T] f32 each (checker ODD color)
    tex_scale: Optional[torch.Tensor] = None  # [T] f32
    bvh: Optional[CompiledTriangleBVH] = None

    @property
    def padded_size(self) -> int:
        return self.fuzz.shape[0]


class CompiledScene(NamedTuple):
    """SoA scene tensors; every field is a length-N tensor on one device.

    ``radius`` is signed (negative radius = inward normals, the
    reference's ``(at - center) / radius`` at shader.wgsl:299);
    ``radius_sq`` is what the quadratic uses, and is -1 on padding slots.
    """

    center: V3  # [N] f32 each
    radius: torch.Tensor  # [N] f32, signed
    radius_sq: torch.Tensor  # [N] f32, -1 marks padding
    albedo: V3  # [N] f32 each (Lambertian/Metal albedo; 0 otherwise)
    fuzz: torch.Tensor  # [N] f32 (Metal fuzz; 0 otherwise)
    ior: torch.Tensor  # [N] f32 (Dielectric index; 1 otherwise)
    mat_ty: torch.Tensor  # [N] i32 (0 pad, 1 lambertian, 2 metal, 3 dielectric)
    tris: Optional[CompiledTriangles] = None
    # Optional packed runtime camera ([19] f32, render.camera.pack_camera):
    # when set, a general-mode renderer reads the thin-lens basis from it
    # instead of its construction-time camera.
    cam: Optional[torch.Tensor] = None
    # Texture rows (render/textures.py), None on untextured scenes:
    # ``albedo`` doubles as the solid / checker-EVEN / marble base color (a
    # white multiplier for an image), ``albedo2`` is the checker ODD color,
    # ``tex_scale`` the frequency or tiling.
    tex_ty: Optional[torch.Tensor] = None  # [N] i32 (api.TEXTURE_*)
    albedo2: Optional[V3] = None  # [N] f32 each
    tex_scale: Optional[torch.Tensor] = None  # [N] f32
    # The bitmap of TEXTURE_IMAGE primitives ([TH, TW, 3] f32; one image a
    # scene, None unless it has an api.ImageTexture).
    tex_image: Optional[torch.Tensor] = None

    @property
    def padded_size(self) -> int:
        return self.radius.shape[0]

    @property
    def device(self) -> torch.device:
        return self.radius.device

    @property
    def has_triangles(self) -> bool:
        return self.tris is not None


# The names of the JAX ``CompiledScene`` leaves, in its pytree order (the
# order ``scene_fingerprint`` hashes): the sphere leaves every scene has,
# the triangle leaves a scene with meshes has (then its BVH's, when it has
# one, and its texture rows, on a textured scene), then a textured scene's
# sphere texture rows and its bitmap, if it has one.
SPHERE_LEAVES = (
    "center.x", "center.y", "center.z", "radius", "radius_sq",
    "albedo.x", "albedo.y", "albedo.z", "fuzz", "ior", "mat_ty",
)
TRIANGLE_LEAVES = tuple(
    f"tris.{v}.{c}" for v in ("v0", "e1", "e2") for c in "xyz"
) + ("tris.albedo.x", "tris.albedo.y", "tris.albedo.z",
     "tris.fuzz", "tris.ior", "tris.mat_ty")
BVH_LEAVES = tuple(f"tris.bvh.{b}.{c}" for b in ("lo", "hi") for c in "xyz") + (
    "tris.bvh.first", "tris.bvh.count", "tris.bvh.skip")
TRIANGLE_TEXTURE_LEAVES = (
    "tris.tex_ty", "tris.albedo2.x", "tris.albedo2.y", "tris.albedo2.z", "tris.tex_scale",
)
TEXTURE_LEAVES = ("tex_ty", "albedo2.x", "albedo2.y", "albedo2.z", "tex_scale")
IMAGE_LEAF = "tex_image"
SCENE_LEAVES = (SPHERE_LEAVES + TRIANGLE_LEAVES + BVH_LEAVES + TRIANGLE_TEXTURE_LEAVES
                + TEXTURE_LEAVES + (IMAGE_LEAF,))


def leaf(scene, name: str):
    """The leaf ``name`` (e.g. ``"tris.v0.x"``) of a compiled scene of
    either package, or None where the scene has no such part."""
    for part in name.split("."):
        if scene is None:
            return None
        scene = getattr(scene, part)
    return scene


def _pad(a: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[: a.shape[0]] = a
    return out


def _texture_row(m: api.Material):
    """Denormalized (tex_ty, albedo2, tex_scale) for one material: solid
    materials get ``(TEXTURE_SOLID, (0, 0, 0), 0.0)``; a texture's base
    color rides the albedo row (``_base_color``)."""
    a = getattr(m, "albedo", None)
    if isinstance(a, api.Checker):
        return api.TEXTURE_CHECKER, a.odd, a.scale
    if isinstance(a, api.Marble):
        return api.TEXTURE_MARBLE, (0.0, 0.0, 0.0), a.scale
    if isinstance(a, api.ImageTexture):
        return api.TEXTURE_IMAGE, (0.0, 0.0, 0.0), a.scale
    return api.TEXTURE_SOLID, (0.0, 0.0, 0.0), 0.0


def _base_color(a):
    """A solid albedo, or a texture's base color (the checker's even color,
    the marble color, white for an image: the bitmap is the color)."""
    if isinstance(a, api.Checker):
        return a.even
    if isinstance(a, api.Marble):
        return a.color
    if isinstance(a, api.ImageTexture):
        return (1.0, 1.0, 1.0)
    return a


def _material_row(m: api.Material):
    """Denormalized (albedo, fuzz, ior, type) for one material."""
    if isinstance(m, api.Lambertian):
        return _base_color(m.albedo), 0.0, 1.0, m.type_id
    if isinstance(m, api.Metal):
        return _base_color(m.albedo), m.fuzz, 1.0, m.type_id
    if isinstance(m, api.Dielectric):
        return (0.0, 0.0, 0.0), 0.0, m.ior, m.type_id
    if isinstance(m, api.DiffuseLight):
        # Emission rides the albedo columns (lights never scatter).
        return m.emit, 0.0, 1.0, m.type_id
    raise TypeError(f"unknown material: {m!r}")


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 10-bit xyz quantized coords into a 30-bit Morton code."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )


def morton_order(centers: np.ndarray) -> np.ndarray:
    """Sphere permutation by Morton code of the center (stable)."""
    lo = centers.min(axis=0)
    span = np.maximum(centers.max(axis=0) - lo, 1e-12)
    q = np.clip(((centers - lo) / span * 1023.0), 0, 1023).astype(np.uint32)
    return np.argsort(_morton3(q), kind="stable")


def kd_chunk_order(centers: np.ndarray, chunk: int) -> np.ndarray:
    """Permutation grouping centers into consecutive ``chunk``-sized,
    spatially compact groups by recursive balanced longest-axis splits.
    Split points land on multiples of ``chunk`` so only the final group is
    partial. Like the Morton sort, the reorder affects only equal-t
    tie-breaking."""

    def rec(idx):
        if len(idx) <= chunk:
            return [idx]
        c = centers[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = idx[np.argsort(c[:, ax], kind="stable")]
        n_groups = -(-len(idx) // chunk)
        m = (n_groups // 2) * chunk
        return rec(order[:m]) + rec(order[m:])

    return np.concatenate(rec(np.arange(len(centers))))


def sphere_order(world: api.World, partition: str = "kd",
                 partition_chunk: int = 48) -> np.ndarray:
    """The JAX package's spatial-sort permutation of ``world.spheres``."""
    spheres = world.spheres
    n = len(spheres)
    if partition not in ("morton", "kd"):
        raise ValueError(f"unknown partition {partition!r}")
    centers = np.asarray([s.center for s in spheres], np.float32)
    order = morton_order(centers)
    if n > LEADERS:
        # Hoist the LEADERS largest spheres to the front, keeping Morton
        # order within each group.
        radii = np.abs(np.asarray([s.radius for s in spheres], np.float32))
        big = np.argsort(-radii[order], kind="stable")[:LEADERS]
        lead_mask = np.zeros(len(order), bool)
        lead_mask[big] = True
        order = np.concatenate([order[lead_mask], order[~lead_mask]])
        if partition == "kd":
            rest = order[LEADERS:]
            order = np.concatenate([
                order[:LEADERS],
                rest[kd_chunk_order(centers[rest], partition_chunk)],
            ])
    elif partition == "kd":
        order = order[kd_chunk_order(centers[order], partition_chunk)]
    return order


# The kernel's triangle chunk widths by triangle count (the JAX package's
# ladder; ``config.resolve_tri_chunk`` reads it): the kd partition aligns
# triangle groups to the width the kernel gates at.
TRI_CHUNK_AUTO = ((768, 64), (8192, 32), (None, 16))


def _auto_tri_chunk(n_tris: int) -> int:
    for bound, chunk in TRI_CHUNK_AUTO:
        if bound is None or n_tris <= bound:
            return chunk
    return TRI_CHUNK_AUTO[-1][1]


def _compile_triangles(meshes, pad_to: int, spatial_sort: bool,
                       partition: str = "kd", textured: bool = False,
                       with_bvh: bool = False) -> Dict[str, np.ndarray]:
    """The triangle leaves (``TRIANGLE_LEAVES``, ``BVH_LEAVES`` with ``with_bvh``
    and ``TRIANGLE_TEXTURE_LEAVES`` when ``textured``) of ``meshes`` as
    numpy arrays, padded to a multiple of ``pad_to`` with zero-edge slots.
    ``with_bvh`` orders them by the BVH's leaves; else, past 64 triangles,
    ``spatial_sort`` orders them by centroid as the JAX package does (``kd``
    groups of the auto chunk width, or Morton)."""
    t = sum(len(m) for m in meshes)
    tpad = max(pad_to, -(-max(t, 1) // pad_to) * pad_to)
    v0 = np.zeros((t, 3), np.float32)
    e1 = np.zeros((t, 3), np.float32)
    e2 = np.zeros((t, 3), np.float32)
    albedo = np.zeros((t, 3), np.float32)
    fuzz = np.zeros((t,), np.float32)
    ior = np.ones((t,), np.float32)
    mat_ty = np.zeros((t,), np.int32)
    tex_ty = np.zeros((t,), np.int32)
    albedo2 = np.zeros((t, 3), np.float32)
    tex_scale = np.zeros((t,), np.float32)
    k = 0
    for mesh in meshes:
        verts = np.asarray(mesh.vertices, np.float32)
        alb, fz, io, ty = _material_row(mesh.material)
        tty, a2, tsc = _texture_row(mesh.material)
        tri = np.asarray(mesh.triangles, np.int32).reshape(-1, 3)
        n_m = tri.shape[0]
        if n_m == 0:
            continue
        a = verts[tri[:, 0]]
        v0[k:k + n_m] = a
        e1[k:k + n_m] = verts[tri[:, 1]] - a
        e2[k:k + n_m] = verts[tri[:, 2]] - a
        albedo[k:k + n_m] = alb
        fuzz[k:k + n_m] = fz
        ior[k:k + n_m] = io
        mat_ty[k:k + n_m] = ty
        tex_ty[k:k + n_m] = tty
        albedo2[k:k + n_m] = a2
        tex_scale[k:k + n_m] = tsc
        k += n_m

    if spatial_sort and not with_bvh and t > 64:
        cent = v0 + (e1 + e2) / 3.0
        if partition == "kd":
            order = kd_chunk_order(cent, _auto_tri_chunk(t))
        else:
            order = morton_order(cent)
        v0, e1, e2, albedo = v0[order], e1[order], e2[order], albedo[order]
        fuzz, ior, mat_ty = fuzz[order], ior[order], mat_ty[order]
        tex_ty, albedo2, tex_scale = tex_ty[order], albedo2[order], tex_scale[order]

    out = {}
    if with_bvh and t > 0:
        # The reference sweeps behind the kernel's gates and never builds a
        # BVH (the native builder is the program's).
        raise ValueError("the benchmark's reference builds no triangle BVH")
    vectors = [("v0", v0), ("e1", e1), ("e2", e2), ("albedo", albedo)]
    if textured:
        vectors.append(("albedo2", albedo2))
        out["tris.tex_ty"] = _pad(tex_ty, tpad, api.TEXTURE_SOLID)
        out["tris.tex_scale"] = _pad(tex_scale, tpad, 0.0)
    for name, a in vectors:
        a = _pad(a, tpad, 0.0)  # zero-edge padding is degenerate: never hits
        for j, c in enumerate("xyz"):
            out[f"tris.{name}.{c}"] = a[:, j]
    out["tris.fuzz"] = _pad(fuzz, tpad, 0.0)
    out["tris.ior"] = _pad(ior, tpad, 1.0)
    out["tris.mat_ty"] = _pad(mat_ty, tpad, api.MATERIAL_NONE)
    return out


def _image_texture(world: api.World):
    """The scene's one ImageTexture, or None. Sphere materials only (meshes
    carry no UVs), and at most one distinct image a scene (the compiled
    scene carries one bitmap)."""
    for m in world.meshes:
        if isinstance(getattr(m.material, "albedo", None), api.ImageTexture):
            raise ValueError("ImageTexture maps sphere UVs only; meshes carry no UVs")
    imgs = []
    for s in world.spheres:
        a = getattr(s.material, "albedo", None)
        if isinstance(a, api.ImageTexture) and a not in imgs:
            imgs.append(a)
    if len(imgs) > 1:
        raise ValueError(
            f"one ImageTexture per scene (got {len(imgs)} distinct); "
            "pack shared maps into a single image"
        )
    return imgs[0] if imgs else None


def compile_scene(
    world: api.World,
    pad_to: int = SPHERE_PAD,
    spatial_sort: bool = False,
    partition: str = "kd",
    partition_chunk: int = 48,
    device="cpu",
    triangle_bvh: bool = False,
) -> CompiledScene:
    """Flatten an api.World into padded SoA tensors on ``device``.

    ``spatial_sort``, ``partition``, ``partition_chunk`` and
    ``triangle_bvh`` order the spheres and triangles, and build the
    triangle BVH, as the JAX ``compile_scene`` does with the same
    arguments; a textured world's texture rows and bitmap too.
    """
    n = len(world.spheres)
    spheres = world.spheres
    if spatial_sort and n > 1:
        order = sphere_order(world, partition, partition_chunk)
        spheres = tuple(spheres[i] for i in order)
    npad = max(pad_to, -(-max(n, 1) // pad_to) * pad_to)

    center = np.zeros((n, 3), np.float32)
    radius = np.zeros((n,), np.float32)
    albedo = np.zeros((n, 3), np.float32)
    fuzz = np.zeros((n,), np.float32)
    ior = np.ones((n,), np.float32)
    mat_ty = np.zeros((n,), np.int32)
    tex_ty = np.zeros((n,), np.int32)
    albedo2 = np.zeros((n, 3), np.float32)
    tex_scale = np.zeros((n,), np.float32)
    for i, s in enumerate(spheres):
        center[i] = s.center
        radius[i] = s.radius
        albedo[i], fuzz[i], ior[i], mat_ty[i] = _material_row(s.material)
        tex_ty[i], albedo2[i], tex_scale[i] = _texture_row(s.material)
    # Texture rows only on textured scenes (one switch for spheres and
    # meshes), so an untextured scene has the leaves it had before.
    textured = bool(world.texture_set)
    img_tex = _image_texture(world)

    radius_sq = radius * radius
    center_p = _pad(center, npad, 0.0)
    albedo_p = _pad(albedo, npad, 0.0)
    arrays = {
        "center.x": center_p[:, 0],
        "center.y": center_p[:, 1],
        "center.z": center_p[:, 2],
        "radius": _pad(radius, npad, 1.0),
        "radius_sq": _pad(radius_sq, npad, -1.0),
        "albedo.x": albedo_p[:, 0],
        "albedo.y": albedo_p[:, 1],
        "albedo.z": albedo_p[:, 2],
        "fuzz": _pad(fuzz, npad, 0.0),
        "ior": _pad(ior, npad, 1.0),
        "mat_ty": _pad(mat_ty, npad, api.MATERIAL_NONE),
    }
    if textured:
        albedo2_p = _pad(albedo2, npad, 0.0)
        arrays.update({
            "tex_ty": _pad(tex_ty, npad, api.TEXTURE_SOLID),
            "albedo2.x": albedo2_p[:, 0],
            "albedo2.y": albedo2_p[:, 1],
            "albedo2.z": albedo2_p[:, 2],
            "tex_scale": _pad(tex_scale, npad, 0.0),
        })
    if img_tex is not None:
        arrays[IMAGE_LEAF] = img_tex.data
    if world.meshes:
        arrays.update(_compile_triangles(world.meshes, pad_to, spatial_sort, partition,
                                         textured, with_bvh=bool(triangle_bvh)))
    return scene_from_numpy(arrays, device=device)


def scene_from_numpy(arrays: Dict[str, np.ndarray], device="cpu") -> CompiledScene:
    """Build the port's scene from a compiled scene's arrays.

    ``arrays`` maps each name of ``SPHERE_LEAVES``, for a scene with meshes
    each of ``TRIANGLE_LEAVES`` (and of ``BVH_LEAVES``, when it has a
    triangle BVH), for a textured scene each of
    ``TEXTURE_LEAVES`` (and of ``TRIANGLE_TEXTURE_LEAVES`` with meshes),
    and optionally ``IMAGE_LEAF`` (the [TH, TW, 3] bitmap) and ``"cam"``
    (the [19] packed camera), to a numpy array: the leaves of a JAX
    ``CompiledScene`` carry across unchanged, so the same compiled world
    can be rendered by both packages.
    """
    has_tris = any(k in arrays for k in TRIANGLE_LEAVES)
    textured = any(k in arrays for k in TEXTURE_LEAVES + TRIANGLE_TEXTURE_LEAVES)
    need = SPHERE_LEAVES + (TRIANGLE_LEAVES if has_tris else ())
    if has_tris and any(k in arrays for k in BVH_LEAVES):
        need += BVH_LEAVES
    if textured:
        need += TEXTURE_LEAVES + (TRIANGLE_TEXTURE_LEAVES if has_tris else ())
    missing = [k for k in need if k not in arrays]
    if missing:
        raise KeyError(f"scene arrays lack {missing}")
    # np.array copies: the scene owns its memory whatever the caller holds.
    t = lambda k, dt: torch.from_numpy(np.array(arrays[k], dtype=dt, order="C")).to(device)  # noqa: E731
    opt = lambda k, dt: t(k, dt) if k in arrays else None  # noqa: E731
    f32, i32 = np.float32, np.int32
    v3 = lambda p: V3(t(f"{p}x", f32), t(f"{p}y", f32), t(f"{p}z", f32))  # noqa: E731
    tris = None
    if has_tris:
        bvh = None
        if any(k in arrays for k in BVH_LEAVES):
            bvh = CompiledTriangleBVH(
                lo=v3("tris.bvh.lo."), hi=v3("tris.bvh.hi."), first=t("tris.bvh.first", i32),
                count=t("tris.bvh.count", i32), skip=t("tris.bvh.skip", i32))
        tris = CompiledTriangles(
            v0=v3("tris.v0."), e1=v3("tris.e1."), e2=v3("tris.e2."),
            albedo=v3("tris.albedo."), fuzz=t("tris.fuzz", f32),
            ior=t("tris.ior", f32), mat_ty=t("tris.mat_ty", i32),
            tex_ty=opt("tris.tex_ty", i32),
            albedo2=v3("tris.albedo2.") if textured else None,
            tex_scale=opt("tris.tex_scale", f32),
            bvh=bvh,
        )
    return CompiledScene(
        center=v3("center."),
        radius=t("radius", f32),
        radius_sq=t("radius_sq", f32),
        albedo=v3("albedo."),
        fuzz=t("fuzz", f32),
        ior=t("ior", f32),
        mat_ty=t("mat_ty", i32),
        tris=tris,
        cam=opt("cam", f32),
        tex_ty=opt("tex_ty", i32),
        albedo2=v3("albedo2.") if textured else None,
        tex_scale=opt("tex_scale", f32),
        tex_image=opt(IMAGE_LEAF, f32),
    )


def compile_reference_layout(world: api.World) -> Dict[str, object]:
    """Reproduce the reference's pool/range flattening semantics.

    Mirrors the behavior of ``Object::new``'s SoA packing
    (``raytracer/src/lib.rs:722-799``): spheres keep insertion order; each
    material is appended to its per-type pool in sphere order and the sphere
    records (type, index-within-pool); the three typed streams are built by
    appending ranges (sphere centers then lambertian albedos then metal
    albedos into the vec4 stream; radii then fuzzes into the f32 stream;
    material types then material indices into the i32 stream).

    Port of the JAX package's function, for parity tests and as
    documentation of the reference contract; the renderer itself consumes
    :func:`compile_scene`.
    """
    sphere_centers = []
    sphere_radii = []
    sphere_mat_tys = []
    sphere_mat_idxs = []
    lamb_albedos = []
    metal_albedos = []
    metal_fuzzes = []
    dielectric_iors = []

    for s in world.spheres:
        sphere_centers.append([*s.center, 1.0])  # vec4 w=1.0 like lib.rs:769
        sphere_radii.append(s.radius)
        m = s.material
        sphere_mat_tys.append(m.type_id)
        if isinstance(m, api.Lambertian):
            sphere_mat_idxs.append(len(lamb_albedos))
            # Textured albedo (extension) has no reference-layout slot;
            # its base color stands in (the reference predates textures).
            a = _material_row(m)[0]
            lamb_albedos.append([*a, 1.0])
        elif isinstance(m, api.Metal):
            sphere_mat_idxs.append(len(metal_albedos))
            metal_albedos.append([*m.albedo, 1.0])
            metal_fuzzes.append(m.fuzz)
        elif isinstance(m, api.Dielectric):
            sphere_mat_idxs.append(len(dielectric_iors))
            dielectric_iors.append(m.ior)

    vec4_f32_data = []
    f32_data = []
    i32_data = []

    def push(stream, items):
        base = len(stream)
        stream.extend(items)
        return base

    ranges = {
        "spheres": {
            "center_base_idx": push(vec4_f32_data, sphere_centers),
            "radius_base_idx": push(f32_data, sphere_radii),
            "material_ty_base_idx": push(i32_data, sphere_mat_tys),
            "material_idx_base_idx": push(i32_data, sphere_mat_idxs),
            "length": len(world.spheres),
        },
        "lambertians": {
            "albedo_base_idx": push(vec4_f32_data, lamb_albedos),
            "length": len(lamb_albedos),
        },
        "metals": {
            "albedo_base_idx": push(vec4_f32_data, metal_albedos),
            "fuzz_base_idx": push(f32_data, metal_fuzzes),
            "length": len(metal_albedos),
        },
        # Extension beyond the reference layout:
        "dielectrics": {
            "ior_base_idx": push(f32_data, dielectric_iors),
            "length": len(dielectric_iors),
        },
    }
    return {
        "world": ranges,
        "vec4_f32_data": np.asarray(vec4_f32_data, np.float32).reshape(-1, 4),
        "f32_data": np.asarray(f32_data, np.float32),
        "i32_data": np.asarray(i32_data, np.int32),
    }
