"""Binary scene dumps for the native CPU renderer.

Port of ``myraytracer_tpu.native.meshdump``: the same formats, byte for
byte. ``dump_scene`` ("MRTMIX01") is what ``--backend cpu`` loads
(``native/cpu_backend.py``, ``csrc/native/cpu_renderer.cpp``);
``dump_world`` ("MRTMESH1") and ``dump_spheres`` ("MRTSPH01") are the
single-kind formats of the renderer's benchmark mode. Each exports an API
``World``'s geometry, materials, camera and background to a flat
little-endian file.

Format ("MRTMESH1"):

    char    magic[8]      "MRTMESH1"
    int32   n_mats, n_tris
    float32 cam[12]       lookfrom xyz, lookat xyz, vup xyz,
                          vfov_degrees, aperture, focus_dist (resolved)
    int32   has_ambient
    float32 ambient[3]
    n_mats * { int32 type_id; float32 albedo[3], fuzz, ior, emit[3] }
    n_tris * { float32 v0[3], v1[3], v2[3]; int32 mat_id }

Textured albedos export their base color (the CPU baseline measures
traversal/shading throughput, not texture parity).
"""

from __future__ import annotations

import pathlib
import struct

import numpy as np

from myraytracer_tpu_torch.scene import api

MAGIC = b"MRTMESH1"
SPH_MAGIC = b"MRTSPH01"
MIX_MAGIC = b"MRTMIX01"
_TRI_RECORD = np.dtype([("v", "<f4", (9,)), ("mat", "<i4")])


def _material_row(mat) -> bytes:
    albedo = getattr(mat, "albedo", (1.0, 1.0, 1.0))
    if not isinstance(albedo, tuple):
        # Procedural texture: export its base color, mirroring
        # scene/compile._base_color so the CPU baseline attenuates like
        # the untextured kernel render (Checker -> even, Marble -> color;
        # bitmap textures have no single base color -> white).
        if isinstance(albedo, api.Checker):
            albedo = tuple(albedo.even)
        elif isinstance(albedo, api.Marble):
            albedo = tuple(albedo.color)
        else:  # ImageTexture (or future textures): explicit white
            albedo = (1.0, 1.0, 1.0)
    fuzz = float(getattr(mat, "fuzz", 0.0))
    ior = float(getattr(mat, "ior", 1.5))
    emit = tuple(getattr(mat, "emit", (0.0, 0.0, 0.0)))
    return struct.pack(
        "<i8f", int(mat.type_id), *[float(c) for c in albedo], fuzz, ior,
        *[float(c) for c in emit],
    )


def dump_world(world: api.World, path) -> int:
    """Write ``world``'s meshes to ``path``; returns the triangle count.

    Only triangle geometry exports (the CPU mesh mode is the config-5
    baseline); worlds with spheres are rejected loudly rather than
    silently dropping geometry.
    """
    if world.spheres:
        raise ValueError(
            "dump_world exports triangle meshes only; this world has "
            f"{len(world.spheres)} spheres (use the sphere bench mode)"
        )
    if not world.meshes:
        raise ValueError("world has no meshes to export")

    cam = world.camera
    if cam.reference_mode:
        raise ValueError("mesh dump needs a general (lookfrom/lookat) camera")

    mats = []
    tris = []
    for mesh in world.meshes:
        mat_id = len(mats)
        mats.append(_material_row(mesh.material))
        verts = np.asarray(mesh.vertices, np.float32)
        for (a, b, c) in np.asarray(mesh.triangles, np.int64):
            tris.append(
                struct.pack(
                    "<9fi",
                    *verts[a].tolist(), *verts[b].tolist(), *verts[c].tolist(),
                    mat_id,
                )
            )

    ambient = world.ambient
    head = MAGIC + struct.pack("<2i", len(mats), len(tris))
    head += struct.pack(
        "<12f",
        *[float(v) for v in cam.lookfrom],
        *[float(v) for v in cam.lookat],
        *[float(v) for v in cam.vup],
        float(cam.vfov_degrees),
        float(cam.aperture),
        float(cam.resolved_focus_dist()),
    )
    head += struct.pack(
        "<i3f",
        0 if ambient is None else 1,
        *(ambient if ambient is not None else (0.0, 0.0, 0.0)),
    )
    pathlib.Path(path).write_bytes(head + b"".join(mats) + b"".join(tris))
    return len(tris)


def _camera_block(world: api.World) -> bytes:
    cam = world.camera
    if cam.reference_mode:
        raise ValueError(
            "scene dump needs a general (lookfrom/lookat) camera"
        )
    ambient = world.ambient
    out = struct.pack(
        "<12f",
        *[float(v) for v in cam.lookfrom],
        *[float(v) for v in cam.lookat],
        *[float(v) for v in cam.vup],
        float(cam.vfov_degrees),
        float(cam.aperture),
        float(cam.resolved_focus_dist()),
    )
    return out + struct.pack(
        "<i3f",
        0 if ambient is None else 1,
        *(ambient if ambient is not None else (0.0, 0.0, 0.0)),
    )


def _textured_material_row(mat) -> bytes:
    """Material row with the texture extension (MRTMIX01): the base row
    plus { int32 tex_ty; float32 albedo2[3], tex_scale } — checker odd
    color / marble band scale, mirroring scene/compile._texture_row.
    ImageTexture rejects (the C side has no bitmap sampler; the jnp
    integrator serves those scenes)."""
    albedo = getattr(mat, "albedo", (1.0, 1.0, 1.0))
    tex_ty = api.TEXTURE_SOLID
    albedo2 = (0.0, 0.0, 0.0)
    tex_scale = 0.0
    if isinstance(albedo, api.Checker):
        tex_ty = api.TEXTURE_CHECKER
        albedo2 = tuple(albedo.odd)
        tex_scale = float(albedo.scale)
        albedo = tuple(albedo.even)
    elif isinstance(albedo, api.Marble):
        tex_ty = api.TEXTURE_MARBLE
        tex_scale = float(albedo.scale)
        albedo = tuple(albedo.color)
    elif not isinstance(albedo, tuple):
        raise ValueError(
            f"the native CPU path cannot shade {type(albedo).__name__} "
            "(checker/marble/solid only)"
        )
    fuzz = float(getattr(mat, "fuzz", 0.0))
    ior = float(getattr(mat, "ior", 1.5))
    emit = tuple(getattr(mat, "emit", (0.0, 0.0, 0.0)))
    return struct.pack(
        "<i8f", int(mat.type_id), *[float(c) for c in albedo], fuzz, ior,
        *[float(c) for c in emit],
    ) + struct.pack(
        "<i4f", int(tex_ty), *[float(c) for c in albedo2], tex_scale
    )


def dump_scene(world: api.World, path) -> int:
    """Write any sphere/mesh/mixed world to ``path`` ("MRTMIX01");
    returns the primitive count.

    The format ``--backend cpu`` loads: spheres and triangles share one
    deduplicated material table (with checker/marble texture rows), so
    mixed worlds (an OBJ mesh over a ground sphere, the most common real
    scene) render on the native path.

    Format: magic, int32 n_mats/n_tris/n_spheres, float32 cam[12],
    int32 has_ambient, float32 ambient[3],
    n_mats * { int32 ty; f32 albedo[3], fuzz, ior, emit[3];
               int32 tex_ty; f32 albedo2[3], tex_scale },
    n_tris * { f32 v0[3] v1[3] v2[3]; int32 mat },
    n_spheres * { f32 c[3], r (signed); int32 mat }.
    """
    if not world.spheres and not world.meshes:
        raise ValueError("world has no geometry to export")

    mats: list = []
    mat_index: dict = {}

    def mat_id(mat) -> int:
        row = _textured_material_row(mat)
        idx = mat_index.get(row)
        if idx is None:
            idx = len(mats)
            mats.append(row)
            mat_index[row] = idx
        return idx

    # One "<9fi" record a triangle, written in bulk.
    tris = []
    for mesh in world.meshes:
        mid = mat_id(mesh.material)
        verts = np.asarray(mesh.vertices, np.float32)
        faces = np.asarray(mesh.triangles, np.int64).reshape(-1, 3)
        rec = np.empty(len(faces), _TRI_RECORD)
        rec["v"] = verts[faces].reshape(-1, 9)
        rec["mat"] = mid
        tris.append(rec.tobytes())
    n_tris = sum(len(m.triangles) for m in world.meshes)
    spheres = [
        struct.pack(
            "<4fi", *[float(c) for c in s.center], float(s.radius),
            mat_id(s.material),
        )
        for s in world.spheres
    ]

    head = MIX_MAGIC + struct.pack("<3i", len(mats), n_tris, len(spheres))
    head += _camera_block(world)
    pathlib.Path(path).write_bytes(
        head + b"".join(mats) + b"".join(tris) + b"".join(spheres)
    )
    return n_tris + len(spheres)


def dump_spheres(world: api.World, path) -> int:
    """Write ``world``'s spheres to ``path`` ("MRTSPH01"); returns count.

    The sphere analog of :func:`dump_world`, for the CPU baseline on the
    sphere-scaling surface (``spheres:N`` scenes past the built-in final
    scene the C++ bench hard-codes). Per-sphere record: center, SIGNED
    radius (negative = inward normals, the hollow-glass trick), then the
    material row (type, albedo, fuzz, ior, emit).

    Format: magic, int32 n_spheres, float32 cam[12], int32 has_ambient,
    float32 ambient[3], then n_spheres * { float32 c[3], r;
    int32 ty; float32 albedo[3], fuzz, ior, emit[3] }.
    """
    if world.meshes:
        raise ValueError(
            "dump_spheres exports spheres only; this world has meshes "
            "(use dump_world)"
        )
    if not world.spheres:
        raise ValueError("world has no spheres to export")
    cam = world.camera
    if cam.reference_mode:
        raise ValueError(
            "sphere dump needs a general (lookfrom/lookat) camera"
        )

    rows = []
    for s in world.spheres:
        rows.append(
            struct.pack(
                "<4f", *[float(c) for c in s.center], float(s.radius)
            )
            + _material_row(s.material)
        )
    ambient = world.ambient
    head = SPH_MAGIC + struct.pack("<i", len(rows))
    head += struct.pack(
        "<12f",
        *[float(v) for v in cam.lookfrom],
        *[float(v) for v in cam.lookat],
        *[float(v) for v in cam.vup],
        float(cam.vfov_degrees),
        float(cam.aperture),
        float(cam.resolved_focus_dist()),
    )
    head += struct.pack(
        "<i3f",
        0 if ambient is None else 1,
        *(ambient if ambient is not None else (0.0, 0.0, 0.0)),
    )
    pathlib.Path(path).write_bytes(head + b"".join(rows))
    return len(rows)
