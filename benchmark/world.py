"""A configuration file's world, built with a given scene API: the world
module of every configuration that names none of its own.

The same file builds the world twice: with the program's scene API
(``myraytracer_tpu_torch.scene.api``, passed in by ``run.py``) for the
system under test, and with the cell's reference's copy (the ``api`` of
``benchmark.reference`` or of the package the configuration names) for
the check. This module imports neither.

A world module defines ``build_world(cfg, api)`` and ``views(cfg,
traffic, api)``; this one's views are the general generator's turntable
(``traffic.views``). A configuration that needs what this module lacks
names a module of its own under ``benchmark/`` in its ``"world"`` key
(``registry.py``), which may build on this one's helpers; like this file,
it is frozen once a cell that uses it is accepted.

A configuration's ``scene`` holds any of: ``sphere_field`` (the RTiOW final
scene's generator, copied from ``myraytracer_tpu_torch/scene/presets.py:
sphere_field`` at commit 32ae5bc), ``spheres``, ``quads`` and ``boxes``
(two and twelve triangles, from the copied ``meshgen``) and ``icospheres``
(``center``, ``radius`` and ``subdivisions``: ``meshgen.icosphere``'s
20 x 4^n triangles), with materials inline or named under ``materials``.
Meshes are built in that order: quads, boxes, icospheres.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference import meshgen
from benchmark.traffic import views  # noqa: F401  (this world module's views)


def _material(spec, api, named: dict):
    if isinstance(spec, str):
        spec = named[spec]
    (kind, value), = spec.items()
    if kind == "lambertian":
        return api.Lambertian(tuple(value))
    if kind == "metal":
        return api.Metal(tuple(value["albedo"]), fuzz=value["fuzz"])
    if kind == "dielectric":
        return api.Dielectric(value)
    if kind == "diffuse_light":
        return api.DiffuseLight(tuple(value))
    raise ValueError(f"unknown material {kind!r}")


def sphere_field(api, half_extent: int, layout_seed: int) -> list:
    """The RTiOW final scene's spheres: the ground, the small spheres of a
    ``2n x 2n`` grid drawn from ``RandomState(layout_seed)`` in the book's
    order, and the three large spheres."""
    rng = np.random.RandomState(layout_seed)
    spheres = [api.Sphere((0.0, -1000.0, 0.0), 1000.0, api.Lambertian((0.5, 0.5, 0.5)))]
    n = int(half_extent)
    for a in range(-n, n):
        for b in range(-n, n):
            choose = rng.random_sample()
            center = (a + 0.9 * rng.random_sample(), 0.2, b + 0.9 * rng.random_sample())
            if math.dist(center, (4.0, 0.2, 0.0)) <= 0.9:
                continue
            if choose < 0.8:
                mat = api.Lambertian(tuple(rng.random_sample(3) * rng.random_sample(3)))
            elif choose < 0.95:
                albedo = tuple(0.5 + 0.5 * rng.random_sample(3))
                mat = api.Metal(albedo, fuzz=0.5 * rng.random_sample())
            else:
                mat = api.Dielectric(1.5)
            spheres.append(api.Sphere(center, 0.2, mat))
    spheres.append(api.Sphere((0.0, 1.0, 0.0), 1.0, api.Dielectric(1.5)))
    spheres.append(api.Sphere((-4.0, 1.0, 0.0), 1.0, api.Lambertian((0.4, 0.2, 0.1))))
    spheres.append(api.Sphere((4.0, 1.0, 0.0), 1.0, api.Metal((0.7, 0.6, 0.5), fuzz=0.0)))
    return spheres


def _box(spec) -> tuple:
    """A box from its corners, turned about the y axis through the origin
    and then moved, as the book's ``rotate_y`` and ``translate`` place it."""
    lo, hi = np.asarray(spec["min"], np.float64), np.asarray(spec["max"], np.float64)
    v, f = meshgen.box(tuple((lo + hi) / 2), tuple((hi - lo) / 2))
    if spec.get("rotate_y"):
        v = meshgen.rotate_y(v, spec["rotate_y"], about=(0.0, 0.0, 0.0))
    return v + np.asarray(spec.get("translate", (0, 0, 0)), np.float32), f


def camera(cfg: dict, api, lookfrom=None):
    c = cfg["camera"]
    return api.Camera(
        lookfrom=tuple(lookfrom if lookfrom is not None else c["lookfrom"]),
        lookat=tuple(c["lookat"]), vup=tuple(c["vup"]), vfov_degrees=c["vfov_degrees"],
        aperture=c["aperture"], focus_dist=c["focus_dist"],
    )


def build_world(cfg: dict, api):
    """The configuration's world, made of ``api``'s classes."""
    scene = cfg["scene"]
    named = scene.get("materials", {})
    spheres = []
    if "sphere_field" in scene:
        sf = scene["sphere_field"]
        spheres += sphere_field(api, sf["half_extent"], sf["layout_seed"])
    for s in scene.get("spheres", ()):
        spheres.append(api.Sphere(tuple(s["center"]), s["radius"], _material(s["material"], api, named)))
    meshes = []
    for q in scene.get("quads", ()):
        v, f = meshgen.quad(*q["corners"])
        meshes.append(api.Mesh(v, f, _material(q["material"], api, named)))
    for b in scene.get("boxes", ()):
        v, f = _box(b)
        meshes.append(api.Mesh(v, f, _material(b["material"], api, named)))
    for s in scene.get("icospheres", ()):
        v, f = meshgen.icosphere(tuple(s["center"]), s["radius"], int(s["subdivisions"]))
        meshes.append(api.Mesh(v, f, _material(s["material"], api, named)))
    background = cfg["background"]
    ambient = None if background == "sky" else tuple(background)
    return api.World(spheres=spheres, camera=camera(cfg, api), meshes=meshes, ambient=ambient)
