"""A world module of a test configuration (``textured_final.json``, in no
cell of ``BENCHMARK.json``): the RTiOW final scene's sphere field with The
Next Week's checkered ground (v3.2.3 §4.3: ``checker_texture(0.32, ...)``,
3.125 cells a unit) and a marble sphere (``noise_texture(4)``, §5.7) in
place of the brown one. ``benchmark/world.py`` builds no texture; this
module builds on its helpers and takes its views."""

from __future__ import annotations

from benchmark import world as base
from benchmark.world import views  # noqa: F401  (the turntable)


def build_world(cfg: dict, api):
    scene = cfg["scene"]
    sf, ground, marble = scene["sphere_field"], scene["checker_ground"], scene["marble_sphere"]
    spheres = base.sphere_field(api, sf["half_extent"], sf["layout_seed"])
    g = spheres[0]
    checker = api.Checker(tuple(ground["even"]), tuple(ground["odd"]), scale=ground["scale"])
    spheres[0] = api.Sphere(g.center, g.radius, api.Lambertian(checker))
    i = next(k for k, s in enumerate(spheres) if tuple(s.center) == tuple(marble["center"]))
    texture = api.Marble(tuple(marble["color"]), scale=marble["scale"])
    spheres[i] = api.Sphere(spheres[i].center, spheres[i].radius, api.Lambertian(texture))
    return api.World(spheres=spheres, camera=base.camera(cfg, api), ambient=None)
