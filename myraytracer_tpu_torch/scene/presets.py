"""Built-in scenes.

``reference_scene`` reproduces the reference's hard-coded 4-sphere world
(``raytracer/src/lib.rs:687-720``) with its fixed origin camera. The other
presets are the BASELINE.md benchmark configs, which exceed the reference's
feature set (it has no dielectric, positionable camera, defocus, or scene
generator — SURVEY.md §7.0); their "reference behavior" is RTiOW semantics
anchored to the reference's conventions.
"""

from __future__ import annotations

import math

import numpy as np

from myraytracer_tpu_torch.scene.api import (
    Camera,
    Checker,
    Dielectric,
    DiffuseLight,
    Lambertian,
    Marble,
    Metal,
    Sphere,
    World,
)


def reference_scene() -> World:
    """The reference's built-in world (lib.rs:687-720), fixed camera."""
    return World(
        spheres=[
            Sphere((0.0, -100.5, -1.0), 100.0, Lambertian((0.8, 0.8, 0.0))),
            Sphere((0.0, 0.0, -1.0), 0.5, Lambertian((0.7, 0.3, 0.3))),
            Sphere((-1.0, 0.0, -1.0), 0.5, Metal((0.8, 0.8, 0.8), fuzz=0.3)),
            Sphere((1.0, 0.0, -1.0), 0.5, Metal((0.8, 0.6, 0.2), fuzz=1.0)),
        ],
        camera=Camera.reference(),
    )


def lambertian_sphere_scene() -> World:
    """BASELINE config 1: single Lambertian sphere + ground plane."""
    return World(
        spheres=[
            Sphere((0.0, 0.0, -1.0), 0.5, Lambertian((0.5, 0.5, 0.5))),
            Sphere((0.0, -100.5, -1.0), 100.0, Lambertian((0.5, 0.5, 0.5))),
        ],
        camera=Camera.reference(),
    )


def three_sphere_scene(camera: Camera | None = None) -> World:
    """BASELINE config 2: Lambertian + metal(fuzz) + hollow-glass dielectric.

    RTiOW ch. 11 scene: the hollow glass ball is an outer dielectric sphere
    with a negative-radius inner shell (inward normals).
    """
    if camera is None:
        camera = Camera.reference()
    return World(
        spheres=[
            Sphere((0.0, -100.5, -1.0), 100.0, Lambertian((0.8, 0.8, 0.0))),
            Sphere((0.0, 0.0, -1.0), 0.5, Lambertian((0.1, 0.2, 0.5))),
            Sphere((-1.0, 0.0, -1.0), 0.5, Dielectric(1.5)),
            Sphere((-1.0, 0.0, -1.0), -0.45, Dielectric(1.5)),
            Sphere((1.0, 0.0, -1.0), 0.5, Metal((0.8, 0.6, 0.2), fuzz=0.3)),
        ],
        camera=camera,
    )


def defocus_scene() -> World:
    """BASELINE config 3: positionable camera with defocus blur (RTiOW ch. 13)."""
    lookfrom = (3.0, 3.0, 2.0)
    lookat = (0.0, 0.0, -1.0)
    return three_sphere_scene(
        camera=Camera(
            lookfrom=lookfrom,
            lookat=lookat,
            vup=(0.0, 1.0, 0.0),
            vfov_degrees=20.0,
            aperture=2.0,
            focus_dist=math.dist(lookfrom, lookat),
        )
    )


def final_scene(seed: int = 0) -> World:
    """BASELINE config 4: the RTiOW final scene (~480 random spheres).

    Deterministic for a given seed (host-side numpy RNG; the reference has
    no scene generator at all).
    """
    return sphere_field(half_extent=11, seed=seed)


def sphere_field(half_extent: int = 11, seed: int = 0) -> World:
    """Final-scene-style sphere field on a ``2n × 2n`` grid (~4n² + 4
    spheres). ``half_extent=11`` IS the RTiOW final scene (identical RNG
    stream); larger grids are the sphere-scaling benchmark surface
    (``spheres:N`` in the CLI — e.g. ``spheres:100`` ≈ 40k spheres, a
    sphere table too large for the CUDA kernel's shared memory)."""
    rng = np.random.RandomState(seed)
    spheres = [Sphere((0.0, -1000.0, 0.0), 1000.0, Lambertian((0.5, 0.5, 0.5)))]

    n = int(half_extent)
    for a in range(-n, n):
        for b in range(-n, n):
            choose = rng.random_sample()
            center = (
                a + 0.9 * rng.random_sample(),
                0.2,
                b + 0.9 * rng.random_sample(),
            )
            if math.dist(center, (4.0, 0.2, 0.0)) <= 0.9:
                continue
            if choose < 0.8:
                albedo = tuple(rng.random_sample(3) * rng.random_sample(3))
                mat = Lambertian(albedo)
            elif choose < 0.95:
                albedo = tuple(0.5 + 0.5 * rng.random_sample(3))
                mat = Metal(albedo, fuzz=0.5 * rng.random_sample())
            else:
                mat = Dielectric(1.5)
            spheres.append(Sphere(center, 0.2, mat))

    spheres.append(Sphere((0.0, 1.0, 0.0), 1.0, Dielectric(1.5)))
    spheres.append(Sphere((-4.0, 1.0, 0.0), 1.0, Lambertian((0.4, 0.2, 0.1))))
    spheres.append(Sphere((4.0, 1.0, 0.0), 1.0, Metal((0.7, 0.6, 0.5), fuzz=0.0)))

    return World(
        spheres=spheres,
        camera=Camera(
            lookfrom=(13.0, 2.0, 3.0),
            lookat=(0.0, 0.0, 0.0),
            vup=(0.0, 1.0, 0.0),
            vfov_degrees=20.0,
            aperture=0.1,
            focus_dist=10.0,
        ),
    )


def mesh_scene(subdivisions: int = 2) -> World:
    """BASELINE config 5: triangle meshes (box + icosphere + ground quad).

    ~360 triangles at the default subdivision; scale with ``subdivisions``
    (icosphere triangles = 20 * 4^n).
    """
    from myraytracer_tpu_torch.scene import meshgen
    from myraytracer_tpu_torch.scene.api import Mesh

    gv, gf = meshgen.quad(
        (-6.0, -0.5, 4.0), (6.0, -0.5, 4.0), (6.0, -0.5, -8.0), (-6.0, -0.5, -8.0)
    )
    bv, bf = meshgen.box((1.1, 0.0, -1.2), (0.5, 0.5, 0.5))
    sv, sf = meshgen.icosphere((-1.1, 0.0, -1.0), 0.5, subdivisions)
    pv, pf = meshgen.icosphere((0.0, 0.05, -0.6), 0.35, max(1, subdivisions - 1))

    return World(
        spheres=[],
        meshes=[
            Mesh(gv, gf, Lambertian((0.8, 0.8, 0.0))),
            Mesh(bv, bf, Metal((0.8, 0.6, 0.2), fuzz=0.1)),
            Mesh(sv, sf, Lambertian((0.1, 0.2, 0.5))),
            Mesh(pv, pf, Dielectric(1.5)),
        ],
        camera=Camera(
            lookfrom=(0.0, 1.2, 2.5),
            lookat=(0.0, 0.0, -1.0),
            vup=(0.0, 1.0, 0.0),
            vfov_degrees=45.0,
            aperture=0.0,
        ),
    )


def light_scene() -> World:
    """Emissive-material demo (RTiOW book 2 ch. 7 "simple light" analog).

    A diffuse sphere lit only by an overhead sphere light and a dim wall
    light — ``ambient=(0,0,0)`` makes the emitters the sole illumination
    (extension: the reference has neither emissive materials nor a
    background knob).
    """
    return World(
        spheres=[
            Sphere((0.0, -1000.0, 0.0), 1000.0, Lambertian((0.5, 0.5, 0.5))),
            Sphere((0.0, 2.0, 0.0), 2.0, Lambertian((0.4, 0.6, 0.8))),
            Sphere((0.0, 8.5, 0.0), 2.0, DiffuseLight((4.0, 4.0, 4.0))),
            Sphere((5.0, 1.0, 3.0), 1.0, DiffuseLight((2.0, 1.2, 0.4))),
            Sphere((-3.5, 1.0, 2.5), 1.0, Metal((0.8, 0.8, 0.9), fuzz=0.05)),
        ],
        camera=Camera(
            lookfrom=(13.0, 3.5, 8.0),
            lookat=(0.0, 2.0, 0.0),
            vup=(0.0, 1.0, 0.0),
            vfov_degrees=25.0,
            aperture=0.0,
        ),
        ambient=(0.0, 0.0, 0.0),
    )


def cornell_scene() -> World:
    """Cornell box: quad walls, a quad ceiling light, and the two classic
    rotated boxes (15°/-18° about y, baked into the vertices with
    ``meshgen.rotate_y`` — no instance machinery needed). All
    illumination comes from the light (``ambient=(0,0,0)``).
    """
    from myraytracer_tpu_torch.scene import meshgen
    from myraytracer_tpu_torch.scene.api import Mesh

    white = Lambertian((0.73, 0.73, 0.73))
    red = Lambertian((0.65, 0.05, 0.05))
    green = Lambertian((0.12, 0.45, 0.15))
    light = DiffuseLight((15.0, 15.0, 15.0))
    s = 555.0

    def wall(p0, p1, p2, p3, mat):
        v, f = meshgen.quad(p0, p1, p2, p3)
        return Mesh(v, f, mat)

    meshes = [
        wall((s, 0, 0), (s, s, 0), (s, s, s), (s, 0, s), green),  # left
        wall((0, 0, 0), (0, s, 0), (0, s, s), (0, 0, s), red),  # right
        wall((0, 0, 0), (s, 0, 0), (s, 0, s), (0, 0, s), white),  # floor
        wall((0, s, 0), (s, s, 0), (s, s, s), (0, s, s), white),  # ceiling
        wall((0, 0, s), (s, 0, s), (s, s, s), (0, s, s), white),  # back
        wall(  # ceiling light (slightly below the ceiling plane)
            (213, 554, 227), (343, 554, 227), (343, 554, 332), (213, 554, 332),
            light,
        ),
    ]
    bv1, bf1 = meshgen.box((347.5, 165, 377.5), (82.5, 165.0, 82.5))  # tall
    bv2, bf2 = meshgen.box((212.5, 82.5, 147.5), (82.5, 82.5, 82.5))  # short
    meshes.append(Mesh(meshgen.rotate_y(bv1, 15.0), bf1, white))
    meshes.append(Mesh(meshgen.rotate_y(bv2, -18.0), bf2, white))

    return World(
        spheres=[],
        meshes=meshes,
        camera=Camera(
            lookfrom=(278.0, 278.0, -800.0),
            lookat=(278.0, 278.0, 0.0),
            vup=(0.0, 1.0, 0.0),
            vfov_degrees=40.0,
            aperture=0.0,
        ),
        ambient=(0.0, 0.0, 0.0),
    )


def obj_scene(path, material=None, ground_sphere: bool = False) -> World:
    """Render an OBJ file: mesh normalized to unit size over a ground.

    Uses the native C++ OBJ loader (``myraytracer_tpu_torch.native``;
    Python fallback). The mesh is recentered and scaled to 1.1 over its
    bounding box's diagonal at (0, 0.55, -1.2), so any model frames
    sensibly with the stock camera. ``ground_sphere`` swaps the ground
    quad for the RTiOW giant sphere: a mixed sphere and mesh world, the
    most common real scene shape.
    """
    from myraytracer_tpu_torch.native import load_obj
    from myraytracer_tpu_torch.scene import meshgen
    from myraytracer_tpu_torch.scene.api import Mesh

    vertices, triangles = load_obj(path)
    if len(triangles) == 0:
        raise ValueError(f"no triangles in {path}")
    lo = vertices.min(axis=0)
    hi = vertices.max(axis=0)
    center = (lo + hi) / 2
    scale = 1.1 / max(float(np.linalg.norm(hi - lo)), 1e-9)
    vertices = (vertices - center) * scale + np.array(
        [0.0, 0.55, -1.2], np.float32
    )

    mesh = Mesh(vertices, triangles, material or Lambertian((0.4, 0.5, 0.8)))
    camera = Camera(
        lookfrom=(0.8, 1.1, 1.2),
        lookat=(0.0, 0.5, -1.2),
        vup=(0.0, 1.0, 0.0),
        vfov_degrees=40.0,
        aperture=0.0,
    )
    if ground_sphere:
        return World(
            spheres=[
                Sphere((0.0, -1000.0, 0.0), 1000.0,
                       Lambertian((0.6, 0.6, 0.6))),
            ],
            meshes=[mesh],
            camera=camera,
        )
    gv, gf = meshgen.quad(
        (-6.0, 0.0, 4.0), (6.0, 0.0, 4.0), (6.0, 0.0, -8.0), (-6.0, 0.0, -8.0)
    )
    return World(
        spheres=[],
        meshes=[Mesh(gv, gf, Lambertian((0.6, 0.6, 0.6))), mesh],
        camera=camera,
    )


def texture_scene() -> World:
    """Procedural-texture showcase (extension; RTiOW book-2 ch. 4-5 look):
    checkered ground, marble center sphere, glass and metal flanks."""
    return World(
        spheres=[
            Sphere(
                (0.0, -1000.0, 0.0), 1000.0,
                Lambertian(Checker((0.8, 0.8, 0.8), (0.15, 0.35, 0.15),
                                   scale=1.6)),
            ),
            Sphere((0.0, 1.0, 0.0), 1.0,
                   Lambertian(Marble((0.95, 0.88, 0.78), scale=4.0))),
            Sphere((-2.2, 1.0, 0.0), 1.0, Dielectric(1.5)),
            Sphere((2.2, 1.0, 0.0), 1.0, Metal((0.8, 0.7, 0.6), fuzz=0.05)),
        ],
        camera=Camera(
            lookfrom=(6.5, 2.2, 6.5),
            lookat=(0.0, 1.0, 0.0),
            vup=(0.0, 1.0, 0.0),
            vfov_degrees=28.0,
            aperture=0.0,
        ),
    )


def _earth_bitmap(th: int = 128, tw: int = 256) -> "np.ndarray":
    """Deterministic earth-like lat-long bitmap (no binary assets in the
    repo): smoothed-noise continents over ocean, polar caps, equatorial
    brightening. Purely a test/demo map; load real PNGs with
    ``ImageTexture.from_png``."""
    rng = np.random.RandomState(7)
    # Smooth "continent" field: bilinear upsample of a coarse noise grid,
    # wrapped in longitude so the seam at u=0/1 is continuous.
    coarse = rng.random_sample((10, 18)).astype(np.float32)
    gy = np.linspace(0, coarse.shape[0] - 1, th, dtype=np.float32)
    gx = np.linspace(0, coarse.shape[1], tw, endpoint=False,
                     dtype=np.float32)
    y0 = np.floor(gy).astype(np.int32)
    x0 = np.floor(gx).astype(np.int32)
    fy = (gy - y0)[:, None]
    fx = (gx - x0)[None, :]
    y1 = np.minimum(y0 + 1, coarse.shape[0] - 1)
    x1 = (x0 + 1) % coarse.shape[1]
    f = (
        coarse[y0][:, x0] * (1 - fy) * (1 - fx)
        + coarse[y0][:, x1] * (1 - fy) * fx
        + coarse[y1][:, x0] * fy * (1 - fx)
        + coarse[y1][:, x1] * fy * fx
    )
    lat = np.linspace(90, -90, th, dtype=np.float32)[:, None]
    ocean = np.array([0.05, 0.18, 0.45], np.float32)
    land = np.array([0.22, 0.42, 0.15], np.float32)
    img = np.where((f > 0.55)[..., None], land, ocean)
    img = img * (0.75 + 0.25 * np.cos(np.deg2rad(lat))[..., None])
    img = np.where((np.abs(lat) > 74)[..., None], np.float32(0.92), img)
    return img.astype(np.float32)


def earth_scene() -> World:
    """Image-texture showcase (RTiOW book-2 ch. 4.4's earth globe): a
    sphere-UV-mapped bitmap (api.ImageTexture) over a checkered ground."""
    from myraytracer_tpu_torch.scene.api import ImageTexture

    return World(
        spheres=[
            Sphere(
                (0.0, -1000.0, 0.0), 1000.0,
                Lambertian(Checker((0.75, 0.75, 0.75), (0.3, 0.3, 0.35),
                                   scale=1.2)),
            ),
            Sphere((0.0, 2.0, 0.0), 2.0,
                   Lambertian(ImageTexture(_earth_bitmap()))),
        ],
        camera=Camera(
            lookfrom=(0.0, 2.6, 12.0),
            lookat=(0.0, 2.0, 0.0),
            vup=(0.0, 1.0, 0.0),
            vfov_degrees=22.0,
            aperture=0.0,
        ),
    )


SCENES = {
    "reference": reference_scene,
    "lambertian": lambertian_sphere_scene,
    "three-sphere": three_sphere_scene,
    "defocus": defocus_scene,
    "final": final_scene,
    "mesh": mesh_scene,
    "light": light_scene,
    "cornell": cornell_scene,
    "texture": texture_scene,
    "earth": earth_scene,
}


def get_scene(name: str, seed: int = 0) -> World:
    """Preset scene by name. Parameterized forms: ``mesh:N`` selects N
    icosphere subdivisions (~20·4^N triangles, e.g. ``mesh:5`` ≈ 25.6k);
    ``spheres:N`` a final-scene-style field on a 2N×2N grid (~4N²
    spheres, e.g. ``spheres:100`` ≈ 40k) — the scaling surfaces for the
    kernel's primitive tables."""
    if name.startswith("mesh:"):
        return mesh_scene(subdivisions=int(name.split(":", 1)[1]))
    if name.startswith("spheres:"):
        return sphere_field(half_extent=int(name.split(":", 1)[1]), seed=seed)
    if name not in SCENES:
        raise KeyError(
            f"unknown scene {name!r}; choices: {sorted(SCENES)}, "
            f"mesh:N, or spheres:N"
        )
    if name == "final":
        return final_scene(seed)
    return SCENES[name]()
