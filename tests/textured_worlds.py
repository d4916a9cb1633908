"""Textured test worlds, built alike from either package's scene modules.

Each builder takes an ``api`` module and a ``presets`` module -- the JAX
package's or the PyTorch port's -- and returns the same world, so a test can
hold the port against the JAX package on it (``test_torch_textures.py``)
and the CUDA kernel against its plain version (``test_torch_gpu.py``,
``chip_smoke.py``). The module imports neither package.
"""


def textured_field(A, P):
    """``sphere_field(5)`` (104 sphere slots: the gated sweep) with its
    diffuse spheres marbled or checkered, its metal ones checker-tinted
    and a checkered ground."""
    field = P.sphere_field(5)
    spheres = []
    for i, s in enumerate(field.spheres):
        m = s.material
        if i == 0:
            m = A.Lambertian(A.Checker((0.6, 0.6, 0.6), (0.2, 0.3, 0.2), scale=2.0))
        elif isinstance(m, A.Lambertian):
            m = A.Lambertian(A.Checker(m.albedo, (0.9, 0.9, 0.9), scale=8.0) if i % 2
                             else A.Marble(m.albedo, scale=6.0))
        elif isinstance(m, A.Metal):
            m = A.Metal(A.Checker(m.albedo, (0.2, 0.2, 0.2), scale=10.0), m.fuzz)
        spheres.append(A.Sphere(s.center, s.radius, m))
    return A.World(spheres, camera=field.camera)


def textured_mesh(A, P):
    """``mesh_scene()`` (448 triangle slots) with a checkered ground quad, a
    checker-tinted metal box, a marble icosphere, and a marble sphere. The
    checker scales put no flat face on a cell boundary (a plane at y = -0.5
    under scale 2 would sit on one, where an ulp of the hit point picks the
    cell)."""
    w = P.mesh_scene()
    ground, box, ico, glass = w.meshes
    meshes = [
        A.Mesh(ground.vertices, ground.triangles,
               A.Lambertian(A.Checker((0.8, 0.8, 0.0), (0.1, 0.1, 0.4), scale=1.5))),
        A.Mesh(box.vertices, box.triangles,
               A.Metal(A.Checker((0.8, 0.6, 0.2), (0.3, 0.3, 0.3), scale=4.4), fuzz=0.1)),
        A.Mesh(ico.vertices, ico.triangles, A.Lambertian(A.Marble((0.6, 0.7, 0.9), scale=5.0))),
        glass,
    ]
    sphere = A.Sphere((0.3, 0.1, -2.2), 0.6, A.Lambertian(A.Marble((0.9, 0.8, 0.7), scale=3.0)))
    return A.World([sphere], camera=w.camera, meshes=meshes)


CHECKER = dict(even=(0.9, 0.9, 0.9), odd=(0.1, 0.3, 0.1), scale=2.0)


def textured_metal(A, P):
    """A checker-tinted metal ground under a diffuse sphere (the JAX
    package's ``test_textured_metal_parity_and_effect`` world)."""
    return A.World(spheres=[
        A.Sphere((0, -100.5, -1), 100, A.Metal(A.Checker(**CHECKER))),
        A.Sphere((0, 0, -1), 0.5, A.Lambertian((0.7, 0.3, 0.3))),
    ])


def lit_textured(A, P):
    """``light_scene()`` textured: a checkered floor, the earth globe and a
    marble-tinted metal sphere, lit only by its two sphere lights."""
    w = P.light_scene()
    s = list(w.spheres)
    s[0] = A.Sphere(s[0].center, s[0].radius,
                    A.Lambertian(A.Checker((0.5, 0.5, 0.5), (0.2, 0.3, 0.2), scale=1.0)))
    s[1] = A.Sphere(s[1].center, s[1].radius, P.earth_scene().spheres[1].material)
    s[4] = A.Sphere(s[4].center, s[4].radius,
                    A.Metal(A.Marble((0.8, 0.8, 0.9), scale=2.0), fuzz=0.05))
    return A.World(s, camera=w.camera, ambient=w.ambient)


def seventy_spheres(A, P):
    """70 checkered spheres whose scale tracks their x (the JAX package's
    sorted-rows test, ``tests/test_textures.py``)."""
    return A.World(spheres=[
        A.Sphere((i * 1.0, 0, -1), 0.1, A.Lambertian(A.Checker((1, 1, 1), (0, 0, 0),
                                                                 scale=i + 1.0)))
        for i in range(70)
    ])


def preset(name):
    return lambda A, P: P.get_scene(name)


WORLDS = {
    "texture": preset("texture"),
    "earth": preset("earth"),
    "textured-field": textured_field,
    "textured-mesh": textured_mesh,
    "textured-metal": textured_metal,
    "lit-textured": lit_textured,
    "seventy": seventy_spheres,
}
