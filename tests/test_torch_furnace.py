"""Closed-form furnace tests of the PyTorch port's estimators.

A single convex sphere under a constant background ``L``: a camera ray
either misses (exactly ``L``) or hits once and scatters away for good, so
a Lambertian sphere gives exactly ``albedo * L`` per sample whatever the
scattered direction, and so does a fuzz-0 metal. Every pixel is then a
mixture ``L + k/spp * (hit - L)`` with an integer ``k``; the assertion is
arithmetic, not statistics. The same holds under QMC camera draws and
under NEE with a zero-emit light hidden inside the sphere (every shadow
ray occluded, no path can reach the light: the MIS machinery runs on each
diffuse hit and must add nothing). Russian roulette terminates or
compensates at random, so it is held to a 4-sigma interval around the
render without it. The hollow enclosure (a negative radius, the camera
inside) must stay black with exactly ``depth`` segments a camera ray.
These are the JAX package's ``tests/test_furnace.py`` on the port's
plain integrator (``--backend torch``).
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import numpy as np
import pytest

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.render.dispatch import make_session
from myraytracer_tpu_torch.scene.api import (
    Camera, Dielectric, DiffuseLight, Lambertian, Metal, Sphere, World,
)

L = (0.6, 0.8, 1.0)
CAM = Camera(lookfrom=(0.0, 0.0, 4.0), lookat=(0.0, 0.0, 0.0), vup=(0.0, 1.0, 0.0),
             vfov_degrees=40.0, aperture=0.0)


def _world(material, hidden_light=False):
    spheres = [Sphere((0.0, 0.0, 0.0), 1.0, material)]
    if hidden_light:
        spheres.append(Sphere((0.0, 0.0, 0.0), 0.1, DiffuseLight((0.0, 0.0, 0.0))))
    return World(spheres=spheres, camera=CAM, ambient=L)


def _render(world, spp=4, depth=8, **cfg):
    config = RenderConfig(width=32, height=24, samples_per_frame=spp, ray_depth=depth,
                          backend="torch", **cfg)
    s = make_session(world, config)
    return s.step().numpy(), s


def _assert_two_level(img, hit_value, spp, tol=1e-4):
    sky = np.asarray(L, np.float32)
    diff = np.asarray(hit_value, np.float32) - sky
    lam = ((img - sky) @ diff) / float(diff @ diff)
    resid = img - (sky + lam[..., None] * diff)
    assert np.abs(resid).max() < tol
    assert lam.min() > -tol and lam.max() < 1 + tol
    k = lam * spp
    assert np.abs(k - np.round(k)).max() < spp * tol
    assert (lam > 0.5).any()


ALBEDO = (0.7, 0.5, 0.3)


@pytest.mark.parametrize("mode", [{}, dict(qmc=True), dict(nee=True), dict(nee=True, qmc=True)],
                         ids=["default", "qmc", "nee", "nee-qmc"])
def test_furnace_lambertian_exact(mode):
    img, _ = _render(_world(Lambertian(ALBEDO), hidden_light="nee" in mode), **mode)
    _assert_two_level(img, np.asarray(ALBEDO) * np.asarray(L), spp=4)


def test_furnace_nee_traces_a_shadow_ray_per_diffuse_hit():
    """The hidden light makes NEE run: one shadow segment per sphere hit."""
    world = _world(Lambertian(ALBEDO), hidden_light=True)
    _, base = _render(world)
    _, nee = _render(world, nee=True)
    hits = nee.segments_traced - base.segments_traced
    # A hit traces 2 path segments (hit, then the escape), a miss 1.
    assert hits == base.segments_traced - 32 * 24 * 4 > 0


def test_furnace_metal_fuzz0_exact():
    m = (0.9, 0.8, 0.6)
    img, _ = _render(_world(Metal(m, fuzz=0.0)))
    _assert_two_level(img, np.asarray(m) * np.asarray(L), spp=4)


def test_furnace_dielectric_conserves_energy():
    img, _ = _render(_world(Dielectric(1.5)), spp=16, depth=32)
    ratio = img / np.asarray(L, np.float32)
    assert ratio.max() < 1.0 + 1e-4
    assert ratio.min() > 0.98
    assert 1.0 - ratio.mean() < 0.005


@pytest.mark.parametrize("mode", [{}, dict(nee=True)], ids=["rr", "rr-nee"])
def test_furnace_rr_unbiased_within_ci(mode):
    """RR from bounce 1: the paired difference with the render without it
    (same camera and scatter draws) has mean zero within 4 sigma."""
    a = 0.6
    world = _world(Lambertian((a, a, a)), hidden_light="nee" in mode)
    img_rr, _ = _render(world, spp=64, depth=8, rr=1, **mode)
    img_ref, _ = _render(world, spp=64, depth=8, **mode)
    diff = (img_rr - img_ref).reshape(-1)
    assert (np.abs(diff) > 0).any()
    sem = diff.std() / np.sqrt(diff.size)
    assert abs(diff.mean()) < 4.0 * sem + 1e-4


@pytest.mark.parametrize("depth", [6, 70])
def test_enclosure_terminates_to_zero_with_exact_segments(depth):
    """Nothing escapes: black, and ``depth`` segments a camera ray, on one
    draw page and across two."""
    w, h, spp = 16, 12, 2
    world = World(spheres=[Sphere((0.0, 0.0, 4.0), -10.0, Lambertian((0.9, 0.9, 0.9)))],
                  camera=CAM, ambient=L)
    s = make_session(world, RenderConfig(width=w, height=h, samples_per_frame=spp,
                                         ray_depth=depth, backend="torch"))
    img = s.step().numpy()
    np.testing.assert_array_equal(img, np.zeros_like(img))
    assert s.segments_traced == w * h * spp * depth
