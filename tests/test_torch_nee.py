"""Next-event estimation with MIS and emission in the PyTorch port.

The CUDA kernel is held bitwise to the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``). Here, on the CPU, the
plain version is held against the JAX package:

* ``extract_lights`` gives JAX's light list, and ``light_table`` rounds
  each constant to f32 where JAX's weak typing does;
* ``sample_lights`` and ``light_pdf_at_hit`` against JAX run eagerly
  (``jax.disable_jit()``, no fusion): the masks are equal, the floats
  within the CPU libms' ulps (torch's and XLA's ``cos``/``sin``/``rsqrt``
  differ in ~5-34% of inputs by 1-2 ulp; ``ROADMAP.md`` section 3), stated
  as rtol 1e-5 with an atol of 1e-6;
* the shadow sweep (``render.hit.closest_t`` from ``t_init = limit``) gives
  the JAX oracle's occlusion ``closest_hit(...).mask & (t < limit)``, and
  its gated form the ungated one;
* the plain integrator against the JAX jnp integrator: jitted, under the
  statistical bar of ``test_torch_trace.assert_render_close`` (XLA
  contracts multiply-adds into FMAs), and eagerly, where every pixel is
  within rtol 1e-4, atol 1e-5 and the segment counts are equal. Measured
  on this CPU, pixels within tolerance (jitted / eager): light --nee 16x8
  1.0 / 24x16 1.0 (0.966 bit for bit); cornell --nee --rr 3 16x8 0.984
  (segments 728 vs 727) / 24x16 1.0 (0.943 bit for bit, 2880 = 2880).
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu.core.vec import V3 as JV3
from myraytracer_tpu.render import lights as jlights
from myraytracer_tpu.render.hit import closest_hit as jclosest_hit
from myraytracer_tpu.render.integrator import make_renderer as make_jnp
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu.scene.compile import compile_scene as jcompile
from myraytracer_tpu_torch.config import KernelConfig, RenderConfig
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.core.vec import V3
from myraytracer_tpu_torch.kernels import trace as ktrace
from myraytracer_tpu_torch.render import integrator
from myraytracer_tpu_torch.render import lights
from myraytracer_tpu_torch.render.camera import pack_camera
from myraytracer_tpu_torch.render.hit import closest_t
from myraytracer_tpu_torch.render.session import RenderSession, wants_spatial_sort
from myraytracer_tpu_torch.scene import api, meshgen, presets
from myraytracer_tpu_torch.scene.compile import compile_scene

from test_torch_trace import assert_render_close

KEY = trng.key_from_seed(0)
UNCULLED = KernelConfig(FORCE_CULL=False, UNROLL_MAX=1 << 30)
GATED_TRIS = KernelConfig(UNROLL_MAX=0, TRI_CHUNK=4)


def lit_field() -> api.World:
    """``sphere_field(5)`` (104 sphere slots: gated) under one sphere light,
    with a black background: NEE's shadow rays take the gated sweep."""
    field = presets.sphere_field(5)
    light = api.Sphere((0.0, 12.0, 0.0), 3.0, api.DiffuseLight((6.0, 6.0, 6.0)))
    return api.World(list(field.spheres) + [light], camera=field.camera,
                     ambient=(0.0, 0.0, 0.0))


def quad_light_world(emit=7.0) -> api.World:
    v, f = meshgen.quad((-1.0, 3.0, -1.0), (1.0, 3.0, -1.0), (1.0, 3.0, 1.0), (-1.0, 3.0, 1.0))
    return api.World(spheres=[], meshes=[api.Mesh(v, f, api.DiffuseLight((emit,) * 3))])


def render_pair(name, w, h, spp, depth, eager=False, nee=False, rr=0, qmc=False):
    """(port image, port segments, JAX image, JAX segments) of one preset
    with the same modes, from key 0 and sample 0."""
    jworld = jpresets.get_scene(name)
    sort = len(jworld.spheres) > 64 or jworld.triangle_count > 64
    jr = make_jnp(jworld.camera, w, h, spp, depth, sample_batch=spp, sky=jworld.ambient,
                  nee_lights=jlights.extract_lights(jworld) if nee else None, rr=rr, qmc=qmc)
    jscene = jcompile(jworld, spatial_sort=sort)
    if eager:
        with jax.disable_jit():
            want, jsegs = jr(jscene, jrng.key_from_seed(0), 0)
    else:
        want, jsegs = jr(jscene, jrng.key_from_seed(0), 0)
    world = presets.get_scene(name)
    r = integrator.make_renderer(world.camera, w, h, spp, depth, sky=world.ambient,
                                 sample_batch=spp, rr=rr, qmc=qmc,
                                 nee_lights=lights.extract_lights(world) if nee else None)
    got, segs = r(compile_scene(world, spatial_sort=wants_spatial_sort(world)), KEY, 0)
    return got.numpy(), float(segs), np.asarray(want), float(jsegs)


def assert_eager_equal(got, segs, want, jsegs):
    """Against the unfused JAX integrator: every pixel within tolerance and
    the same segment count (the same paths)."""
    assert np.isclose(got, want, rtol=1e-4, atol=1e-5).all()
    assert segs == jsegs


@pytest.mark.parametrize("name,n,kind", [("light", 2, "sphere"), ("cornell", 2, "tri"),
                                         ("reference", 0, None), ("final", 0, None)])
def test_extract_lights_matches_jax(name, n, kind):
    got = lights.extract_lights(presets.get_scene(name))
    assert got == jlights.extract_lights(jpresets.get_scene(name))
    assert len(got) == n and all(light[0] == kind for light in got)


def test_light_table_rounds_where_jax_does():
    """Python-float subexpressions are rounded once, in double; the table
    holds them as f32."""
    world = presets.get_scene("light")
    lt = lights.light_table(lights.extract_lights(world))
    assert lt.dtype == np.float32 and lt.shape == (2, lights.LIGHT_COLS)
    r = 2.0
    assert lt[0, lights.LT_RR_OK] == np.float32((r * r) * (1.0 + 1e-6))
    assert lt[0, lights.LT_PI_N] == np.float32(math.pi / 2)
    tri = lights.extract_lights(presets.get_scene("cornell"))
    tt = lights.light_table(tri)
    for row, light in zip(tt, tri):
        nu, _, area = jlights._tri_consts(*light[1:4])
        np.testing.assert_array_equal(row[lights.LT_NX:lights.LT_NZ + 1], np.float32(nu))
        assert row[lights.LT_AREA] == np.float32(area)
        np.testing.assert_array_equal(row[lights.LT_ER:lights.LT_EB + 1], np.float32(light[4]))


def _points(n, rng, lo_y=0.0, hi_y=2.9):
    return [rng.uniform(lo, hi, n).astype(np.float32)
            for lo, hi in ((-2, 2), (lo_y, hi_y), (-2, 2))]


@pytest.mark.parametrize("world", ["light", "cornell-quad", "quad"])
def test_sample_lights_matches_jax_eager(world):
    if world == "light":
        w = presets.light_scene()
        rng = np.random.default_rng(1)
        pts = [rng.uniform(-6, 6, 512).astype(np.float32), rng.uniform(0, 9, 512).astype(
            np.float32), rng.uniform(-6, 6, 512).astype(np.float32)]
    elif world == "cornell-quad":
        w = presets.cornell_scene()
        rng = np.random.default_rng(2)
        pts = [rng.uniform(0, 555, 512).astype(np.float32) for _ in range(3)]
    else:
        w = quad_light_world()
        rng = np.random.default_rng(3)
        pts = _points(512, rng)
    lt = lights.extract_lights(w)
    nrm = rng.normal(size=(3, 512)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0)
    us = [rng.uniform(0, 1, 512).astype(np.float32) for _ in range(3)]
    with jax.disable_jit():
        j = jlights.sample_lights(lt, JV3(*map(jnp.asarray, pts)), JV3(*map(jnp.asarray, nrm)),
                                  *map(jnp.asarray, us))
    t = lights.sample_lights(lt, V3(*map(torch.from_numpy, pts)),
                             V3(*map(torch.from_numpy, nrm)), *map(torch.from_numpy, us))
    assert t[3].numpy().any() and (~t[3].numpy()).any()
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    for a, b in ((t[0], j[0]), (t[2], j[2])):
        for ca, cb in zip(a, b):
            np.testing.assert_allclose(ca.numpy(), np.asarray(cb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", ["light", "quad"])
def test_light_pdf_at_hit_matches_jax_eager(world):
    """Rays the light sampler draws reach the light and match it (the
    pickup side of MIS), and rays aimed elsewhere do not: the same
    densities, and the same zeros, as JAX's."""
    w = presets.light_scene() if world == "light" else quad_light_world()
    lt = lights.extract_lights(w)
    rng = np.random.default_rng(4)
    pts = _points(256, rng, 0.0, 1.0)
    nrm = np.stack([np.zeros(256), np.ones(256), np.zeros(256)]).astype(np.float32)
    us = [rng.uniform(0, 1, 256).astype(np.float32) for _ in range(3)]
    p, n = V3(*map(torch.from_numpy, pts)), V3(*map(torch.from_numpy, nrm))
    omega, t_p, _, add = lights.sample_lights(lt, p, n, *map(torch.from_numpy, us))
    # Half the rays as sampled, half scrambled off the light.
    d = V3(*(torch.where(torch.arange(256) % 2 == 0, c, c.flip(0)) for c in omega))
    d = d.normalize()
    got = lights.light_pdf_at_hit(lt, p, d, t_p)
    with jax.disable_jit():
        want = jlights.light_pdf_at_hit(lt, JV3(*(jnp.asarray(c.numpy()) for c in p)),
                                        JV3(*(jnp.asarray(c.numpy()) for c in d)),
                                        jnp.asarray(t_p.numpy()))
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    assert (want[add.numpy() & (np.arange(256) % 2 == 0)] > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_mis_contribution_bounded():
    """The shadow-ray term never exceeds the light's emission (the property
    that removes unweighted NEE's near-light fireflies)."""
    emit = 7.0
    for world in (quad_light_world(emit), api.World(spheres=[api.Sphere(
            (0.0, 3.0, 0.0), 1.0, api.DiffuseLight((emit,) * 3))])):
        rng = np.random.default_rng(5)
        p = V3(*(torch.from_numpy(c) for c in _points(256, rng)))
        n = V3(torch.zeros(256), torch.ones(256), torch.zeros(256))
        us = [torch.from_numpy(rng.uniform(0, 1, 256).astype(np.float32)) for _ in range(3)]
        _, _, contrib, add = lights.sample_lights(lights.extract_lights(world), p, n, *us)
        assert add.any() and (contrib.x[add] <= emit * (1 + 1e-5)).all()


def test_shadow_sweep_is_the_jax_occlusion_test():
    """``closest_t`` from ``t_init = limit`` is below ``limit`` exactly
    where JAX's ``closest_hit`` (eager) finds a hit nearer than ``limit``:
    rays from the lit field's floor toward random points, gated and not."""
    world = lit_field()
    scene = compile_scene(world, spatial_sort=True)
    jw = jpresets.sphere_field(5)
    from myraytracer_tpu.scene.api import DiffuseLight as JLight
    from myraytracer_tpu.scene.api import Sphere as JSphere
    from myraytracer_tpu.scene.api import World as JWorld
    jworld = JWorld(list(jw.spheres) + [JSphere((0.0, 12.0, 0.0), 3.0, JLight((6.0,) * 3))],
                    camera=jw.camera, ambient=(0.0, 0.0, 0.0))
    jscene = jcompile(jworld, spatial_sort=True)
    rng = np.random.default_rng(6)
    n = 2048
    o = np.stack([rng.uniform(-5, 5, n), np.full(n, 0.001), rng.uniform(-5, 5, n)])
    tgt = np.stack([rng.uniform(-5, 5, n), rng.uniform(0.0, 14.0, n), rng.uniform(-5, 5, n)])
    d = tgt - o
    limit = np.linalg.norm(d, axis=0).astype(np.float32) * np.float32(0.999)
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    o = o.astype(np.float32)
    with jax.disable_jit():
        h = jclosest_hit(JV3(*map(jnp.asarray, o)), JV3(*map(jnp.asarray, d)), jscene, 1e-3, 1e4)
        want = np.asarray(h.mask & (h.t < jnp.asarray(limit)))
    assert want.any() and (~want).any()
    to, td = V3(*map(torch.from_numpy, o)), V3(*map(torch.from_numpy, d))
    lim = torch.from_numpy(limit)
    for cfg in (UNCULLED, KernelConfig(), KernelConfig(SUPER=2, SUPER_MIN=2)):
        t = closest_t(to, td, scene, 1e-3, 1e4, lim, ktrace.gate_tables(scene, cfg).gates)
        np.testing.assert_array_equal((t < lim).numpy(), want)


@pytest.mark.parametrize("name,cfg", [("lit-field", KernelConfig()), ("cornell", GATED_TRIS)],
                         ids=["lit-field", "cornell-gated-tris"])
def test_plain_gated_shadow_sweep_is_the_ungated_sweep(name, cfg):
    """NEE renders with the kernel's gates on the path and shadow rays are
    bitwise the ungated renders."""
    world = lit_field() if name == "lit-field" else presets.get_scene(name)
    scene = compile_scene(world, spatial_sort=True)
    w, h = 32, 24
    cam = torch.from_numpy(pack_camera(world.camera, w, h))
    lt = lights.extract_lights(world)
    gated = ktrace.gate_tables(scene, cfg)
    assert gated.gates.sph_cull or gated.gates.tri_cull
    args = (scene, cam, KEY, w, h, 0, h, 0, 2, 6, 1e-3, 1e4, world.ambient)
    img, segs = ktrace.trace_spheres_plain(*args, tables=gated, lights=lt)
    want, wsegs = ktrace.trace_spheres_plain(*args, tables=ktrace.gate_tables(scene, UNCULLED),
                                             lights=lt)
    assert img.sum() > 0
    assert torch.equal(img, want) and torch.equal(segs, wsegs)


@pytest.mark.parametrize("name,rr,frac", [("light", 0, 0.98), ("cornell", 3, 0.98)])
def test_plain_matches_jax_integrator(name, rr, frac):
    got, segs, want, jsegs = render_pair(name, 16, 8, 2, 8, nee=True, rr=rr)
    assert got.max() > 0.1
    assert_render_close(got, want, segs, jsegs, pixel_frac=frac)


@pytest.mark.parametrize("name,rr", [("light", 0), ("cornell", 3)])
def test_plain_matches_unfused_jax_integrator(name, rr):
    assert_eager_equal(*render_pair(name, 24, 16, 2, 8, eager=True, nee=True, rr=rr))


def test_emission_without_nee_matches_jax():
    """Emission alone (brute-force pickup): light at 24x16 agrees on every
    pixel bit for bit with equal segments (measured)."""
    got, segs, want, jsegs = render_pair("light", 24, 16, 2, 8)
    np.testing.assert_array_equal(got, want)
    assert segs == jsegs


def test_nee_noop_without_lights():
    world = presets.reference_scene()
    scene = compile_scene(world)
    base = integrator.make_renderer(world.camera, 16, 8, 2, 4)(scene, KEY, 0)
    nee = integrator.make_renderer(world.camera, 16, 8, 2, 4,
                                   nee_lights=lights.extract_lights(world))(scene, KEY, 0)
    assert torch.equal(base[0], nee[0]) and float(base[1]) == float(nee[1])


def test_nee_counts_shadow_rays_as_segments():
    """One shadow segment per Lambertian hit, usable sample or not: the
    difference is the number of Lambertian hits, whatever the pick."""
    world = presets.light_scene()
    scene = compile_scene(world)
    kw = dict(sky=world.ambient)
    _, s_brute = integrator.make_renderer(world.camera, 16, 8, 4, 1, **kw)(scene, KEY, 0)
    _, s_nee = integrator.make_renderer(
        world.camera, 16, 8, 4, 1, nee_lights=lights.extract_lights(world), **kw)(scene, KEY, 0)
    # Depth 1: every sample traces one segment, plus one at a diffuse hit.
    assert float(s_brute) == 16 * 8 * 4
    # The camera sees the gray floor and the blue sphere (both diffuse) in
    # most pixels; the lights, the metal sphere and the black sky in the rest.
    assert 16 * 8 * 4 < float(s_nee) < 2 * 16 * 8 * 4


def test_nee_inside_light_keeps_energy():
    """Inside a dome light NEE cannot sample it: the pure-BSDF estimator
    with full pickup, bitwise the render without NEE."""
    world = api.World(
        spheres=[
            api.Sphere((0.0, -1000.5, 0.0), 1000.0, api.Lambertian((0.6, 0.6, 0.6))),
            api.Sphere((0.0, 0.0, 0.0), 100.0, api.DiffuseLight((2.0, 2.0, 2.0))),
        ],
        camera=api.Camera(lookfrom=(0.0, 2.0, 4.0), lookat=(0.0, 0.0, 0.0),
                          vup=(0.0, 1.0, 0.0), vfov_degrees=40.0),
        ambient=(0.0, 0.0, 0.0),
    )
    scene = compile_scene(world)
    kw = dict(sky=world.ambient, sample_batch=2)
    a, _ = integrator.make_renderer(world.camera, 16, 8, 4, 6, **kw)(scene, KEY, 0)
    b, _ = integrator.make_renderer(world.camera, 16, 8, 4, 6,
                                    nee_lights=lights.extract_lights(world), **kw)(scene, KEY, 0)
    assert a.mean() > 0.5
    assert torch.equal(a, b)


def test_nee_sphere_light_matches_analytic_irradiance():
    """A Lambertian plane under a sphere light on its normal axis reflects
    ``albedo * L_e * r^2 / d^2``; depth 2 runs both MIS techniques, whose
    weights sum to one (JAX's closed-form test at a smaller budget:
    16x8, 128 spp, mean within 3%)."""
    albedo, emit, r, cy = 0.5, 10.0, 5.0, 50.0
    world = api.World(
        spheres=[
            api.Sphere((0.0, -1000.5, 0.0), 1000.0, api.Lambertian((albedo,) * 3)),
            api.Sphere((0.0, cy, 0.0), r, api.DiffuseLight((emit,) * 3)),
        ],
        camera=api.Camera(lookfrom=(0.0, 2.0, 0.0), lookat=(0.0, -0.5, 0.0),
                          vup=(0.0, 0.0, -1.0), vfov_degrees=2.0),
        ambient=(0.0, 0.0, 0.0),
    )
    render = integrator.make_renderer(world.camera, 16, 8, 128, 2, sample_batch=32,
                                      sky=world.ambient,
                                      nee_lights=lights.extract_lights(world))
    img, _ = render(compile_scene(world), KEY, 0)
    d = cy + 0.5
    np.testing.assert_allclose(float(img.mean()), albedo * emit * r * r / (d * d), rtol=0.03)


def test_nee_session_and_checkpoint_provenance(tmp_path):
    cfg = RenderConfig(width=16, height=8, samples_per_frame=2, ray_depth=4,
                       backend="torch", nee=True)
    s = RenderSession(presets.light_scene(), cfg)
    s.step()
    assert s.framebuffer.max() > 0
    path = tmp_path / "nee.npz"
    s.save_checkpoint(path)
    same = RenderSession(presets.light_scene(), cfg)
    same.load_checkpoint(path)
    assert torch.equal(same.step(), RenderSession(presets.light_scene(), cfg).run(2))
    other = RenderSession(presets.light_scene(), cfg.replace(nee=False))
    with pytest.raises(ValueError, match="nee"):
        other.load_checkpoint(path)


def test_adaptive_oracle_with_modes_is_the_uniform_render():
    """The adaptive plain version renders a block's pixels as the uniform
    plain version does, with NEE, RR and QMC on and the gated sweep."""
    world = presets.cornell_scene()
    scene = compile_scene(world, spatial_sort=True)
    w, h = 64, 32
    cam = torch.from_numpy(pack_camera(world.camera, w, h))
    tables = ktrace.gate_tables(scene, GATED_TRIS)
    modes = dict(lights=lights.extract_lights(world), rr=2, qmc=True)
    sums, segs = ktrace.trace_adaptive(scene, cam, KEY, w, h, torch.tensor([0, 1]),
                                       torch.tensor([4, 4]), 2, 1, 6, 1e-3, 1e4,
                                       world.ambient, tables=tables, **modes)
    img, isegs = ktrace.trace_spheres(scene, cam, KEY, w, h, 0, h, 4, 2, 6, 1e-3, 1e4,
                                      world.ambient, tables=tables, **modes)
    assert img.sum() > 0
    assert torch.equal(sums[0, 0], img) and not sums[0, 1].any()
    assert torch.equal(segs[0], isegs)


def test_adaptive_checkpoint_provenance(tmp_path):
    from myraytracer_tpu_torch.render.adaptive import AdaptiveSession

    cfg = RenderConfig(width=64, height=32, samples_per_frame=1, ray_depth=4,
                       backend="torch", nee=True, rr=2, qmc=True)
    s = AdaptiveSession(presets.light_scene(), cfg)
    s.step()
    assert s.framebuffer.max() > 0
    s.save_checkpoint(tmp_path / "a.npz")
    for kw in (dict(nee=False), dict(rr=0), dict(qmc=False)):
        with pytest.raises(ValueError):
            AdaptiveSession(presets.light_scene(), cfg.replace(**kw)).load_checkpoint(
                tmp_path / "a.npz")
    same = AdaptiveSession(presets.light_scene(), cfg)
    same.load_checkpoint(tmp_path / "a.npz")
    assert torch.equal(same.framebuffer, s.framebuffer)
