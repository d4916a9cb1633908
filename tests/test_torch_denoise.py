"""The output denoiser of the PyTorch port against the JAX package's.

On the CPU, the same inputs (made from a numpy seed, or a compiled JAX scene
carried across with ``scene_from_numpy``) go through
``myraytracer_tpu.render.denoise`` and ``myraytracer_tpu_torch.render.denoise``:

* the schedules (``auto_iterations``, ``noise_iterations``) and the noise
  estimate (``estimate_noise``, numpy in both): equal;
* the feature pass (``aux_buffers``) on two small scenes, one textured,
  against JAX run op by op (``jax.disable_jit()``; jitted it gives the same
  bits here): albedo bit for bit; normal and depth differ on a few pixels
  whose root cancels (measured at 48x32: 6 and 14 of 1536 pixels, by
  1.2e-7 in a normal's component and by 3.8e-6 of t in depth), held to
  atol 1.2e-7 and rtol 2e-5 on at most 2% of the pixels;
* the filter (``atrous_denoise``): with ``jax.disable_jit()`` JAX rounds
  every product and sum on its own as torch does, but XLA's and torch's CPU
  ``exp`` disagree by an ulp on some arguments, and the next iterations'
  weights carry that on: measured on 24x16, 76-96% of the values are bit
  for bit and the largest relative difference is 1.1e-5 (at 3 and 5
  iterations); jitted, where XLA also contracts multiply-adds, 8.5e-6. Both
  are held to rtol 5e-5;
* the ``Denoiser``: the feature cache keyed on the packed camera's values,
  the auto mode's noise-driven count, a constant image as a fixed point.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.render import camera as jcam
from myraytracer_tpu.render import denoise as jdn
from myraytracer_tpu.scene import api as japi
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu.scene.compile import compile_scene as jcompile
from myraytracer_tpu_torch.render import camera as tcam
from myraytracer_tpu_torch.render import denoise as tdn
from myraytracer_tpu_torch.render.camera import pack_camera
from myraytracer_tpu_torch.scene import api as tapi
from myraytracer_tpu_torch.scene import presets as tpresets
from myraytracer_tpu_torch.scene.compile import SCENE_LEAVES, leaf, scene_from_numpy

from textured_worlds import WORLDS


def test_constants_are_jax():
    for name in ("ALBEDO_EPS", "_B3", "_LUM", "_G3", "DEFAULT_ITERATIONS", "DEFAULT_SIGMA_COLOR",
                 "DEFAULT_SIGMA_NORMAL", "DEFAULT_SIGMA_DEPTH", "AUTO_CROSSOVER_SPP",
                 "NOISE_ITERS_REF"):
        assert getattr(tdn, name) == getattr(jdn, name), name


@pytest.mark.parametrize("spp", [0, 1, 2, 3, 4, 8, 16, 31, 32, 63, 64, 500])
def test_auto_iterations_equal_jax(spp):
    assert tdn.auto_iterations(spp) == jdn.auto_iterations(spp)


@pytest.mark.parametrize("noise", [float("nan"), 0.0, 0.003, 0.0036, 0.005, 0.0071, 0.02, 0.1,
                                   1.0])
def test_noise_iterations_equal_jax(noise):
    assert tdn.noise_iterations(noise) == jdn.noise_iterations(noise)


def _framebuffer(seed, h=16, w=24, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.rand(h, w, 3) * scale).astype(np.float32)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 3.0), (2, 0.01)])
def test_estimate_noise_equals_jax(seed, scale):
    fb = _framebuffer(seed, 32, 48, scale)
    want = jdn.estimate_noise(fb)
    assert tdn.estimate_noise(fb) == want
    assert tdn.estimate_noise(torch.from_numpy(fb)) == want


def _worlds(name):
    if name in WORLDS:
        return WORLDS[name](tapi, tpresets), WORLDS[name](japi, jpresets)
    return tpresets.get_scene(name), jpresets.get_scene(name)


@pytest.mark.parametrize("name", ["three-sphere", "texture"])
def test_aux_buffers_are_jax(name):
    """The compiled JAX scene goes through both feature passes."""
    w, h = 48, 32
    world, jworld = _worlds(name)
    jscene = jcompile(jworld)
    arrays = {n: np.asarray(leaf(jscene, n)) for n in SCENE_LEAVES
              if leaf(jscene, n) is not None}
    scene = scene_from_numpy(arrays)
    with jax.disable_jit():  # op by op: no multiply-add is contracted
        want = jdn.aux_buffers(jscene, jcam.make_ray_generator(jworld.camera, w, h), w, h,
                               1e-3, 1e4)
    got = tdn.aux_buffers(scene, tcam.make_ray_generator(world.camera, w, h), w, h, 1e-3, 1e4)
    depth = np.asarray(want[2])
    assert (depth < 1e4).any() and (depth >= 1e4).any()  # hits and sky
    for g, wnt in zip(got, want):
        assert tuple(g.shape) == wnt.shape
    albedo, normal, t = (g.numpy() for g in got)
    np.testing.assert_array_equal(albedo, np.asarray(want[0]))
    np.testing.assert_allclose(normal, np.asarray(want[1]), rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(t, depth, rtol=2e-5, atol=0)
    differ = (normal != np.asarray(want[1])).any(-1) | (t != depth)
    assert differ.mean() <= 0.02
    if name == "texture":  # a checkered surface: more than one albedo on the hits
        assert len(np.unique(np.round(got[0].numpy()[depth < 1e4], 4), axis=0)) >= 2


def test_aux_buffers_in_ray_chunks_and_behind_gates(monkeypatch):
    """Chunked rays and the gated sweep give the ungated one-pass features."""
    from myraytracer_tpu_torch.kernels.trace import gate_tables
    from myraytracer_tpu_torch.render.session import wants_spatial_sort
    from myraytracer_tpu_torch.scene.compile import compile_scene

    w, h = 64, 32
    world = WORLDS["textured-field"](tapi, tpresets)  # 104 sphere slots: gated
    scene = compile_scene(world, spatial_sort=wants_spatial_sort(world))
    gen = tcam.make_ray_generator(world.camera, w, h)
    want = tdn.aux_buffers(scene, gen, w, h, 1e-3, 1e4)
    gates = gate_tables(scene).gates
    assert gates.sph_cull
    monkeypatch.setattr(tdn, "_FEATURE_BUDGET", 64 * 1024)  # 1024 rays a pass
    got = tdn.aux_buffers(scene, gen, w, h, 1e-3, 1e4, gates=gates)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), wnt.numpy())


def _filter_inputs(seed, h=16, w=24):
    rng = np.random.RandomState(seed)
    fb = (rng.rand(h, w, 3) * 2.0).astype(np.float32)
    albedo = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[:, : w // 2] = normal[0, 0]  # a flat half: weights near one
    depth = rng.uniform(1.0, 20.0, (h, w)).astype(np.float32)
    depth[: h // 2] = 5.0
    depth[0, :4] = 1e4  # sky
    return fb, albedo, normal, depth


@pytest.mark.parametrize("seed,iters", [(0, 1), (1, 3)])
def test_filter_against_eager_jax(seed, iters):
    args = _filter_inputs(seed)
    with jax.disable_jit():
        want = np.asarray(jdn.atrous_denoise(*(jnp.asarray(a) for a in args), iters))
    got = tdn.atrous_denoise(*(torch.from_numpy(a) for a in args), iters).numpy()
    assert np.isfinite(got).all() and not np.array_equal(got, args[0])
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=0)
    assert (got == want).mean() >= 0.7


@pytest.mark.parametrize("seed,iters", [(0, 2), (1, 5)])
def test_filter_against_jitted_jax(seed, iters):
    args = _filter_inputs(seed)
    want = np.asarray(jdn.atrous_denoise(*(jnp.asarray(a) for a in args), iters))
    got = tdn.atrous_denoise(*(torch.from_numpy(a) for a in args), iters).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=0)


def test_constant_image_is_a_fixed_point():
    h, w = 16, 24
    fb = torch.full((h, w, 3), 0.4)
    albedo = torch.full((h, w, 3), 0.8)
    normal = torch.zeros((h, w, 3))
    normal[..., 2] = 1.0
    depth = torch.full((h, w), 3.0)
    out = tdn.atrous_denoise(fb, albedo, normal, depth, 4)
    np.testing.assert_allclose(out.numpy(), fb.numpy(), rtol=1e-6)


def test_shift_replicates_the_edge():
    a = torch.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(
        tdn._shift(a, 1, -2).numpy(),
        np.asarray(jdn._shift(jnp.asarray(a.numpy()), 1, -2)))
    np.testing.assert_array_equal(
        tdn._shift(a, -5, 3).numpy(),
        np.asarray(jdn._shift(jnp.asarray(a.numpy()), -5, 3)))


def test_feature_cache_keys_on_camera_values():
    world = tpresets.three_sphere_scene()
    w, h = 32, 16
    world = dataclasses.replace(world, camera=tapi.Camera(
        lookfrom=(3.0, 2.0, 6.0), lookat=(0.0, 0.0, -1.0), vfov_degrees=40.0))
    dn = tdn.Denoiser(world, w, h, iterations=1, device="cpu")
    cam0 = torch.from_numpy(pack_camera(world.camera, w, h))
    first = dn.features(cam0)
    assert dn.features(cam0.clone()) is first  # equal values, another tensor: a hit
    moved = tapi.Camera(lookfrom=(-3.0, 1.0, 5.0), lookat=(0.0, 0.0, -1.0), vfov_degrees=40.0)
    cam1 = torch.from_numpy(pack_camera(moved, w, h))
    second = dn.features(cam1)
    assert second is not first and not torch.equal(second[2], first[2])
    assert dn.features(cam1.clone()) is second
    fb = torch.from_numpy(_framebuffer(3, h, w))
    assert dn(fb, cam1).shape == (h, w, 3)


def test_denoiser_auto_mode_is_noise_driven():
    world = tpresets.three_sphere_scene()
    w, h = 48, 32
    dn = tdn.Denoiser(world, w, h, auto=True, device="cpu")
    jd = jdn.Denoiser(jpresets.three_sphere_scene(), w, h, auto=True)
    assert dn.effective_iterations(4) == jd.effective_iterations(4) == 4  # the spp fallback
    noisy = _framebuffer(0, h, w)
    out = dn(noisy, spp=1)
    assert dn.last_noise == jdn.estimate_noise(noisy)
    assert dn.effective_iterations() == jdn.noise_iterations(dn.last_noise) > 0
    assert not np.array_equal(out.numpy(), noisy)
    clean = np.full((h, w, 3), 0.5, np.float32)
    assert np.array_equal(dn(clean, spp=1000).numpy(), clean)  # raw once clean
    assert dn.effective_iterations() == 0
    # The estimate is reused until the accumulation has grown by a quarter.
    dn(noisy, spp=8)
    dn(clean, spp=9)
    assert dn.effective_iterations() > 0
    dn(clean, spp=10)
    assert dn.effective_iterations() == 0
    with pytest.raises(ValueError):
        tdn.Denoiser(world, w, h, iterations=0, device="cpu")
