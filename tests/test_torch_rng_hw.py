"""The sample stream ``rng_mode="hw"`` of the PyTorch port.

The JAX kernels' ``rng_mode="hw"`` swaps threefry for the TPU's hardware
generator: a stream deterministic per key that is not threefry's, and that
JAX's CPU backend cannot run (``prng_seed`` has no CPU lowering). The port's
counterpart is Philox-4x32-10 keyed on the render key, counter (lane,
sample, b + 1, slot >> 1) (``core.rng.uniform4_hw``), in the plain version
here and in ``csrc/trace.cu`` built with ``MRT_RNG_HW`` on the card, where
``chip_smoke.py`` phase s holds the kernels to it bit for bit. On the CPU:

* Philox against Random123's known answers and a numpy ``uint64`` copy;
* the draws: uniform 24-bit floats, two slots a call, no two counters alike;
* the key: both words reach the stream, and the stream is not threefry's;
* against the JAX package by distribution, since no JAX hw image exists
  here: the frame mean and the 4x4 block means of the port's hw render
  within ``Z_BLOCK`` / ``Z_FRAME`` standard errors of the JAX jnp oracle's
  threefry render at the same shape and spp, the errors from the spread
  of ``N_SEEDS`` of the port's threefry renders (held to JAX elsewhere);
* the closed-form furnaces exactly, and the port's batching invariants
  bitwise, in hw mode;
* the wrappers: the mode's name, its build flag and its build's counts.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import numpy as np
import pytest
import torch

import jax

from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu.render import lights as jlights
from myraytracer_tpu.render.integrator import make_renderer as make_jnp
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu.scene.compile import compile_scene as jcompile
from myraytracer_tpu_torch.config import KernelConfig
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.kernels import build as kbuild
from myraytracer_tpu_torch.kernels import trace as ktrace
from myraytracer_tpu_torch.render import adaptive, integrator, lights
from myraytracer_tpu_torch.render.camera import pack_camera
from myraytracer_tpu_torch.render.session import wants_spatial_sort
from myraytracer_tpu_torch.scene import presets
from myraytracer_tpu_torch.scene.api import (
    Dielectric, DiffuseLight, Lambertian, Metal, Sphere, World,
)
from myraytracer_tpu_torch.scene.compile import compile_scene

from test_torch_furnace import ALBEDO, CAM, L, _assert_two_level

KEY = trng.key_from_seed(0)
M32 = 0xFFFFFFFF

# Random123's known-answer vectors for philox4x32_10: (key, counter, output).
KNOWN_ANSWERS = [
    ((0x00000000, 0x00000000), (0x00000000,) * 4,
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF,) * 4,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0xA4093822, 0x299F31D0), (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]

# The distribution check: N_SEEDS threefry renders give each pixel's
# variance; a block mean of the hw render lies within Z_BLOCK standard
# errors of the JAX render's (two independent estimates, so sqrt(2) of
# one), per channel, and the frame mean within Z_FRAME. Under a normal
# law a |z| past 5 has p = 5.7e-7 (96 block channels: 5.5e-5 for any), past
# 4 p = 6.3e-5.
N_SEEDS = 6
Z_BLOCK, Z_FRAME = 5.0, 4.0
DIST_W, DIST_H, DIST_SPP, DIST_DEPTH = 32, 16, 32, 8


def _philox_numpy(key, ctr, rounds=10):
    """Philox-4x32 on numpy uint64 arrays, the full 64-bit products (no
    16-bit split): an independent copy of ``trng.philox4x32``."""
    k0, k1 = (np.atleast_1d(np.asarray(k, np.uint64)) for k in key)
    c = [np.atleast_1d(np.asarray(x, np.uint64)) for x in ctr]
    m = np.uint64(M32)
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + np.uint64(0x9E3779B9)) & m, (k1 + np.uint64(0xBB67AE85)) & m
        p0 = c[0] * np.uint64(0xD2511F53)
        p1 = c[2] * np.uint64(0xCD9E8D57)
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & m, (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & m]
    return c


@pytest.mark.parametrize("key,ctr,want", KNOWN_ANSWERS, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(key, ctr, want):
    assert trng.philox4x32(key, ctr) == want
    got = trng.philox4x32(key, tuple(torch.tensor([c], dtype=torch.int64) for c in ctr))
    assert tuple(int(w) for w in got) == want
    assert tuple(int(w[0]) for w in _philox_numpy(key, ctr)) == want


def test_philox_matches_numpy_over_random_words():
    """Random keys and counters, the high words near 2^32 included, where an
    int64 product would overflow."""
    rng = np.random.default_rng(1234)
    n = 4096
    key = tuple(rng.integers(0, 1 << 32, n, dtype=np.uint64) for _ in range(2))
    ctr = [rng.integers(0, 1 << 32, n, dtype=np.uint64) for _ in range(4)]
    ctr[0][:16] = M32
    ctr[2][16:32] = M32
    got = trng.philox4x32(tuple(torch.from_numpy(k.astype(np.int64)) for k in key),
                          tuple(torch.from_numpy(c.astype(np.int64)) for c in ctr))
    want = _philox_numpy(key, ctr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def _slot(key, lane, sid, b, slot):
    """The two uniforms of draw slot ``slot``: words 2*(slot & 1) and
    2*(slot & 1) + 1 of the call of pair slot >> 1."""
    u = trng.uniform4_hw(key, lane, sid, b, slot >> 1)
    return u[2 * (slot & 1)], u[2 * (slot & 1) + 1]


def test_draws_are_uniform_24_bit_floats():
    """2^16 draws over 64 bins: the chi-square statistic below 103.44, its
    p = 0.001 point at 63 degrees of freedom; every draw a multiple of 2^-24
    in [0, 1)."""
    lane = torch.arange(1 << 12, dtype=torch.int64)
    draws = torch.cat([
        torch.cat(_slot(KEY, lane, torch.full_like(lane, s), b, slot))
        for s, b, slot in ((0, -1, 0), (7, 0, 1), (7, 3, 2), (123456, 40, 3),
                           (9, 100, 0), (M32, 1, 3), (2, 2, 1), (5, 0, 2))
    ])
    assert draws.numel() == 1 << 16
    assert bool((draws >= 0).all()) and bool((draws < 1).all())
    scaled = draws.double() * (1 << 24)
    assert torch.equal(scaled, scaled.round())
    counts = torch.histc(draws, bins=64, min=0.0, max=1.0)
    expected = draws.numel() / 64
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 103.44


def test_slots_share_one_call_and_counters_do_not():
    """Slots 2k and 2k + 1 of a bounce are the two halves of one Philox
    call; the camera is bounce -1 (counter word 0); no two counters of a
    grid of lanes, samples, bounces and pairs give the same words."""
    lane = torch.arange(64, dtype=torch.int64)
    sid = torch.full_like(lane, 5)
    for b in (-1, 0, 61, 62, 63, 200):
        for pair in (0, 1):
            w = trng.philox4x32(KEY, (lane, sid, b + 1, pair))
            u = [trng._to_unit_f32(x) for x in w]
            assert torch.equal(torch.stack(trng.uniform4_hw(KEY, lane, sid, b, pair)),
                               torch.stack(u))
    grid = torch.cartesian_prod(torch.arange(16), torch.arange(8), torch.arange(-1, 7),
                                torch.arange(2))
    w = trng.philox4x32(KEY, (grid[:, 0], grid[:, 1], grid[:, 2] + 1, grid[:, 3]))
    words = torch.stack(w, dim=1)
    assert torch.unique(words, dim=0).shape[0] == grid.shape[0]


def _render(name, key, w, h, spp, depth, rng_mode="threefry", nee=False, rr=0, world=None):
    world = world or presets.get_scene(name)
    r = integrator.make_renderer(world.camera, w, h, spp, depth, sky=world.ambient,
                                 sample_batch=spp, rr=rr, rng_mode=rng_mode,
                                 nee_lights=lights.extract_lights(world) if nee else None)
    img, segs = r(compile_scene(world, spatial_sort=wants_spatial_sort(world)), key, 0)
    return img.numpy(), float(segs)


def test_both_key_words_reach_the_stream():
    """Equal keys give equal images; keys (0, 1) and (0, 2) differ, and so do
    (1, 0) and (2, 0): ``key_from_seed`` puts every seed below 2^32 in the
    second word, so a stream that read only one word would give every user
    seed the same image (the JAX kernel's comment, trace.py:716-719)."""
    args = ("three-sphere", 16, 8, 2, 4)
    imgs = {k: _render(args[0], k, *args[1:], rng_mode="hw")[0]
            for k in ((0, 1), (0, 2), (1, 0), (2, 0))}
    np.testing.assert_array_equal(_render(args[0], (0, 1), *args[1:], rng_mode="hw")[0],
                                  imgs[(0, 1)])
    assert not np.array_equal(imgs[(0, 1)], imgs[(0, 2)])
    assert not np.array_equal(imgs[(1, 0)], imgs[(2, 0)])
    assert trng.key_from_seed(7) == (0, 7)
    threefry = _render(args[0], (0, 1), *args[1:])[0]
    assert not np.array_equal(imgs[(0, 1)], threefry)


def _jax_render(name, w, h, spp, depth, nee=False, rr=0):
    jworld = jpresets.get_scene(name)
    sort = len(jworld.spheres) > 64 or jworld.triangle_count > 64
    jr = make_jnp(jworld.camera, w, h, spp, depth, sample_batch=spp, sky=jworld.ambient,
                  nee_lights=jlights.extract_lights(jworld) if nee else None, rr=rr)
    img, _ = jr(jcompile(jworld, spatial_sort=sort), jrng.key_from_seed(0), 0)
    return np.asarray(jax.device_get(img))


@pytest.mark.parametrize("name,nee,rr", [("three-sphere", False, 0), ("cornell", True, 3)],
                         ids=["three-sphere", "cornell-nee-rr3"])
def test_hw_render_agrees_with_jax_by_distribution(name, nee, rr):
    """The port's hw image against the JAX jnp oracle's threefry image at
    32x16, 32 spp, depth 8: block and frame means within the stated z."""
    args = (DIST_W, DIST_H, DIST_SPP, DIST_DEPTH)
    seeds = np.stack([_render(name, trng.key_from_seed(s), *args, nee=nee, rr=rr)[0]
                      for s in range(1, N_SEEDS + 1)])
    var = seeds.astype(np.float64).var(axis=0, ddof=1)  # a pixel's, at DIST_SPP
    hw = _render(name, KEY, *args, rng_mode="hw", nee=nee, rr=rr)[0].astype(np.float64)
    want = _jax_render(name, *args, nee=nee, rr=rr).astype(np.float64)
    assert hw.shape == want.shape == (DIST_H, DIST_W, 3)

    def blocks(a):  # 4x4 means: [H/4, W/4, ...]
        return a.reshape(DIST_H // 4, 4, DIST_W // 4, 4, -1).mean(axis=(1, 3))

    se_block = np.sqrt(2.0 * blocks(var) / 16.0)
    z_block = (blocks(hw) - blocks(want)) / np.maximum(se_block, 1e-12)
    z_frame = (hw.mean(axis=(0, 1)) - want.mean(axis=(0, 1))) / np.sqrt(
        2.0 * var.mean(axis=(0, 1)) / (DIST_H * DIST_W))
    assert np.abs(z_block).max() < Z_BLOCK, np.abs(z_block).max()
    assert np.abs(z_frame).max() < Z_FRAME, z_frame
    assert not np.array_equal(hw, want)


def _furnace(material, rng_mode="hw", spp=4, depth=8, hidden_light=False, **kw):
    spheres = [Sphere((0.0, 0.0, 0.0), 1.0, material)]
    if hidden_light:
        spheres.append(Sphere((0.0, 0.0, 0.0), 0.1, DiffuseLight((0.0, 0.0, 0.0))))
    world = World(spheres=spheres, camera=CAM, ambient=L)
    nee = lights.extract_lights(world) if kw.pop("nee", False) else None
    r = ktrace.make_renderer(world.camera, 32, 24, spp, depth, sky=L, nee_lights=nee,
                             rng_mode=rng_mode, **kw)
    img, segs = r(compile_scene(world), KEY, 0)
    return img.numpy(), float(segs)


@pytest.mark.parametrize("mode", [{}, dict(qmc=True), dict(nee=True)],
                         ids=["default", "qmc", "nee"])
def test_furnace_lambertian_exact_in_hw_mode(mode):
    """Exactly albedo * L a hit. Only the camera's draws reach a furnace's
    image: in hw mode they are Philox's, unlike threefry's, but under QMC
    the camera pairs stay Sobol and the image is threefry's bit for bit."""
    img, _ = _furnace(Lambertian(ALBEDO), hidden_light="nee" in mode, **mode)
    _assert_two_level(img, np.asarray(ALBEDO) * np.asarray(L), spp=4)
    threefry, _ = _furnace(Lambertian(ALBEDO), rng_mode="threefry",
                           hidden_light="nee" in mode, **mode)
    assert np.array_equal(img, threefry) == ("qmc" in mode)


def test_furnace_metal_and_dielectric_in_hw_mode():
    m = (0.9, 0.8, 0.6)
    img, _ = _furnace(Metal(m, fuzz=0.0))
    _assert_two_level(img, np.asarray(m) * np.asarray(L), spp=4)
    ratio = _furnace(Dielectric(1.5), spp=16, depth=32)[0] / np.asarray(L, np.float32)
    assert ratio.max() < 1.0 + 1e-4 and ratio.min() > 0.98 and 1.0 - ratio.mean() < 0.005


@pytest.mark.parametrize("depth", [6, 70])
def test_enclosure_in_hw_mode_is_black_with_exact_segments(depth):
    """The absolute bounce in the counter: no draw page, and depth 70 holds."""
    w, h, spp = 16, 12, 2
    world = World(spheres=[Sphere((0.0, 0.0, 4.0), -10.0, Lambertian((0.9, 0.9, 0.9)))],
                  camera=CAM, ambient=L)
    r = ktrace.make_renderer(world.camera, w, h, spp, depth, sky=L, rng_mode="hw")
    img, segs = r(compile_scene(world), KEY, 0)
    np.testing.assert_array_equal(img.numpy(), np.zeros((h, w, 3), np.float32))
    assert float(segs) == w * h * spp * depth


@pytest.fixture(scope="module")
def cornell():
    world = presets.get_scene("cornell")
    return world, compile_scene(world, spatial_sort=wants_spatial_sort(world))


def _block(world, w, h, spp, depth, frames=1, rr=3):
    return integrator.make_block_renderer(
        world.camera, w, h, h, spp, depth, sample_batch=spp, sky=world.ambient,
        nee_lights=lights.extract_lights(world), rr=rr, frames=frames, rng_mode="hw")


def test_hw_frames_in_one_call_are_one_frame_calls(cornell):
    """K = 4 frames in one call are the four one-frame calls, and the same
    frames split over two calls at a sample (two frames each) are too."""
    world, scene = cornell
    w, h, spp, depth = 16, 8, 2, 70
    four, segs = _block(world, w, h, spp, depth, frames=4)(scene, KEY, 0, 5, 4 * spp)
    one = _block(world, w, h, spp, depth)
    total = torch.zeros_like(segs)
    for f in range(4):
        img, sg = one(scene, KEY, 0, 5 + f * spp, spp)
        assert torch.equal(four[f], img.permute(2, 0, 1))
        total += sg
    assert torch.equal(segs, total)
    two = _block(world, w, h, spp, depth, frames=2)
    first, _ = two(scene, KEY, 0, 5, 2 * spp)
    second, _ = two(scene, KEY, 0, 5 + 2 * spp, 2 * spp)
    assert torch.equal(torch.cat([first, second]), four)


def test_hw_adaptive_blocks_are_the_uniform_sums(cornell):
    """Every block of a 2x1 grid (the second past the image's edge) at its
    own cursor, the sentinel included: the uniform render's sums."""
    world, scene = cornell
    w, h, spp, depth = 96, 24, 2, 8
    ids = torch.tensor([0, 1, 2])  # 2 is the sentinel
    samp0 = torch.tensor([3, 3, 0])
    sums, segs = adaptive.adaptive_block_sums(
        scene, world.camera, KEY, w, h, ids, samp0, spp, 2, depth, sky=world.ambient,
        nee_lights=lights.extract_lights(world), rr=3, rng_mode="hw")
    img, usegs = _block(world, w, h, spp, depth, frames=2)(scene, KEY, 0, 3, 2 * spp)
    for f in range(2):
        grid = torch.cat([sums[f, 0], sums[f, 1]], dim=1)[:h, :w]
        assert torch.equal(grid, img[f].permute(1, 2, 0))
    assert not sums[:, 2].any() and not segs[2].any()
    assert torch.equal(torch.cat([segs[0], segs[1]], dim=1)[:h, :w], usegs)


def test_hw_kernel_wrappers_on_cpu_are_the_plain_version(cornell):
    world, scene = cornell
    w, h = 16, 8
    lt = lights.extract_lights(world)
    cam = torch.from_numpy(pack_camera(world.camera, w, h))
    args = (scene, cam, KEY, w, h, 0, h, 2, 2, 70, 1e-3, 1e4, world.ambient)
    got = ktrace.trace_spheres(*args, lights=lt, rr=3, rng_mode="hw")
    want = ktrace.trace_spheres_plain(*args, lights=lt, rr=3, rng_mode="hw")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got[0], ktrace.trace_spheres(*args, lights=lt, rr=3)[0])
    ids, samp0 = torch.tensor([0, 1]), torch.tensor([4, 0])
    aargs = (scene, cam, KEY, w, h, ids, samp0, 2, 1, 8, 1e-3, 1e4, world.ambient)
    got = ktrace.trace_adaptive(*aargs, lights=lt, rng_mode="hw")
    want = ktrace.trace_adaptive_plain(*aargs, lights=lt, rng_mode="hw")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    r = ktrace.make_adaptive_renderer(world.camera, w, h, 2, 2, 8, sky=world.ambient,
                                      nee_lights=lt, rng_mode="hw")
    sums, _ = r(scene, KEY, ids, samp0)
    assert torch.equal(sums, want[0][0])


@pytest.mark.parametrize("factory", [
    lambda m: ktrace.make_block_renderer(CAM, 8, 4, 4, 1, 2, rng_mode=m),
    lambda m: ktrace.make_renderer(CAM, 8, 4, 1, 2, rng_mode=m),
    lambda m: ktrace.make_adaptive_renderer(CAM, 8, 4, 1, 1, 2, rng_mode=m),
    lambda m: integrator.make_block_renderer(CAM, 8, 4, 4, 1, 2, rng_mode=m),
    lambda m: adaptive.make_adaptive_oracle(CAM, 8, 4, 1, 1, 2, rng_mode=m),
    lambda m: ktrace.kernel_flags(None, m),
    lambda m: ktrace.kernels_for(None, m),
], ids=["block", "renderer", "adaptive", "plain-block", "plain-adaptive", "flags", "kernels"])
def test_unknown_rng_mode_raises(factory):
    for mode in ("threefry", "hw"):
        factory(mode)
    with pytest.raises(ValueError, match="'threefry' or 'hw'"):
        factory("bogus")


def test_hw_build_flag_and_its_own_counts(monkeypatch):
    assert ktrace.kernel_flags() == kbuild.NVCC_FLAGS
    assert ktrace.kernel_flags(rng_mode="hw") == kbuild.NVCC_FLAGS + ("-DMRT_RNG_HW=1",)
    with pytest.raises(ValueError, match="ABLATE"):
        ktrace.kernel_flags(KernelConfig(ABLATE=("rng",)), "hw")
    cfg = KernelConfig(TILE_W=8)
    flags = ktrace.kernel_flags(cfg, "hw")
    assert flags[-1] == "-DMRT_RNG_HW=1" and flags[:-1] == ktrace.kernel_flags(cfg)
    assert ktrace.kernels_for(None, "threefry") == (ktrace.KERNEL, ktrace.ADAPTIVE)
    hw = ktrace.kernels_for(None, "hw")
    assert hw is ktrace.kernels_for(KernelConfig(), "hw")
    assert hw[0] is not ktrace.KERNEL and hw[0].flags == ktrace.kernel_flags(rng_mode="hw")
    jobs = []
    monkeypatch.setattr(ktrace.kbuild, "build_many", lambda j: jobs.extend(j) or [])
    ktrace.build_variants([None, (None, "hw"), (cfg, "hw"), cfg])
    assert [f for _, f in jobs] == [kbuild.NVCC_FLAGS, ktrace.kernel_flags(rng_mode="hw"),
                                   flags, ktrace.kernel_flags(cfg)]


def test_hw_code_is_behind_its_build_option():
    """Every line of the Philox stream in ``csrc/trace.cu`` sits under
    ``#if MRT_RNG_HW``, so the default build's text is the threefry one."""
    depth, hw_depth = 0, []
    for line in ktrace.SOURCE.read_text().splitlines():
        s = line.strip()
        if s.startswith("//"):
            continue
        if s.startswith("#if"):
            depth += 1
            hw_depth.append(depth if s == "#if MRT_RNG_HW" else None)
        elif s.startswith("#else") and hw_depth and hw_depth[-1] == depth:
            hw_depth[-1] = -depth  # the threefry side
        elif s.startswith("#endif"):
            depth -= 1
            hw_depth.pop()
        elif "philox" in s or "_hw(" in s or "ps.sid" in s:
            assert any(d is not None and d > 0 for d in hw_depth), line
