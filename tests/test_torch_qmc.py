"""QMC camera sampling (Owen-scrambled Sobol) in the PyTorch port.

The u32 functions are bitwise the JAX package's, run eagerly
(``jax.disable_jit()``) on the same numpy-seeded inputs: bit reversal, the
second Sobol dimension, the XOR-scrambled (0,2) pair, the Laine-Karras
permutation, the Owen scramble and the camera pairs. Renders under
``--qmc`` are held to the JAX jnp integrator: jitted, under the
statistical bar of ``test_torch_trace.assert_render_close`` with the
final scene's measured pixel bar of 0.96 (0.969 of pixels within rtol
1e-4, atol 1e-5 at 16x8, segments 689 = 689; defocus at 24x16 1.0), and
eagerly with every pixel within that tolerance and equal segments
(final 24x16: 0.977 bit for bit, 2024 = 2024).
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.render import integrator
from myraytracer_tpu_torch.render.session import RenderSession
from myraytracer_tpu_torch.scene import presets
from myraytracer_tpu_torch.scene.api import World
from myraytracer_tpu_torch.scene.compile import compile_scene

from test_torch_nee import assert_eager_equal, render_pair
from test_torch_trace import assert_render_close

KEY = trng.key_from_seed(0)
RNG = np.random.default_rng(11)
WORDS = RNG.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
SEEDS = RNG.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eager(fn, *args):
    with jax.disable_jit():
        out = fn(*(jnp.asarray(a) for a in args))
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("fn", ["_reverse_bits32", "_sobol2_bits"])
def test_bit_functions_bitwise(fn):
    x = np.concatenate([WORDS, EDGES])
    (want,) = _eager(getattr(jrng, fn), x)
    got = getattr(trng, fn)(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("fn", ["_laine_karras", "owen_scramble"])
def test_scrambles_bitwise(fn):
    (want,) = _eager(getattr(jrng, fn), WORDS, SEEDS)
    got = getattr(trng, fn)(_t(WORDS), _t(SEEDS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_sobol02_bitwise():
    n = np.arange(4096, dtype=np.uint32)
    want = _eager(jrng.sobol02, n, WORDS, SEEDS)
    got = trng.sobol02(_t(n), _t(WORDS), _t(SEEDS))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pair", [0, 1])
@pytest.mark.parametrize("seed", [0, 0xDEADBEEF_00C0FFEE])
def test_qmc_camera_uniforms_bitwise(pair, seed):
    lane = RNG.integers(0, 1 << 22, 2048).astype(np.uint32)
    sample = np.concatenate([np.arange(1024, dtype=np.uint32),
                             RNG.integers(0, 1 << 24, 1024).astype(np.uint32)])
    jkey = jrng.key_from_seed(seed)
    with jax.disable_jit():
        want = jrng.qmc_camera_uniforms(jkey, jnp.asarray(lane), jnp.asarray(sample), pair)
    got = trng.qmc_camera_uniforms(trng.key_from_seed(seed), _t(lane), _t(sample), pair)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sobol_directions_and_first_points():
    assert trng._SOBOL2_DIRS == jrng._SOBOL2_DIRS and trng.QMC_BITS == jrng.QMC_BITS
    x, _ = trng.sobol02(torch.arange(8), 0, 0)
    np.testing.assert_allclose(x.numpy(), [0.0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875])


@pytest.mark.parametrize("scramble", [(0, 0), (0x9E3779B9, 0xDEADBEEF)])
def test_sobol02_net_stratification(scramble):
    """Any 16-point prefix covers each cell of the 4x4, 2x8, 8x2, 16x1 and
    1x16 grids once, XOR-scrambled or not."""
    x, y = trng.sobol02(torch.arange(16), *scramble)
    x, y = x.numpy(), y.numpy()
    for gx, gy in ((4, 4), (2, 8), (8, 2), (16, 1), (1, 16)):
        assert len(set(zip((x * gx).astype(int), (y * gy).astype(int)))) == 16


def test_owen_scramble_is_nested_uniform():
    """Points sharing a leading-bit prefix keep sharing one after the
    scramble, and distinct prefixes stay distinct."""
    x = torch.arange(1 << 12, dtype=torch.int64) << 20
    y = trng.owen_scramble(x, 0xC0FFEE01)
    for bits in (1, 2, 4, 8):
        groups = {}
        for xi, yi in zip((x >> (32 - bits)).tolist(), (y >> (32 - bits)).tolist()):
            groups.setdefault(xi, set()).add(yi)
        assert all(len(v) == 1 for v in groups.values())
        assert len({next(iter(v)) for v in groups.values()}) == len(groups)


@pytest.mark.parametrize("name,w,h,frac", [("final", 16, 8, 0.96), ("defocus", 24, 16, 0.98)])
def test_plain_matches_jax_integrator(name, w, h, frac):
    got, segs, want, jsegs = render_pair(name, w, h, 2, 8, qmc=True)
    assert_render_close(got, want, segs, jsegs, pixel_frac=frac)


def test_plain_matches_unfused_jax_integrator():
    assert_eager_equal(*render_pair("final", 24, 16, 2, 8, eager=True, qmc=True))


def test_qmc_converges_faster_on_smooth_integrand():
    """Sky only: the pixel integrand is smooth in the jitter, where the
    (0,2) net's error at 16 spp is well under half the threefry stream's
    against a 1024-spp reference."""
    world = World(spheres=[])
    scene = compile_scene(world)
    ref, _ = integrator.make_renderer(world.camera, 8, 4, 1024, 1,
                                      sample_batch=256)(scene, KEY, 0)

    def rmse(**kw):
        img, _ = integrator.make_renderer(world.camera, 8, 4, 16, 1, sample_batch=16,
                                          **kw)(scene, KEY, 0)
        return float(((img - ref) ** 2).mean().sqrt())

    assert rmse(qmc=True) < 0.5 * rmse()


def test_session_qmc_and_checkpoint_provenance(tmp_path):
    cfg = RenderConfig(width=16, height=8, samples_per_frame=2, ray_depth=4,
                       backend="torch", qmc=True)
    world = presets.reference_scene()
    s = RenderSession(world, cfg)
    s.step()
    path = tmp_path / "q.npz"
    s.save_checkpoint(path)
    s2 = RenderSession(world, cfg)
    s2.load_checkpoint(path)
    assert torch.equal(s.framebuffer, s2.framebuffer)
    base = RenderSession(world, cfg.replace(qmc=False))
    assert not torch.equal(base.step(), s.framebuffer)
    with pytest.raises(ValueError, match="qmc"):
        RenderSession(world, cfg.replace(qmc=False)).load_checkpoint(path)
