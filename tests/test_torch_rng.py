"""The PyTorch port's counter-based RNG against the JAX package: bitwise.

Every draw of the renderer is ``threefry2x32(key, (lane, draw))``; the port
carries u32 words in int64 tensors, and must give the JAX package's bits
for every key and counter.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.core import noise as jnoise
from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu_torch.core import noise as tnoise
from myraytracer_tpu_torch.core import rng as trng

N = 100_000


def _u32(n, seed):
    return np.random.RandomState(seed).randint(0, 2**32, size=n, dtype=np.uint64).astype(
        np.uint32
    )


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(a):
    return np.asarray(a).astype(np.uint32)


# Random123 kat_vectors, threefry2x32 20 rounds: (key, ctr) -> out
# (the same vectors tests/test_rng.py checks the JAX package with).
KAT = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]


@pytest.mark.parametrize("key,ctr,want", KAT)
def test_threefry_known_answer_vectors(key, ctr, want):
    assert trng.threefry2x32(key, ctr) == want  # Python ints
    got = trng.threefry2x32(key, (_t([ctr[0]]), _t([ctr[1]])))  # tensors
    assert (int(got[0][0]), int(got[1][0])) == want


def test_threefry_bitwise_random_counters_and_keys():
    c0, c1, k0, k1 = (_u32(N, s) for s in range(4))
    want = jrng.threefry2x32((jnp.asarray(k0), jnp.asarray(k1)),
                             (jnp.asarray(c0), jnp.asarray(c1)))
    got = trng.threefry2x32((_t(k0), _t(k1)), (_t(c0), _t(c1)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 7, 2**32 + 5, 0xDEADBEEFCAFEF00D])
def test_key_from_seed_and_fold_key(seed):
    jk = jrng.key_from_seed(seed)
    tk = trng.key_from_seed(seed)
    assert tk == (int(jk[0]), int(jk[1]))
    for data in (0, 1, jrng.RR_KEY_FOLD, 0xFFFFFFFF):
        jf = jrng.fold_key(jk, data)
        assert trng.fold_key(tk, data) == (int(jf[0]), int(jf[1]))


def test_depth_page_key_bitwise():
    key = trng.key_from_seed(3)
    pages = _u32(N, 11)
    pages[:100] = 0  # page 0 is the main key itself
    want = jrng.depth_page_key(jrng.key_from_seed(3), jnp.asarray(pages))
    got = trng.depth_page_key(key, _t(pages))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    for page in (0, 1, 5):  # Python-int pages, as the plain integrator uses
        w = jrng.depth_page_key(jrng.key_from_seed(3), page)
        assert trng.depth_page_key(key, page) == (int(w[0]), int(w[1]))


def test_uniform2_bitwise():
    lane, draw = _u32(N, 21), _u32(N, 22)
    key = trng.key_from_seed(42)
    want = jrng.uniform2(jrng.key_from_seed(42), jnp.asarray(lane), jnp.asarray(draw))
    got = trng.uniform2(key, _t(lane), _t(draw))
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_to_unit_f32_bitwise_and_half_open():
    bits = _u32(N, 31)
    bits[:4] = [0, 0xFFFFFFFF, 0xFF, 0x100]
    want = np.asarray(jrng._to_unit_f32(jnp.asarray(bits)))
    got = trng._to_unit_f32(_t(bits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() < 1.0


def test_lowbias32_bitwise():
    h = _u32(N, 41)
    want = np.asarray(jnoise.lowbias32(jnp.asarray(h)))
    np.testing.assert_array_equal(_np(tnoise.lowbias32(_t(h))), want)


def test_value_noise_matches_jax():
    """Hash lattice noise: integer hashing is bitwise; the Hermite blend is
    f32 arithmetic, which XLA may contract into FMAs, hence the tolerance."""
    from myraytracer_tpu.core.vec import V3 as JV3
    from myraytracer_tpu_torch.core.vec import V3 as TV3

    p = np.random.RandomState(5).uniform(-20, 20, (3, 4096)).astype(np.float32)
    want = np.asarray(jnoise.turbulence(JV3(*(jnp.asarray(c) for c in p))))
    got = tnoise.turbulence(TV3(*(torch.from_numpy(c) for c in p))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
