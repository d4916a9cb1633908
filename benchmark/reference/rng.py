"""Frozen copy of ``myraytracer_tpu_torch/core/rng.py`` at commit 32ae5bc, for
the benchmark's reference; imports made local. Edits: uniforms in the float type of ``vec.computing_in``.

Counter-based RNG: threefry2x32 keyed on (pixel, sample, bounce).

Port of ``myraytracer_tpu.core.rng``. Every random draw is the pure
function ``threefry2x32(key, (lane_id, draw_id))``, so a frame is
bit-reproducible for a key whatever the batching or the device, and the
plain PyTorch integrator, the CUDA kernel (``csrc/trace.cu``) and the JAX
package all read the same stream. The seed is the threefry key; no
``torch.Generator`` is involved. The kernels' ``rng_mode="hw"`` reads a
second stream, Philox-4x32-10 under the same key (``uniform4_hw``).

uint32 words are carried in int64 tensors (or Python ints, for keys and
scalars): torch has few uint32 ops, so every add, shift and multiply is
done in int64 and masked back to 32 bits with ``M32``. The functions accept
either form and broadcast like the JAX ones.

Sampling of the unit sphere / ball / disk is analytic and branch-free, as
in the JAX package; ``_cbrt01`` keeps its exp2/log2 form so the stream of
ball samples is the same expression tree.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .noise import _mul32, lowbias32
from .vec import V3, float_dtype

M32 = 0xFFFFFFFF


def _init_cpu_math() -> None:
    """Call each elementwise math routine of the plain version once, on one
    element, on the importing thread.

    The CPU's vector math routines set themselves up at their first call.
    When that first call is one parallel op's, made from several threads at
    once, one thread's chunk of it can come out a few ulps off: on a busy
    CPU a process's first render now and then differed from every later
    one in one op's chunk of 2048 lanes. One call each, before any parallel
    op, removes the race.
    """
    one = torch.ones(1)
    for fn in (torch.sin, torch.cos, torch.log2, torch.exp2, torch.sqrt, torch.rsqrt,
               torch.reciprocal, torch.exp, torch.acos):
        fn(one)
    torch.atan2(one, one)


_init_cpu_math()

TAU = 6.283185307179586

# Draw-slot layout inside one (pixel, sample) stream (core/rng.py of the JAX
# package): ``draw_id = sample_id * DRAWS_PER_SAMPLE + slot``; slots 0-1
# are camera draws, and bounce ``i`` owns the DRAWS_PER_BOUNCE slots from
# ``CAMERA_DRAWS + i * DRAWS_PER_BOUNCE``. Bounces past MAX_DEPTH reuse the
# slot window of their page under a derived key (:func:`depth_page_key`).
DRAWS_PER_BOUNCE = 4
CAMERA_DRAWS = 2
MAX_DEPTH = 62  # bounces per draw page (page 0 = the legacy layout)
BOUNCES_PER_PAGE = MAX_DEPTH + 1
DRAWS_PER_SAMPLE = CAMERA_DRAWS + DRAWS_PER_BOUNCE * BOUNCES_PER_PAGE  # 254

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)

# Fold constants of the derived keys (the JAX package's values).
RR_KEY_FOLD = 0x52524F55  # "RROU"
DEPTH_PAGE_FOLD = 0x44455054  # "DEPT"
# Reserved top draw words of the QMC scrambles; the session's cursor guard
# keeps real draw ids below them.
QMC_SCRAMBLE_SLOTS = 2


def _rotl32(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(key, ctr):
    """Threefry-2x32, 20 rounds (Salmon et al., Random123).

    ``key`` and ``ctr`` are pairs of u32 values: Python ints or int64
    tensors holding values in [0, 2^32), broadcastable against each other.
    Returns two u32 values of the broadcast form. Matches the Random123
    known-answer vectors and the JAX package bit for bit.
    """
    k0 = key[0] & M32
    k1 = key[1] & M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)

    x0 = (ctr[0] + ks[0]) & M32
    x1 = (ctr[1] + ks[1]) & M32

    for r in range(20):
        x0 = (x0 + x1) & M32
        x1 = _rotl32(x1, _ROTATIONS[r % 8])
        x1 = x1 ^ x0
        if (r + 1) % 4 == 0:
            j = (r + 1) // 4  # 1..5
            x0 = (x0 + ks[j % 3]) & M32
            x1 = (x1 + ks[(j + 1) % 3] + j) & M32
    return x0, x1


def key_from_seed(seed: int) -> Tuple[int, int]:
    """Split a Python int seed into a (u32, u32) key pair."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32) & M32, seed & M32


def fold_key(key, data: int):
    """Derive a new key by hashing ``data`` under ``key`` (like fold_in)."""
    return threefry2x32(key, (int(data) & M32, 0x9E3779B9))


def depth_page_key(key, page):
    """Key for draw page ``page`` (a u32 int or an int64 tensor).

    Page 0 IS the main key, so the stream for bounces 0..MAX_DEPTH is the
    single-page one; page p >= 1 derives an independent key.
    """
    fk0, fk1 = threefry2x32(key, ((page + DEPTH_PAGE_FOLD) & M32, 0x9E3779B9))
    if not isinstance(page, torch.Tensor):
        return (key[0], key[1]) if page & M32 == 0 else (fk0, fk1)
    is_main = (page & M32) == 0
    k0 = torch.as_tensor(key[0], dtype=torch.int64, device=page.device)
    k1 = torch.as_tensor(key[1], dtype=torch.int64, device=page.device)
    return torch.where(is_main, k0, fk0), torch.where(is_main, k1, fk1)


def _to_unit_f32(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits → float32 uniform in [0, 1) from the top 24 bits (exact)."""
    hi24 = (bits >> 8).to(torch.int32)
    return (hi24.to(torch.float32) * (1.0 / (1 << 24))).to(float_dtype())


def uniform2(key, lane_id: torch.Tensor, draw_id) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independent U[0,1) floats per lane for the given draw slot."""
    b0, b1 = threefry2x32(key, (lane_id, draw_id & M32))
    return _to_unit_f32(b0), _to_unit_f32(b1)


# -- The "hw" stream (the kernels' rng_mode="hw") -----------------------------
#
# The JAX kernel's rng_mode="hw" draws from the TPU's hardware generator: a
# stream that is deterministic for a key but is not threefry's. Its
# counterpart here, and in csrc/trace.cu built with MRT_RNG_HW, is
# Philox-4x32-10 keyed on the render key itself, with the counter (lane,
# sample, b + 1, slot >> 1): b is the absolute bounce (-1, so a counter word
# of 0, for the camera), and a draw at slot s reads words 2*(s & 1) and
# 2*(s & 1) + 1, so one call covers slots {0, 1} or {2, 3}. The image then
# depends on (key, pixel, sample) alone, as the threefry stream's does.
# Russian roulette keeps its threefry page key and QMC its Sobol pairs.

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9  # the key's bumps between rounds
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10


def _mulhilo32(a, c: int):
    """(high, low) 32 bits of ``a * c`` for u32 ``a`` and a u32 constant
    ``c``. In int64 the full product can pass 2^63, so ``c`` is split into
    16-bit halves: ``a * c = 2^16 * (a * c_hi + (a * c_lo >> 16)) + (a *
    c_lo & 0xFFFF)``, whose terms stay below 2^49, and the low 16 bits
    cannot carry into the high word."""
    lo_part = a * (c & 0xFFFF)
    hi = ((a * (c >> 16) + (lo_part >> 16)) >> 16) & M32
    return hi, _mul32(a, c)


def philox4x32(key, ctr, rounds: int = PHILOX_ROUNDS):
    """Philox-4x32 (Salmon et al., SC'11; Random123's ``philox4x32``), 10
    rounds by default.

    ``key`` is a pair and ``ctr`` a 4-tuple of u32 values: Python ints or
    int64 tensors holding values in [0, 2^32), broadcastable against each
    other. Returns four u32 values of the broadcast form. Matches the
    Random123 known-answer vectors and ``csrc/trace.cu philox4x32``.
    """
    k0, k1 = key[0] & M32, key[1] & M32
    c0, c1, c2, c3 = (c & M32 for c in ctr)
    for r in range(int(rounds)):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & M32, (k1 + PHILOX_W1) & M32
        hi0, lo0 = _mulhilo32(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo32(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform4_hw(key, lane_id, sample_id, bounce, pair: int):
    """The four U[0,1) floats of one Philox call of the hw stream: slots
    ``2 * pair`` and ``2 * pair + 1`` of bounce ``bounce`` (-1: the
    camera's), two words each."""
    w = philox4x32(key, (lane_id, sample_id, bounce + 1, pair))
    return tuple(_to_unit_f32(x) for x in w)


def unit_sphere_from_uniforms(u1: torch.Tensor, u2: torch.Tensor) -> V3:
    """Uniform direction on the unit sphere from two U[0,1) draws."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = u2 * TAU
    return V3(r * torch.cos(phi), r * torch.sin(phi), z)


def _exp2(y: torch.Tensor) -> torch.Tensor:
    """``torch.exp2``, the same for a lane wherever it lies in the tensor.

    On the CPU, exp2 of a contiguous tensor runs the vectorized routine on
    whole vectors and the scalar one on the rest, and the two differ in
    the last bit for some inputs: a pixel's value would depend on how many
    pixels share its call (a stripe of the image or all of it). A strided
    operand takes the scalar routine for every lane."""
    if y.device.type != "cpu":
        return torch.exp2(y)
    buf = torch.empty((y.numel(), 2), dtype=y.dtype)
    buf[:, 0] = y.reshape(-1)
    return torch.exp2(buf[:, 0]).reshape(y.shape)


def _cbrt01(u: torch.Tensor) -> torch.Tensor:
    """Cube root on [0,1] via exp2/log2 (the JAX package's form)."""
    r = _exp2(torch.log2(torch.clamp_min(u, 1e-38)) * (1.0 / 3.0))
    return torch.where(u <= 0.0, torch.zeros_like(r), r)


def unit_ball_from_uniforms(u1: torch.Tensor, u2: torch.Tensor, u3: torch.Tensor) -> V3:
    """Uniform point inside the unit ball from three U[0,1) draws."""
    s = unit_sphere_from_uniforms(u1, u2)
    return s * _cbrt01(u3)


def unit_sphere(key, lane_id, draw_id) -> V3:
    """Uniform direction on the unit sphere from draw slot ``draw_id``."""
    u1, u2 = uniform2(key, lane_id, draw_id)
    return unit_sphere_from_uniforms(u1, u2)


def unit_ball(key, lane_id, draw_id) -> V3:
    """Uniform point inside the unit ball; consumes two consecutive draw
    slots, ``draw_id`` and ``draw_id + 1`` (mod 2^32)."""
    u1, u2 = uniform2(key, lane_id, draw_id)
    u3, _ = uniform2(key, lane_id, draw_id + 1)
    return unit_ball_from_uniforms(u1, u2, u3)


def unit_disk_from_uniforms(u1: torch.Tensor, u2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform point inside the unit disk (for thin-lens defocus)."""
    r = torch.sqrt(u1)
    phi = u2 * TAU
    return r * torch.cos(phi), r * torch.sin(phi)


# -- Low-discrepancy camera sampling (the ``qmc`` config knob) ----------------
#
# Under QMC the two camera dimension pairs (sub-pixel jitter, lens disk) come
# from a Sobol (0,2) sequence indexed by the pixel's sample counter, with
# Burley's hash-based Owen scrambling ("Practical Hash-based Owen
# Scrambling", JCGT 2020): per (pixel, pair) the sample index is
# Owen-shuffled and each output dimension Owen-scrambled under seeds derived
# from the render key. Bounce draws stay threefry. The JAX package's
# functions, u32 for u32 (``csrc/trace.cu`` repeats them).

# Direction vectors of the canonical second Sobol dimension, all 32 bits.
QMC_BITS = 32
_SOBOL2_DIRS = []
_d = 1 << 31
for _ in range(QMC_BITS):
    _SOBOL2_DIRS.append(_d)
    _d ^= _d >> 1
del _d


def _reverse_bits32(v):
    """Bitwise reversal of a u32 (the van der Corput radical inverse)."""
    v = v & M32
    v = ((v & 0x0000FFFF) << 16) | (v >> 16)
    v = ((v & 0x00FF00FF) << 8) | ((v >> 8) & 0x00FF00FF)
    v = ((v & 0x0F0F0F0F) << 4) | ((v >> 4) & 0x0F0F0F0F)
    v = ((v & 0x33333333) << 2) | ((v >> 2) & 0x33333333)
    v = ((v & 0x55555555) << 1) | ((v >> 1) & 0x55555555)
    return v


def _sobol2_bits(n):
    """The second Sobol dimension of index ``n`` as raw u32 bits: the XOR of
    the direction numbers of its set bits."""
    n = n & M32
    y = n * 0
    for b, dv in enumerate(_SOBOL2_DIRS):
        y = y ^ (((n >> b) & 1) * dv)
    return y


def sobol02(n, scramble0, scramble1) -> Tuple[torch.Tensor, torch.Tensor]:
    """XOR-scrambled Sobol (0,2) pair of sample index ``n``: van der Corput
    and the second Sobol dimension, each XOR a scramble word, as U[0,1).

    The render path does not call it (the camera takes the Owen-scrambled
    ``qmc_camera_uniforms``); it is the JAX package's unscrambled generator,
    kept so that the tests hold the sequence's bits and its (0,2)-net
    property against the reference."""
    x = _reverse_bits32(n) ^ (scramble0 & M32)
    y = _sobol2_bits(n) ^ (scramble1 & M32)
    return _to_unit_f32(x), _to_unit_f32(y)


def _laine_karras(x, seed):
    """Laine-Karras permutation (an Owen scramble in reversed bit order):
    bit i of the result depends only on bits 0..i of ``x``."""
    x = (x + seed) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return x


def owen_scramble(x, seed):
    """Hash-based Owen (nested uniform) scramble of u32 fraction bits."""
    return _reverse_bits32(_laine_karras(_reverse_bits32(x), seed))


def qmc_camera_uniforms(key, lane_id, sample_id, pair: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Owen-scrambled Sobol camera pair: ``pair`` 0 = sub-pixel jitter, 1 =
    lens. The seeds come from the reserved top draw words of the pixel's
    stream (``QMC_SCRAMBLE_SLOTS``)."""
    s0, s1 = threefry2x32(key, (lane_id, (0xFFFFFFFE + pair) & M32))
    idx = owen_scramble(sample_id & M32, s0)
    x = owen_scramble(_reverse_bits32(idx), s1)
    y = owen_scramble(_sobol2_bits(idx), lowbias32(s1))
    return _to_unit_f32(x), _to_unit_f32(y)
