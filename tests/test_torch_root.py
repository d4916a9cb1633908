"""The sphere test's root in the trace kernels, on the CPU.

The kernels root with ``sqrt_fast``, ptxas's fast sequence for IEEE
``sqrtf`` without its range check, and run a closest-hit sweep again with
``sqrtf`` where a discriminant falls under 2^-101, below the range on which
the two agree (``csrc/trace.cu`` ``closest_hit``). Here: the torch mirror
of that range check (``kernels.trace.sqrt_fast_missed``) on every class of
discriminant, its bound against the probes' and the kernel's text, the
tangent worlds (``tests/tangent_world.py``) that force the second sweep on
the card, and the renderers' count of them. The card's side is in
``tests/test_torch_gpu.py`` (``cuda``).
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import re

import numpy as np
import pytest
import torch

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.core.vec import V3
from myraytracer_tpu_torch.kernels import probes
from myraytracer_tpu_torch.kernels import trace as ktrace
from myraytracer_tpu_torch.render import hit
from myraytracer_tpu_torch.render.adaptive import AdaptiveSession
from myraytracer_tpu_torch.render.session import RenderSession
from myraytracer_tpu_torch.scene import presets
from myraytracer_tpu_torch.scene.compile import compile_scene
from tangent_world import CAMERA, GATED, TINY_R, tangent_scene

F32 = np.float32
LOW = F32(2.0 ** -101)


def _bits(b: int) -> float:
    return float(torch.tensor(b, dtype=torch.int32).view(torch.float32))


# Each class of f32 discriminant, and whether the kernels sweep again: the
# ones under 2^-101 in magnitude, where sqrt_fast is not sqrtf on the
# positive ones (the negative ones miss as before); not +inf, whose roots
# (NaN, and sqrtf's +inf) both miss, nor a NaN, which fails disc >= 0 under
# either root (every pad slot's).
CLASSES = [
    ("negative", -1.0, False),
    ("-inf", -np.inf, False),
    ("-0", -0.0, True),
    ("+0", 0.0, True),
    ("least subnormal", 1e-45, True),
    ("least normal", 2.0 ** -126, True),
    ("2^-101 less one ulp", float(np.nextafter(LOW, F32(0))), True),
    ("2^-101", float(LOW), False),
    ("one", 1.0, False),
    ("FLT_MAX", float(np.finfo(F32).max), False),
    ("+inf", np.inf, False),
    ("NaN", _bits(0x7FC00000), False),
    ("the card's NaN", _bits(0x7FFFFFFF), False),
    ("negative NaN", _bits(-0x400000), False),
    ("negative subnormal", -1e-45, True),
]


@pytest.mark.parametrize("name,value,again", CLASSES, ids=[c[0] for c in CLASSES])
def test_range_check_on_each_class_of_discriminant(name, value, again):
    """The mirror of the kernels' range check on one discriminant, alone
    and among in-range and negative ones (a sweep runs again if any one of
    its discriminants calls for it)."""
    disc = torch.tensor([value], dtype=torch.float32)
    assert torch.equal(disc.view(torch.int32), torch.tensor([value], dtype=torch.float32)
                       .view(torch.int32))  # the class's sign and payload kept
    assert ktrace.sqrt_fast_missed(disc).tolist() == [again]
    span = torch.tensor([1.0, -3.0, float(LOW), value, 7.0], dtype=torch.float32)
    assert bool(ktrace.sqrt_fast_missed(span).any()) == again


def test_range_bounds_are_the_probes_and_the_kernels():
    """The range is ``probes.SQRT_FAST_BITS``, the bits of 2^-101 and
    FLT_MAX (phase i of chip_smoke.py holds sqrt_fast bitwise sqrtf on
    every float between), and ``csrc/trace.cu`` states its lower bound,
    the one the range check reads, as the same float; the mirror flags the
    float under each bound's and not the bounds; the kernel's sqrt_fast is
    the probes' sequence, line for line."""
    assert ktrace.SQRT_FAST_BITS == probes.SQRT_FAST_BITS
    lo, hi = (_bits(b) for b in ktrace.SQRT_FAST_BITS)
    assert (lo, hi) == (2.0 ** -101, float(np.finfo(F32).max))
    text = ktrace.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr float (kSqrtFast\w*) = (0x[0-9a-fp.+-]+)f;", text))
    assert {k: float.fromhex(v) for k, v in consts.items()} == {"kSqrtFastLo": lo}
    ends = torch.tensor(ktrace.SQRT_FAST_BITS, dtype=torch.int32)
    assert ktrace.sqrt_fast_missed((ends - 1).view(torch.float32)).tolist() == [True, False]
    assert ktrace.sqrt_fast_missed(ends.view(torch.float32)).tolist() == [False, False]

    def body(src):
        m = re.search(r"float sqrt_fast\(float x\) \{(.*?)\n\}", src, re.S)
        return m.group(1)

    assert body(text) == body(probes.SOURCE.read_text())


@pytest.mark.parametrize("kind", ["tangent", "inf"])
def test_tangent_worlds_meet_each_class(kind):
    """The tangent worlds' camera ray (every pixel's: the origin along -z)
    meets the tangent sphere at a discriminant of exactly +0 and the tiny
    sphere at one under 2^-101 (and ``"inf"``'s giant sphere at +inf, not
    swept again for itself); the
    plain sweep, IEEE root and all, grazes the tangent sphere at t = 5, and
    hits the tiny one first where t_min is 0. The special spheres sit after
    the eight leaders, behind the gates of ``GATED``."""
    scene = tangent_scene(kind, "cpu")
    cam = torch.from_numpy(CAMERA)
    o = V3(*(cam[9 + k].reshape(1) for k in range(3)))
    d = V3(*(cam[k].reshape(1) for k in range(3)))
    ocx, ocy, ocz = (a - c[:, None] for a, c in zip(o, scene.center))
    b = ocx * d.x + ocy * d.y + ocz * d.z
    c = ocx * ocx + ocy * ocy + ocz * ocz - scene.radius_sq[:, None]
    disc = (b * b - c)[:, 0]
    assert disc[8].item() == 0.0 and not torch.signbit(disc[8])
    assert 0.0 < disc[9].item() < 2.0 ** -101 and disc[9].item() == F32(F32(TINY_R) ** 2)
    assert ktrace.sqrt_fast_missed(disc[8:10]).all()
    assert not ktrace.sqrt_fast_missed(disc[:8]).any()  # the fillers miss in range
    if kind == "inf":  # both roots miss: not swept again for itself
        assert disc[10].item() == np.inf and not ktrace.sqrt_fast_missed(disc[10:11]).any()
    graze = hit.closest_hit(o, d, scene, 1e-3, 1e4)
    assert graze.t.tolist() == [5.0] and graze.idx.tolist() == [8]
    assert hit.closest_hit(o, d, scene, 0.0, 1e4).idx.tolist() == [9]
    tables = ktrace.gate_tables(scene, GATED)
    assert tables.gates.sph_cull and tables.sweep[ktrace.SWEEP_FIELDS.index("leaders")] == 8
    assert not ktrace.gate_tables(scene).gates.sph_cull


def test_exact_count_is_one_int64_on_the_card_and_none_on_the_cpu():
    """A renderer's table cache keeps one int64 zero on its card, made at
    its first launch there; the CPU's plain version has none. The launch
    argument is a pointer to it, or None; anything else raises."""
    cache = ktrace._TableCache(None)
    assert cache.counter(torch.device("cpu")) is None and cache.exact is None
    assert ktrace._exact_ptr(None, torch.device("cpu")) is None
    t = torch.zeros(1, dtype=torch.int64)
    assert ktrace._exact_ptr(t, t.device) == t.data_ptr()
    for bad in (torch.zeros(1, dtype=torch.int32), torch.zeros(2, dtype=torch.int64)):
        with pytest.raises(ValueError):
            ktrace._exact_ptr(bad, bad.device)


def test_exact_sweeps_read_zero_without_a_launch_on_the_card():
    """``exact_sweeps`` takes a kernel renderer or a session; on the CPU,
    where the plain version roots with IEEE sqrt alone, it reads 0, as it
    does for a renderer with no count."""
    world = presets.three_sphere_scene()
    block = ktrace.make_block_renderer(world.camera, 8, 4, 4, 1, 2)
    scene = compile_scene(world, device="cpu")
    block(scene, trng.key_from_seed(0), 0, 0, 1)
    assert block.tables.exact is None and ktrace.exact_sweeps(block) == 0
    cfg = RenderConfig(width=16, height=8, samples_per_frame=1, ray_depth=2, backend="torch")
    session = RenderSession(world, cfg, renderer_factory=ktrace.make_renderer)
    session.step()
    assert session._render.tables is not None and ktrace.exact_sweeps(session) == 0
    adaptive = AdaptiveSession(world, cfg, interpret=True)
    assert isinstance(adaptive._render.tables, ktrace._TableCache)
    assert ktrace.exact_sweeps(adaptive) == 0
    assert ktrace.exact_sweeps(lambda *a: None) == 0
