"""The trace kernel's module: the plain PyTorch integrator against the JAX
package, and the kernel wrapper's contract on the CPU.

The CUDA kernel itself runs only on a GPU, where it is held against this
plain version (``chip_smoke.py``, ``tests/test_torch_gpu.py``). Here the
plain version is held against the JAX jnp integrator, the JAX Pallas
kernel in interpret mode (as ``tests/test_pallas.py`` runs it) and the
checked-in goldens.

Tolerance. Both sides trace the same threefry stream through the same
expression trees, but they round differently: XLA's CPU backend contracts
``a*b + c`` into FMAs (``jax.jit(lambda a, b, c: a*b + c)`` equals the
fused result on 100% of 2^20 random inputs, the unfused on 77%), and the
two libms differ by a few ulp in ``cos``/``sin``/``exp2``/``log2``. A rare
path flips at a grazing hit and diverges after it, so the comparison is per
image: a fraction of pixels within rtol 1e-4, atol 1e-5; the image mean
within 1e-4 relative; total segments within 1%.

Measured on this CPU (pixels within tolerance): reference, lambertian,
three-sphere, defocus at 16x8 spp 2 depth 4 vs the jnp integrator: 1.0;
reference vs the Pallas kernel: 1.0; golden reference_32x18: 1.0 (mean
equal). Golden final_48x32 (486 spheres, depth 8): 0.9655 — 53 of 1536
pixels hold a path that diverged — with the mean within 9.4e-5 and
segments 8136 vs 8140; its pixel bar is 0.96, the others' 0.98. The same
final render by the jnp integrator run op by op (``jax.disable_jit()``, so
XLA fuses nothing) agrees on 1.0 of pixels (0.981 bit for bit) with equal
segments, and differs from its own jitted golden exactly as the port does
(0.9655): the divergence is the FMA contraction, not the port.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import pathlib

import numpy as np
import pytest
import torch

from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu.kernels.trace import make_renderer as make_pallas
from myraytracer_tpu.render.integrator import make_renderer as make_jnp
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu.scene.compile import compile_scene as jcompile
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.kernels import trace as ktrace
from myraytracer_tpu_torch.render import integrator
from myraytracer_tpu_torch.scene import presets as tpresets
from myraytracer_tpu_torch.scene.api import World
from myraytracer_tpu_torch.scene.compile import compile_scene as tcompile

W, H, SPP, DEPTH = 16, 8, 2, 4
GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"


def assert_render_close(got, want, segs_got, segs_want, pixel_frac=0.98):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() >= pixel_frac, close.mean()
    assert abs(got.mean() - want.mean()) <= 1e-4 * abs(want.mean())
    assert abs(segs_got - segs_want) <= 0.01 * segs_want


def render_port(name, w, h, spp, depth, **kw):
    world = tpresets.get_scene(name)
    r = integrator.make_renderer(world.camera, w, h, spp, depth, sky=world.ambient, **kw)
    img, segs = r(tcompile(world), trng.key_from_seed(0), 0)
    return img.numpy(), float(segs)


@pytest.mark.parametrize("name", ["reference", "lambertian", "three-sphere", "defocus"])
def test_plain_matches_jax_integrator(name):
    world = jpresets.get_scene(name)
    jr = make_jnp(world.camera, W, H, SPP, DEPTH, sample_batch=SPP)
    want, segs = jr(jcompile(world), jrng.key_from_seed(0), 0)
    got, tsegs = render_port(name, W, H, SPP, DEPTH)
    assert_render_close(got, want, tsegs, float(segs))


def test_plain_matches_pallas_kernel_interpret():
    world = jpresets.reference_scene()
    pr = make_pallas(world.camera, W, H, SPP, DEPTH, tile_rows=8, interpret=True)
    want, segs = pr(jcompile(world), jrng.key_from_seed(0), 0)
    got, tsegs = render_port("reference", W, H, SPP, DEPTH)
    assert_render_close(got, want, tsegs, float(segs))


@pytest.mark.parametrize("golden,name,w,h,spp,depth,frac", [
    ("reference_32x18", "reference", 32, 18, 4, 8, 0.98),
    ("final_48x32", "final", 48, 32, 2, 8, 0.96),
])
def test_plain_matches_golden(golden, name, w, h, spp, depth, frac):
    """Rendered as tests/test_golden.py renders the goldens (unsorted
    compile, sample batch 2)."""
    want = np.load(GOLDEN_DIR / f"{golden}.npy")
    jworld = jpresets.get_scene(name)
    _, segs = make_jnp(jworld.camera, w, h, spp, depth, sample_batch=2)(
        jcompile(jworld), jrng.key_from_seed(0), 0
    )
    got, tsegs = render_port(name, w, h, spp, depth, sample_batch=2)
    assert_render_close(got, want, tsegs, float(segs), pixel_frac=frac)


def test_plain_matches_unfused_jax_integrator_on_final():
    """Op-by-op JAX (no fusion, hence no FMA contraction) on the dense
    final scene: the path structure is the same, segment for segment."""
    import jax

    world = jpresets.final_scene()
    jr = make_jnp(world.camera, 48, 32, 2, 8, sample_batch=2)
    with jax.disable_jit():
        want, segs = jr(jcompile(world), jrng.key_from_seed(0), 0)
    got, tsegs = render_port("final", 48, 32, 2, 8, sample_batch=2)
    assert_render_close(got, want, tsegs, float(segs))
    assert tsegs == float(segs)


def test_paged_depth_matches_jax():
    """Depth past MAX_DEPTH draws its late bounces from paged keys."""
    depth = trng.MAX_DEPTH + 3
    world = jpresets.three_sphere_scene()
    want, segs = make_jnp(world.camera, W, H, 1, depth, sample_batch=1)(
        jcompile(world), jrng.key_from_seed(0), 0
    )
    got, tsegs = render_port("three-sphere", W, H, 1, depth)
    assert_render_close(got, want, tsegs, float(segs))


def test_constant_sky_matches_jax():
    jw = jpresets.reference_scene()
    tw = tpresets.reference_scene()
    sky = (0.2, 0.3, 0.4)
    want, segs = make_jnp(jw.camera, W, H, SPP, DEPTH, sample_batch=SPP, sky=sky)(
        jcompile(jw), jrng.key_from_seed(0), 0
    )
    tw = World(tw.spheres, camera=tw.camera, ambient=sky)
    got, tsegs = integrator.make_renderer(tw.camera, W, H, SPP, DEPTH, sky=tw.ambient)(
        tcompile(tw), trng.key_from_seed(0), 0
    )
    assert_render_close(got.numpy(), want, float(tsegs), float(segs))


@pytest.mark.parametrize("name", ["reference", "defocus"])
def test_kernel_wrapper_on_cpu_is_the_plain_version(name):
    """For CPU tensors the kernel's renderer computes the plain version's
    frame, bit for bit (the general camera read from the packed operand)."""
    world = tpresets.get_scene(name)
    scene = tcompile(world)
    key = trng.key_from_seed(5)
    args = (world.camera, W, H, SPP, DEPTH)
    a, sa = ktrace.make_renderer(*args)(scene, key, 3)
    b, sb = integrator.make_renderer(*args)(scene, key, 3)
    assert torch.equal(a, b) and float(sa) == float(sb)


def test_row_and_sample_windows_compose():
    """A block renders any row window of the frame bit for bit, and the
    sample batching of the plain version does not change the sums."""
    world = tpresets.three_sphere_scene()
    scene = tcompile(world)
    key = trng.key_from_seed(1)
    full, fsegs = ktrace.trace_spheres(scene, None, key, W, H, 0, H, 0, 4, DEPTH, 1e-3, 1e4)
    top, tsegs = ktrace.trace_spheres(scene, None, key, W, H, 0, 3, 0, 4, DEPTH, 1e-3, 1e4)
    bot, bsegs = ktrace.trace_spheres(scene, None, key, W, H, 3, H - 3, 0, 4, DEPTH, 1e-3, 1e4)
    assert torch.equal(torch.cat([top, bot]), full)
    assert torch.equal(torch.cat([tsegs, bsegs]), fsegs)
    for batch in (1, 3, 4):
        blk = integrator.make_block_renderer(world.camera, W, H, H, 4, DEPTH,
                                             sample_batch=batch)
        img, segs = blk(scene, key, 0, 0, 4)
        assert torch.equal(img, full) and torch.equal(segs, fsegs)


def test_pack_table_layout():
    scene = tcompile(tpresets.three_sphere_scene())
    table = ktrace.pack_table(scene)
    assert table.shape == (ktrace.TABLE_ROWS, scene.padded_size)
    assert table.dtype == torch.float32 and table.is_contiguous()
    assert torch.equal(table[4], scene.radius_sq)
    assert torch.equal(table[10], scene.mat_ty.to(torch.float32))


def test_launch_queue_is_a_fresh_int32_zero():
    """A launch's tile counter: one int32 zero on the launch's device, a
    new tensor each launch, so that two launches in a row start equal."""
    a, b = ktrace._queue("cpu"), ktrace._queue("cpu")
    assert a.dtype == torch.int32 and tuple(a.shape) == (1,) and int(a) == 0
    assert a.device.type == "cpu" and a.data_ptr() != b.data_ptr()
