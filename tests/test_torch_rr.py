"""Russian roulette and paged depth in the PyTorch port.

The roulette's uniform is the first word of the bounce's first draw slot
under ``fold_key(page key, RR_KEY_FOLD)``, so turning it on moves nothing
in the main stream; past ``MAX_DEPTH`` bounces the page key is
``depth_page_key(key, page)`` (page 0 is the main key). Against JAX:

* the page keys and their RR keys are bitwise JAX's;
* the plain integrator against the JAX jnp integrator, jitted (the
  statistical bar of ``test_torch_trace.assert_render_close``) and eagerly
  (every pixel within rtol 1e-4, atol 1e-5, equal segments). Measured on
  this CPU (pixels within tolerance, segments): three-sphere rr 3 depth
  10 at 24x16, jitted 1.0 (2042 = 2042); cornell depth 100 at 16x8,
  jitted 1.0 bit for bit (483 vs 482 segments), eager 1.0 (483 = 483);
  cornell depth 100 rr 3 at 24x16, jitted 1.0 bit for bit (853 = 853).
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import numpy as np
import pytest
import torch

from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu_torch import cli
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.kernels import trace as ktrace
from myraytracer_tpu_torch.render import integrator
from myraytracer_tpu_torch.render.session import RenderSession
from myraytracer_tpu_torch.scene import presets
from myraytracer_tpu_torch.scene.compile import compile_scene

from test_torch_nee import assert_eager_equal, render_pair
from test_torch_trace import assert_render_close

KEY = trng.key_from_seed(0)


@pytest.mark.parametrize("seed", [0, 0x1234_5678_9ABC])
def test_paged_rr_keys_bitwise(seed):
    """Page p's key and its RR key, for the pages a u32 depth reaches."""
    key, jkey = trng.key_from_seed(seed), jrng.key_from_seed(seed)
    for page in (0, 1, 2, 63, 1 << 20, (1 << 32) // 63):
        want = jrng.fold_key(jrng.depth_page_key(jkey, page), jrng.RR_KEY_FOLD)
        got = trng.fold_key(trng.depth_page_key(key, page), trng.RR_KEY_FOLD)
        assert got == (int(want[0]), int(want[1]))
    assert trng.RR_KEY_FOLD == jrng.RR_KEY_FOLD


@pytest.mark.parametrize("name,spp,depth,rr,frac,w,h", [
    ("three-sphere", 2, 10, 3, 0.98, 24, 16),
    ("cornell", 1, 100, 0, 0.98, 16, 8),
    ("cornell", 1, 100, 3, 0.98, 24, 16),
], ids=["three-sphere-rr3", "cornell-d100", "cornell-d100-rr3"])
def test_plain_matches_jax_integrator(name, spp, depth, rr, frac, w, h):
    got, segs, want, jsegs = render_pair(name, w, h, spp, depth, rr=rr)
    assert_render_close(got, want, segs, jsegs, pixel_frac=frac)


@pytest.mark.parametrize("rr", [0, 3])
def test_paged_depth_matches_unfused_jax_integrator(rr):
    assert_eager_equal(*render_pair("cornell", 16, 8, 1, 100, eager=True, rr=rr))


def test_rr_beyond_depth_is_bitwise_noop():
    """rr > depth never fires: bitwise the render without it."""
    world = presets.three_sphere_scene()
    scene = compile_scene(world)
    base = integrator.make_renderer(world.camera, 16, 8, 4, 6, sample_batch=4)
    noop = integrator.make_renderer(world.camera, 16, 8, 4, 6, sample_batch=4, rr=7)
    a, sa = base(scene, KEY, 0)
    b, sb = noop(scene, KEY, 0)
    assert torch.equal(a, b) and float(sa) == float(sb)


def test_depth_within_one_page_is_the_one_page_stream():
    """Depth 62 and depth 100 trace the same first 62 bounces: a path that
    ends before bounce 62 has the same radiance in both."""
    world = presets.cornell_scene()
    scene = compile_scene(world, spatial_sort=True)
    kw = dict(sky=world.ambient, sample_batch=1)
    a, _ = integrator.make_renderer(world.camera, 16, 8, 1, trng.MAX_DEPTH, **kw)(scene, KEY, 0)
    b, _ = integrator.make_renderer(world.camera, 16, 8, 1, 100, **kw)(scene, KEY, 0)
    # Radiance is gathered only at path ends; a longer cap adds paths that
    # ended past bounce 62 and changes nothing else.
    assert (b >= a).all() and (b != a).float().mean() < 0.5


def test_rr_cuts_segments_and_stays_unbiased():
    """On the enclosed cornell box RR trims the deep tail: fewer segments
    at rr 4, depth 24, and the image mean within 5% at 64 spp (the JAX
    package measured 0.55x segments and a 0.2% mean shift)."""
    world = presets.cornell_scene()
    scene = compile_scene(world, spatial_sort=True)
    kw = dict(sky=world.ambient, sample_batch=16)
    a, sa = integrator.make_renderer(world.camera, 12, 8, 64, 24, **kw)(scene, KEY, 0)
    b, sb = integrator.make_renderer(world.camera, 12, 8, 64, 24, rr=4, **kw)(scene, KEY, 0)
    assert float(sb) < 0.7 * float(sa)
    assert abs(float(b.mean()) - float(a.mean())) < 0.05 * float(a.mean())


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    """For CPU tensors the kernel's renderer with rr and a paged depth is
    the plain integrator's, bit for bit."""
    world = presets.three_sphere_scene()
    scene = compile_scene(world)
    args = (world.camera, 16, 8, 2, trng.MAX_DEPTH + 4)
    a, sa = ktrace.make_renderer(*args, rr=2)(scene, KEY, 3)
    b, sb = integrator.make_renderer(*args, rr=2)(scene, KEY, 3)
    assert torch.equal(a, b) and float(sa) == float(sb)


def test_rr_session_cli_and_checkpoint_provenance(tmp_path):
    cfg = RenderConfig(width=16, height=8, samples_per_frame=2, ray_depth=8,
                       backend="torch", rr=3)
    s = RenderSession(presets.three_sphere_scene(), cfg)
    s.step()
    path = tmp_path / "rr.npz"
    s.save_checkpoint(path)
    other = RenderSession(presets.three_sphere_scene(), cfg.replace(rr=0))
    with pytest.raises(ValueError, match="rr"):
        other.load_checkpoint(path)
    same = RenderSession(presets.three_sphere_scene(), cfg)
    same.load_checkpoint(path)
    assert torch.equal(s.framebuffer, same.framebuffer)
    args = cli.build_parser().parse_args(["--rr", "5", "--nee", "--qmc"])
    assert (args.rr, args.nee, args.qmc) == (5, True, True)
    out = tmp_path / "c.png"
    assert cli.main(["--backend", "torch", "--scene", "cornell", "--nee", "--rr", "2",
                     "--width", "12", "--height", "8", "--ray-depth", "4",
                     "--out", str(out)]) == 0
    assert out.exists()
    np.testing.assert_array_equal(out.read_bytes()[:4], b"\x89PNG")
