"""Multi-frame buckets in the PyTorch port: K progressive frames per call.

The plain renderer's K frames are K one-frame block calls, so they are held
bitwise to K single calls, and a frame-batched session bitwise to K single
steps. Against the JAX package's jnp integrator the frames agree at the
port's small-shape tolerance (tests/test_torch_trace.py: rtol 1e-4, atol
1e-5; XLA contracts multiply-adds on the CPU, the port does not). On the
card the CUDA kernel's frame buckets are held bitwise to its single
launches (tests/test_torch_gpu.py, chip_smoke.py).
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import numpy as np
import pytest
import torch

from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu.render.integrator import make_renderer as make_jnp
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu.scene.compile import compile_scene as jcompile
from myraytracer_tpu_torch import config as tconfig
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.kernels import trace as ktrace
from myraytracer_tpu_torch.render import dispatch, integrator
from myraytracer_tpu_torch.render.session import RenderSession
from myraytracer_tpu_torch.scene import presets as tpresets
from myraytracer_tpu_torch.scene.compile import compile_scene as tcompile

W, H, SPP, DEPTH, K = 16, 8, 2, 4, 3


@pytest.mark.parametrize("name", ["three-sphere", "defocus"])
@pytest.mark.parametrize("factory", [integrator.make_renderer, ktrace.make_renderer],
                         ids=["plain", "kernel-wrapper"])
def test_multiframe_render_is_k_single_calls(name, factory):
    """``[K,3,H,W]`` per-frame means, frame f bitwise the one-frame call at
    sample base ``base + f*spp``; the kernel's wrapper on CPU tensors is
    the plain version."""
    world = tpresets.get_scene(name)
    scene = tcompile(world)
    key = trng.key_from_seed(4)
    multi = factory(world.camera, W, H, SPP, DEPTH, frames=K)
    single = integrator.make_renderer(world.camera, W, H, SPP, DEPTH)
    imgs, segs = multi(scene, key, 5)
    assert imgs.shape == (K, 3, H, W)
    total = 0.0
    for f in range(K):
        want, wsegs = single(scene, key, 5 + f * SPP)
        assert torch.equal(imgs[f], want.permute(2, 0, 1))
        total += float(wsegs)
    assert float(segs) == total


def test_trace_spheres_frames_contract_on_cpu():
    """The wrapper's buckets: [K, 3, n_rows, W] sums over consecutive
    windows of a row window, and segments totalled over the frames."""
    world = tpresets.three_sphere_scene()
    scene = tcompile(world)
    key = trng.key_from_seed(1)
    sums, segs = ktrace.trace_spheres(scene, None, key, W, H, 2, 5, 7, SPP, DEPTH,
                                      1e-3, 1e4, frames=K)
    assert sums.shape == (K, 3, 5, W) and segs.shape == (5, W)
    want_segs = torch.zeros_like(segs)
    for f in range(K):
        one, s = ktrace.trace_spheres(scene, None, key, W, H, 2, 5, 7 + f * SPP, SPP,
                                      DEPTH, 1e-3, 1e4)
        assert torch.equal(sums[f], one.permute(2, 0, 1))
        want_segs += s
    assert torch.equal(segs, want_segs)


@pytest.mark.parametrize("cap", [1.0, 0.8])
def test_frame_batched_session_is_k_single_steps(cap):
    world = tpresets.defocus_scene()
    cfg = RenderConfig(width=W, height=H, samples_per_frame=SPP, ray_depth=DEPTH,
                       backend="torch", max_framebuffer_weight=cap)
    a = RenderSession(world, cfg)
    assert a.frame_batch == 1
    for _ in range(2 * K):
        a.step()
    b = dispatch.make_session(world, cfg.replace(frame_batch=K))
    assert b.frame_batch == K
    b.run(2 * K)
    assert torch.equal(a.framebuffer, b.framebuffer)
    assert (a.frame_count, a.sample_cursor) == (b.frame_count, b.sample_cursor)
    assert a.segments_traced == b.segments_traced


def test_frame_batched_checkpoint_resumes_with_single_steps(tmp_path):
    """``frame_batch`` is not provenance: a batched run's checkpoint
    resumes in a one-frame session, and the stream continues."""
    world = tpresets.three_sphere_scene()
    cfg = RenderConfig(width=W, height=H, samples_per_frame=1, ray_depth=DEPTH,
                       backend="torch")
    b = RenderSession(world, cfg.replace(frame_batch=2))
    b.step()
    ck = tmp_path / "b.npz"
    b.save_checkpoint(ck)
    r = RenderSession(world, cfg)
    r.load_checkpoint(ck)
    r.step()
    a = RenderSession(world, cfg)
    a.run(3)
    assert torch.equal(r.framebuffer, a.framebuffer)


@pytest.mark.parametrize("name", ["reference", "three-sphere"])
def test_multiframe_matches_jax_integrator(name):
    jworld = jpresets.get_scene(name)
    jr = make_jnp(jworld.camera, W, H, SPP, DEPTH, sample_batch=SPP, frames=K)
    want, wsegs = jr(jcompile(jworld), jrng.key_from_seed(0), 3)
    world = tpresets.get_scene(name)
    got, segs = integrator.make_renderer(world.camera, W, H, SPP, DEPTH, frames=K)(
        tcompile(world), trng.key_from_seed(0), 3
    )
    want = np.asarray(want)
    assert got.shape == want.shape == (K, 3, H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert abs(float(segs) - float(wsegs)) <= 0.01 * float(wsegs)


def test_block_renderer_frames_needs_whole_frames():
    world = tpresets.reference_scene()
    block = integrator.make_block_renderer(world.camera, W, H, H, SPP, DEPTH, frames=K)
    with pytest.raises(ValueError, match="frames"):
        block(tcompile(world), trng.key_from_seed(0), 0, 0, SPP)


def test_auto_frame_batch_policy():
    """Auto batches toward CUDA_FRAME_WINDOW samples a launch on the CUDA
    kernel, capped by ``max_frames`` (a ceil split, never past the
    requested count); one frame on torch; an explicit frame_batch wins (the
    analog of tests/test_multiframe.py's policy test)."""
    C = RenderConfig
    auto1 = tconfig.CUDA_FRAME_WINDOW
    assert C(samples_per_frame=1).resolve_frame_batch("cuda") == auto1
    assert C(samples_per_frame=8).resolve_frame_batch("cuda") == max(
        1, tconfig.CUDA_FRAME_WINDOW // 8)
    assert C(samples_per_frame=10**6).resolve_frame_batch("cuda") == 1
    assert C(samples_per_frame=1, max_frames=2).resolve_frame_batch("cuda") == min(2, auto1)
    for frames in (1, 7, 100, 1000):
        k = C(samples_per_frame=1, max_frames=frames).resolve_frame_batch("cuda")
        steps = -(-frames // k)
        assert 1 <= k <= auto1 and k * steps >= frames and (k - 1) * steps < frames
    assert C(samples_per_frame=1).resolve_frame_batch("torch") == 1
    assert C(samples_per_frame=1, shard="samples").resolve_frame_batch("cuda") == 1
    assert C(frame_batch=5, max_frames=2).resolve_frame_batch("cuda") == 5
    assert C(frame_batch=5).resolve_frame_batch("torch") == 5


def test_auto_adaptive_window_policy():
    """Auto F targets CUDA_ADAPTIVE_WINDOW samples a round on the CUDA
    kernel, capped at CUDA_ADAPTIVE_CAP and at a quarter of a bounded
    budget; 1 on torch; explicit frame_batch wins (the analog of
    tests/test_adaptive.py's window-policy test)."""
    C = RenderConfig
    win, cap = tconfig.CUDA_ADAPTIVE_WINDOW, tconfig.CUDA_ADAPTIVE_CAP
    for spp in (1, 8, 32):
        assert C(samples_per_frame=spp).resolve_adaptive_windows("cuda") == max(
            1, min(cap, win // spp))
    assert C(samples_per_frame=10**6).resolve_adaptive_windows("cuda") == 1
    auto8 = C(samples_per_frame=8).resolve_adaptive_windows("cuda")
    assert C(samples_per_frame=8, max_frames=20).resolve_adaptive_windows("cuda") == min(auto8, 5)
    assert C(samples_per_frame=8, max_frames=2).resolve_adaptive_windows("cuda") == 1
    assert C(samples_per_frame=8).resolve_adaptive_windows("torch") == 1
    assert C(samples_per_frame=8, frame_batch=3).resolve_adaptive_windows("cuda") == 3
    assert C(samples_per_frame=8, frame_batch=3).resolve_adaptive_windows("torch") == 3
