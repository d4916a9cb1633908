"""The session's blend on the CPU: ``_blend_chain`` takes the plain
``fma_f32`` chain for CPU tensors and never the CUDA kernel
(``csrc/blend.cu``, held to the chain on the card by
``tests/test_torch_blend_gpu.py``), whose wrapper refuses what it does not
take rather than fall back."""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import re

import numpy as np
import pytest
import torch

from benchmark.profiling import TRACE_KERNELS
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.kernels import blend as kblend
from myraytracer_tpu_torch.kernels import build as kbuild
from myraytracer_tpu_torch.render import session as session_mod
from myraytracer_tpu_torch.scene import presets


def _inputs(k, h, w, seed=0):
    rs = np.random.RandomState(seed)
    fb = rs.random_sample((h, w, 3)).astype(np.float32)
    imgs = rs.exponential(1.0, (k, 3, h, w)).astype(np.float32)
    ws = np.asarray([n / (n + 1) if n else 0.0 for n in range(k)], np.float32)
    return torch.from_numpy(fb), torch.from_numpy(imgs), torch.from_numpy(ws)


@pytest.fixture
def no_kernel(monkeypatch):
    """The kernel's library may not load: a CPU path that reached it fails."""
    def refuse():
        raise AssertionError("the blend kernel's library was loaded on the CPU path")

    monkeypatch.setattr(kblend.BLEND, "load", refuse)
    monkeypatch.setattr(kblend.BLEND, "launches", 0)


@pytest.mark.parametrize("k,h,w", [(1, 5, 7), (2, 5, 7), (16, 12, 9), (17, 4, 3)])
def test_cpu_blend_is_the_plain_chain_without_the_kernel(no_kernel, k, h, w):
    fb, imgs, ws = _inputs(k, h, w, seed=k)
    got = session_mod._blend_chain(fb, imgs, ws)
    want = session_mod.blend_plain(fb, imgs, ws)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert kblend.BLEND.launches == 0
    assert not any(src == kblend.SOURCE for src, _ in kbuild._LIBS)


def test_cpu_blend_takes_the_channels_last_view_of_one_frame(no_kernel):
    """A K = 1 step blends ``img.permute(2, 0, 1)[None]`` of the renderer's
    [H, W, 3] image, a view with no copy."""
    fb, imgs, ws = _inputs(1, 6, 5, seed=3)
    hwc = imgs[0].permute(1, 2, 0).contiguous()
    got = session_mod._blend_chain(fb, hwc.permute(2, 0, 1)[None], ws)
    assert torch.equal(got, session_mod.blend_plain(fb, imgs, ws))
    assert kblend.BLEND.launches == 0


def test_cpu_session_steps_launch_no_blend_kernel(no_kernel):
    cfg = RenderConfig(width=8, height=4, samples_per_frame=1, ray_depth=2, backend="torch",
                       frame_batch=2)
    s = session_mod.RenderSession(presets.get_scene("three-sphere"), cfg)
    s.step()
    s.step()
    assert (s.frame_count, kblend.BLEND.launches) == (4, 0)


@pytest.mark.parametrize("where", ["framebuffer", "images", "weights"])
def test_a_non_cpu_input_goes_to_the_kernel_and_is_refused(no_kernel, where):
    """One input off the CPU takes the kernel's path, which checks the
    devices before it loads anything: mixed inputs raise, never blend."""
    args = dict(zip(("framebuffer", "images", "weights"), _inputs(2, 3, 4)))
    args[where] = args[where].to("meta")
    with pytest.raises(ValueError, match="cuda tensors|must be f32"):
        session_mod._blend_chain(*args.values())
    assert kblend.BLEND.launches == 0


def test_the_wrapper_refuses_cpu_tensors(no_kernel):
    with pytest.raises(ValueError, match="runs on cuda tensors, not cpu"):
        kblend.blend(*_inputs(2, 3, 4))


def test_blend_kernel_names_avoid_the_profilers_trace_kernels():
    """The profiler counts every kernel whose name holds none of
    ``TRACE_KERNELS`` among the session's; the blend must be one of them."""
    names = re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?(?:void\s+)?"
                       r"(\w+)\s*\(", kblend.SOURCE.read_text())
    assert names == ["blend_frames_kernel"]
    assert not [n for n in names for t in TRACE_KERNELS if t in n]


def test_step_bytes_is_the_images_and_the_framebuffer_once():
    assert kblend.step_bytes(16, 800, 1200) == 18 * 800 * 1200 * 12 == 207_360_000
    assert kblend.step_bytes(1, 5, 7) == 3 * 35 * 12
