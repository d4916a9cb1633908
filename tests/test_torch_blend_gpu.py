"""The blend kernel (``csrc/blend.cu``) on a GPU, held bit for bit to the
session's plain ``fma_f32`` chain on the CPU.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip. The file
imports no JAX, so on a machine with a GPU they run with:

    python -m pytest tests/test_torch_blend_gpu.py --noconftest -m cuda

The kernel computes ``fma(fb, w, img * (1 - w))`` with the correctly
rounded fused multiply-add that ``fma_f32`` emulates in float64, each other
operation rounded on its own and denormals kept, so every case is bitwise:
the inputs are made with numpy, with zeros, subnormals and large
magnitudes among the radiance.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import numpy as np
import pytest
import torch

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.kernels import blend as kblend
from myraytracer_tpu_torch.render.session import RenderSession, _blend_chain, blend_plain
from myraytracer_tpu_torch.scene import presets

pytestmark = pytest.mark.cuda

SPECIALS = np.float32([0.0, -0.0, 1e-40, -1e-40, 1e-45, 3e-39, 1e30, -1e30])
LARGE_N = 1_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def weights(n0, k, cap):
    """``RenderSession.step``'s weights for the frames n0 .. n0 + k - 1."""
    return np.asarray([min(cap, n / (n + 1)) if n else 0.0 for n in range(n0, n0 + k)],
                      np.float32)


def with_specials(rs, a):
    """``a`` with about one value in twenty replaced by a special one."""
    hit = rs.random_sample(a.shape) < 0.05
    a[hit] = rs.choice(SPECIALS, int(hit.sum()))
    return a


def inputs(k, h, w, seed):
    rs = np.random.RandomState(seed)
    fb = with_specials(rs, rs.exponential(0.5, (h, w, 3)).astype(np.float32))
    imgs = with_specials(rs, rs.exponential(1.0, (k, 3, h, w)).astype(np.float32))
    return fb, imgs


def bits(t):
    return t.cpu().contiguous().view(torch.int32)


def assert_bitwise(got, want):
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("n0,cap", [(0, 1.0), (0, 0.9), (LARGE_N, 1.0), (LARGE_N, 0.9)])
@pytest.mark.parametrize("h,w", [(800, 1200), (5, 7)])
@pytest.mark.parametrize("k", [1, 2, 16, 17])
def test_kernel_is_the_plain_chain_bitwise(cuda, k, h, w, n0, cap):
    fb, imgs = inputs(k, h, w, seed=1000 * k + h + n0 % 97 + int(cap * 10))
    ws = weights(n0, k, cap)
    want = blend_plain(torch.from_numpy(fb), torch.from_numpy(imgs), torch.from_numpy(ws))
    before = kblend.BLEND.launches
    got = _blend_chain(torch.from_numpy(fb).to(cuda), torch.from_numpy(imgs).to(cuda),
                       torch.from_numpy(ws).to(cuda))
    assert kblend.BLEND.launches == before + 1
    assert_bitwise(got, want)


@pytest.mark.parametrize("h,w", [(800, 1200), (5, 7)])
def test_kernel_reads_one_frames_channels_last_view(cuda, h, w):
    """Orbit's K = 1 step: ``img.permute(2, 0, 1)[None]`` of the trace
    kernel's [H, W, 3] image, read through its strides with no copy."""
    fb, imgs = inputs(1, h, w, seed=7)
    hwc = np.ascontiguousarray(imgs[0].transpose(1, 2, 0))
    ws = weights(37, 1, 1.0)
    want = blend_plain(torch.from_numpy(fb), torch.from_numpy(hwc).permute(2, 0, 1)[None],
                       torch.from_numpy(ws))
    view = torch.from_numpy(hwc).to(cuda).permute(2, 0, 1)[None]
    assert not view.is_contiguous()
    fb_d = torch.from_numpy(fb).to(cuda)
    got = _blend_chain(fb_d, view, torch.from_numpy(ws).to(cuda))
    assert_bitwise(got, want)
    assert got.data_ptr() != fb_d.data_ptr()  # a fresh framebuffer
    assert torch.equal(fb_d.cpu(), torch.from_numpy(fb))


def _bad(case, cuda):
    fb, imgs = inputs(2, 5, 7, seed=3)
    fb, imgs = torch.from_numpy(fb).to(cuda), torch.from_numpy(imgs).to(cuda)
    ws = torch.from_numpy(weights(0, 2, 1.0)).to(cuda)
    if case == "f64 framebuffer":
        fb = fb.double()
    elif case == "f64 images":
        imgs = imgs.double()
    elif case == "f64 weights":
        ws = ws.double()
    elif case == "cpu framebuffer":
        fb = fb.cpu()
    elif case == "cpu images":
        imgs = imgs.cpu()
    elif case == "cpu weights":
        ws = ws.cpu()
    elif case == "non-contiguous framebuffer":
        fb = fb.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "images of another size":
        imgs = imgs[..., :6]
    elif case == "images of two channels":
        imgs = imgs[:, :2]
    elif case == "weights not K":
        ws = torch.cat([ws, ws[:1]])
    return fb, imgs, ws


@pytest.mark.parametrize("case", [
    "f64 framebuffer", "f64 images", "f64 weights", "cpu framebuffer", "cpu images",
    "cpu weights", "non-contiguous framebuffer", "images of another size",
    "images of two channels", "weights not K",
])
def test_kernel_refuses_what_it_does_not_take(cuda, case):
    args = _bad(case, cuda)
    before = kblend.BLEND.launches
    with pytest.raises(ValueError):
        _blend_chain(*args)
    assert kblend.BLEND.launches == before


def test_session_steps_blend_with_one_launch_each_bitwise_the_chain(cuda):
    """Two steps of 16 frames: one blend launch a step, and the framebuffer
    the CPU chain applied to the same per-frame images."""
    cfg = RenderConfig(width=48, height=32, samples_per_frame=1, ray_depth=6, backend="cuda",
                       frame_batch=16)
    s = RenderSession(presets.get_scene("final"), cfg)
    seen = []
    render = s._render

    def keep(*a):
        img, segs = render(*a)
        seen.append(img.cpu())
        return img, segs

    s._render = keep
    launches = []
    for _ in range(2):
        before = kblend.BLEND.launches
        s.step()
        launches.append(kblend.BLEND.launches - before)
    assert launches == [1, 1]
    want = torch.zeros((32, 48, 3), dtype=torch.float32)
    for i, img in enumerate(seen):
        ws = torch.from_numpy(weights(16 * i, 16, cfg.max_framebuffer_weight))
        want = blend_plain(want, img, ws)
    assert_bitwise(s.framebuffer, want)
