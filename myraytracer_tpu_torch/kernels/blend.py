"""The framebuffer blend of a step on the card (``csrc/blend.cu``) and its
wrapper.

``blend`` blends a step's K per-frame images into the framebuffer with one
launch of ``blend_frames_kernel``: ``fb = fma(fb, w, img * (1 - w))`` per
frame, in frame order, the fused multiply-add rounded once. Its plain
version is ``render.session.blend_plain``, the chain of ``fma_f32`` that
the CPU session runs; the two are bitwise equal. ``render.session.
_blend_chain`` takes the plain version for CPU tensors and this kernel for
CUDA tensors, and never falls back from one to the other.

What bounds the kernel: bytes, ``step_bytes`` a step (the K images and
the framebuffer read once, the framebuffer written once).
"""

from __future__ import annotations

import ctypes

import torch

from myraytracer_tpu_torch.kernels import build as kbuild

SOURCE = kbuild.CSRC / "blend.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
BLEND = kbuild.Kernel(SOURCE, "mrt_blend_frames",
                      [_P, _P, _L, _L, _L, _L, _P, _I, _I, _I, _P, _P])


def step_bytes(frames: int, height: int, width: int) -> int:
    """The bytes a blend of ``frames`` images at ``height`` x ``width``
    must move: the images and the framebuffer read once, the framebuffer
    written once, f32 RGB."""
    return (frames + 2) * height * width * 3 * 4


def blend(fb_hwc: torch.Tensor, imgs_kchw: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The framebuffer ``fb_hwc`` ([H, W, 3], contiguous) after the K images
    ``imgs_kchw`` ([K, 3, H, W], any strides) with ``weights`` ([K],
    contiguous), all f32 on one CUDA device; a fresh tensor, so a
    framebuffer that a caller still holds is never written. Raises on any
    other input."""
    dev = fb_hwc.device
    if dev.type != "cuda":
        raise ValueError(f"the blend kernel runs on cuda tensors, not {dev}")
    for name, t in (("framebuffer", fb_hwc), ("images", imgs_kchw), ("weights", weights)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 on {dev}, got {t.dtype} on {t.device}")
    if fb_hwc.dim() != 3 or fb_hwc.shape[2] != 3 or not fb_hwc.is_contiguous():
        raise ValueError(f"framebuffer must be contiguous [H, W, 3], got {tuple(fb_hwc.shape)}")
    h, w = fb_hwc.shape[:2]
    k = imgs_kchw.shape[0] if imgs_kchw.dim() == 4 else -1
    if tuple(imgs_kchw.shape) != (k, 3, h, w):
        raise ValueError(f"images must be [K, 3, {h}, {w}], got {tuple(imgs_kchw.shape)}")
    if tuple(weights.shape) != (k,) or not weights.is_contiguous():
        raise ValueError(f"weights must be contiguous [{k}], got {tuple(weights.shape)}")
    out = torch.empty_like(fb_hwc)
    BLEND.launch(fb_hwc.data_ptr(), imgs_kchw.data_ptr(), *imgs_kchw.stride(), weights.data_ptr(),
                 k, h, w, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return out
