"""Frozen copy of the per-pixel fold of ``myraytracer_tpu_torch/render/
adaptive.py:_update_stats``, and of ``render/session.py:fma_f32`` that it
calls, at commit fc57fc7, for the benchmark's reference.

The adaptive session keeps each pixel's running mean. It folds a window of
``k`` samples into it as ``fb = fma_f32(fb, n_old, sum_w) / (n_old + k)``,
where ``sum_w`` is the window's radiance sum and ``n_old`` the samples
folded since the last camera move, as float32, one window at a time in
sample order. The statistics that pick the blocks (``s1``, ``s2``, the
scores) are not copied: the reference takes which samples each block got
from the program's spp map and judges the pixels they make.
"""

from __future__ import annotations

import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` in f32 with one rounding: the f32 product is exact in
    f64, the f64 sum is rounded to odd (its rounding error, from TwoSum,
    sets the last bit), so the final rounding to f32 is the correctly
    rounded fused result on every device."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def fold(sums: torch.Tensor, windows: torch.Tensor, k: int) -> torch.Tensor:
    """Each pixel's running mean after its first ``windows[p]`` windows:
    ``sums`` [W, P, 3] f32 holds window ``w``'s radiance sum of ``k``
    samples at pixel ``p``; ``windows`` [P] int. Returns [P, 3] f32."""
    fb = torch.zeros(sums.shape[1:], dtype=torch.float32)
    n_b = torch.zeros((sums.shape[1],), dtype=torch.int32)
    kf = float(k)
    for w in range(sums.shape[0]):
        sel = windows > w
        n_old = n_b.to(torch.float32)[:, None]
        fb = torch.where(sel[:, None], fma_f32(fb, n_old, sums[w]) / (n_old + kf), fb)
        n_b = n_b + k * sel.to(torch.int32)
    return fb
