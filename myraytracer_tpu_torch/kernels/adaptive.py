"""The statistics of an adaptive round on the card (``csrc/adaptive.cu``)
and their wrappers.

``select`` scores a state's candidate blocks and picks the round's top
``n_sel`` with one launch of ``adaptive_select_kernel``: bitwise
``render.adaptive._block_scores``, picked in ``select_blocks``' order (NaN
first, then the highest score, the lowest id first among equals). ``fold``
folds a call's F windows of block sums into a fresh state with one launch
of ``adaptive_fold_kernel``: bitwise F calls of
``render.adaptive._update_stats``. ``render.adaptive.AdaptiveSession`` takes
these for a state on a CUDA device and the plain functions for one on the
CPU, and never falls back from one to the other.

What bounds them: ``select``, its serial window sums and its last block's
ranking, far above its ``select_bytes``; ``fold``, bytes (``fold_bytes``).
"""

from __future__ import annotations

import ctypes

import torch

from myraytracer_tpu_torch.kernels import build as kbuild

SOURCE = kbuild.CSRC / "adaptive.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SELECT = kbuild.Kernel(SOURCE, "mrt_adaptive_select",
                       [_P, _P, _P, _I, _I, _I, _L, _L, _P, _P, _P, _P])
FOLD = kbuild.Kernel(SOURCE, "mrt_adaptive_fold",
                     [_P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I,
                      _P, _P, _P, _P, _P, _P, _P])

BLOCK_H, BLOCK_W = 32, 64  # render.adaptive's blocks
_PIX = BLOCK_H * BLOCK_W
_ROW_BYTES = _PIX * (3 + 1 + 1) * 4 + 4 + 4 + 8  # fbB, s1, s2, n_b, r_b, cursor


def select_bytes(nb1: int, n_sel: int) -> int:
    """The bytes a ``select`` over ``nb1`` state rows must move: s1, s2 and
    r_b of the ``nb1 - 1`` candidates read once, the picks' two i64 lists
    written once."""
    return (nb1 - 1) * (_PIX * 8 + 4) + n_sel * 2 * 8


def fold_bytes(nb1: int, n_sel: int, windows: int) -> int:
    """The bytes a ``fold`` of ``windows`` windows of ``n_sel`` blocks into
    ``nb1`` state rows must move: the window sums and the ids read once,
    the state read once and written once."""
    return windows * n_sel * _PIX * 12 + n_sel * 8 + 2 * nb1 * _ROW_BYTES


def _check(dev: torch.device, name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {dev}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {list(shape)}, got {tuple(t.shape)}")


def _rows(s1: torch.Tensor, s2: torch.Tensor, r_b: torch.Tensor) -> int:
    """The state's row count ``nb1``, after the checks both kernels make of
    the statistics they read (all on ``s1``'s device)."""
    dev = s1.device
    nb1 = s1.shape[0] if s1.dim() else 0
    _check(dev, "s1", s1, torch.float32, (nb1, BLOCK_H, BLOCK_W))
    _check(dev, "s2", s2, torch.float32, (nb1, BLOCK_H, BLOCK_W))
    _check(dev, "r_b", r_b, torch.int32, (nb1,))
    return nb1


def _on_cuda(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the adaptive kernels run on cuda tensors, not {dev}")


def select(s1: torch.Tensor, s2: torch.Tensor, r_b: torch.Tensor, n_sel: int, n_live: int,
           base: int, sentinel: int):
    """The round's picks from a state's rows (``s1``, ``s2`` [nb1, 32, 64]
    f32, ``r_b`` [nb1] i32, contiguous, on one CUDA device): rows ``0 ..
    nb1 - 2`` are the block ids ``base ..``, of which the first ``n_live``
    are alive, and row ``nb1 - 1`` is the spare. Returns ``(rows,
    render_ids)``, each [n_sel] i64 in ``select_blocks``' order: a dead
    id's row is the spare and its render id ``sentinel``. Raises on any
    other input."""
    dev = s1.device
    nb1 = _rows(s1, s2, r_b)
    if not (1 <= n_sel <= nb1 - 1 and 0 <= n_live <= nb1 - 1):
        raise ValueError(f"n_sel {n_sel} and n_live {n_live} must lie in 1 .. {nb1 - 1} "
                         f"and 0 .. {nb1 - 1}")
    _on_cuda(dev)
    work = torch.empty((nb1,), dtype=torch.float32, device=dev)  # the scores, a counter
    out = torch.empty((2, n_sel), dtype=torch.int64, device=dev)
    SELECT.launch(s1.data_ptr(), s2.data_ptr(), r_b.data_ptr(), nb1, n_live, n_sel, base,
                  sentinel, work.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    return out[0], out[1]


def fold(fbB: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor, n_b: torch.Tensor,
         r_b: torch.Tensor, cursor: torch.Tensor, idx: torch.Tensor, sums: torch.Tensor,
         k: int):
    """The state after ``sums`` ([F, n_sel, 32, 64, 3] f32, contiguous: F
    windows of ``k`` samples) is folded into rows ``idx`` ([n_sel] i64, in
    ``0 .. nb1 - 1``), window by window: ``_update_stats``' arguments and
    result but for the F windows, all on one CUDA device. The state is
    fresh tensors, so one that a caller still holds is never written.
    Raises on any other input."""
    dev = s1.device
    nb1 = _rows(s1, s2, r_b)
    _check(dev, "fbB", fbB, torch.float32, (nb1, BLOCK_H, BLOCK_W, 3))
    _check(dev, "n_b", n_b, torch.int32, (nb1,))
    _check(dev, "cursor", cursor, torch.int64, (nb1,))
    n_sel = idx.shape[0] if idx.dim() == 1 else -1
    _check(dev, "idx", idx, torch.int64, (n_sel,))
    f = sums.shape[0] if sums.dim() == 5 else -1
    _check(dev, "sums", sums, torch.float32, (f, n_sel, BLOCK_H, BLOCK_W, 3))
    if nb1 < 1 or n_sel < 1 or f < 1 or k < 1:
        raise ValueError(f"a fold needs rows, ids, windows and samples: nb1 {nb1}, "
                         f"n_sel {n_sel}, F {f}, k {k}")
    _on_cuda(dev)
    out = tuple(torch.empty_like(t) for t in (fbB, s1, s2, n_b, r_b, cursor))
    FOLD.launch(fbB.data_ptr(), s1.data_ptr(), s2.data_ptr(), n_b.data_ptr(), r_b.data_ptr(),
                cursor.data_ptr(), nb1, idx.data_ptr(), n_sel, sums.data_ptr(), f, int(k),
                *(t.data_ptr() for t in out), torch.cuda.current_stream(dev).cuda_stream)
    return out
