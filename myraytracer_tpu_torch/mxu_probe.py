"""Closest-hit formulation probe on one GPU: the per-thread sweep against
the matrix forms.

    python -m myraytracer_tpu_torch.mxu_probe

The counterpart of the JAX package's ``tools/mxu_probe.py``: whether a
matrix formulation of a chunk's closest hit beats the trace kernels'
per-thread sweep on this card. Three hand-written CUDA kernels
(``kernels/probes.py``, ``csrc/probes.cu``) do the same work, R = 2048 rays
x S spheres a trip:

  sweep   the production shape: per-sphere scalars from shared memory,
          the quadratic, the nearest hit's nine record values carried
          into the lane's next trip (the kernel: several rays a thread, a
          sphere in one 16-byte load, the winner's index and one gather).
  mxu     the b and c terms of all pairs as one [R, 16] x [16, 2S] product
          on the tensor cores (wgmma, TF32 operands, f32 sums), then roots,
          minimum and lowest winning index in FP32 on the accumulators.
  vbcast  the same minimum and index from the quadratic in FP32, with no
          tensor cores and no record (the kernel shaped as sweep's).

``sweep`` and ``vbcast`` are bitwise their plain PyTorch versions. ``mxu``
is not f32: TF32 keeps 10 mantissa bits of each operand, so its winners
and its t differ from f32's; ``agreement`` reports both against the plain
TF32 version and against f32.

Each form is timed at two trip counts whose difference cancels the launch,
in turns, with CUDA events, at one tile (2048 rays: ``sweep`` and
``vbcast`` 4 blocks of 256 threads, two rays a thread; ``mxu`` 32 blocks
of one warpgroup, 64 rays each; a block on its own SM) and at
``CARD_TILES`` tiles, which fill the card. One line a form and shape
(``ps/pair``, ``Gpairs/s``, the FP32-peak bound and the issue bound),
after the card's name, power limit and SM clock under load and the sweep
and vbcast kernels' registers. It needs a CUDA GPU and raises without one;
``device="cpu"`` runs the plain PyTorch versions on the host clock instead
(for tests: no such number is a device time).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch

from myraytracer_tpu_torch import sweep as sweep_mod
from myraytracer_tpu_torch.kernels import probes

ITERS = 1000  # trips of the matrix forms' shorter launch
SPHERES = 128
FORMS = ("sweep", "mxu", "vbcast")
LABELS = {
    "sweep": "sweep  (float4 spheres, index, record gather)",
    "mxu": "mxu    (wgmma TF32 [R,16]x[16,2S] + FP32 roots)",
    "vbcast": "vbcast (FP32 quadratic, min and index)       ",
}
# FP32 operations a ray-sphere pair outside the tensor cores: the sweep's
# quadratic (27), nine record adds and the tree's and the carry's selects
# and compares (11 a sphere); the matrix forms' quadratic, roots, selects
# and running minimum (25), of which mxu leaves roots, selects and minimum
# (11) after its product, 2 * 16 * 2 = 64 TF32 operations a pair.
PAIR_FLOPS = {"sweep": 47, "vbcast": 25, "mxu": 11}
MXU_TF32_FLOPS = 2 * probes.MXU_K * 2
# FP32 operations a pair that each form's function needs, each its own
# instruction under -fmad=false: the quadratic (14: o - c three times, b's
# three products and two sums, c's three products and three sums; the
# sweep's o * 0.5, o * 0.25 and r * r come once a ray or a sphere), the
# discriminant, root and selects (9) and the running minimum's compare and
# select (2); mxu the 11 after its product. The sweep's record adds 9 a ray
# and trip: 9 / S a pair (``issue_bound_ps_per_pair``).
PAIR_ISSUES = {"sweep": 25, "vbcast": 25, "mxu": 11}
RECORD = 9
# FP32 instructions an SM issues a cycle: 4 schedulers of 32 lanes.
SM_LANES = 128
# The mxu form against its plain TF32 version on the same inputs: the share
# of rays with the same winner, and the largest |t - t_plain| among those.
# The two differ only in how the 16-term products are summed (a few f32
# ulps of terms up to ~200), which sqrt amplifies where the discriminant is
# near zero. An H100 read agreement 1.000000 and |t err| 2.9e-6 at S = 128;
# the bars leave a few such rays and 30 times that error, and no more: a
# k-slice dropped or summed wrong moves t by far more.
MXU_MIN_AGREE = 0.999
MXU_MAX_T_ERR = 1e-4


def inputs(n_spheres: int, device) -> Dict[str, torch.Tensor]:
    """``probes.hit_inputs`` as contiguous tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device).contiguous()
            for k, v in probes.hit_inputs(n_spheres).items()}


def launcher(form: str, t: Dict[str, torch.Tensor], tiles: int):
    """``launch(n)``: one launch of ``form`` for n trips on ``tiles`` tiles."""
    if form == "sweep":
        return lambda n: probes.sweep(t["sph"], n, tiles)
    if form == "mxu":
        return lambda n: probes.mxu(t["a"], t["panel"], n, tiles)
    return lambda n: probes.vbcast(t["rows"], t["col"], n, tiles)


def blocks(form: str, tiles: int) -> int:
    """The grid whose share of the card ``form``'s bounds take on
    ``tiles`` tiles: a thread a ray in blocks of 256 (``mxu``: a warpgroup
    a block, 64 rays). The sweep and vbcast kernels run a tile's rays as
    half as many blocks, two rays a thread; the bound of the work does not
    follow the kernel's own grid."""
    return tiles * probes.R // (probes.MXU_RAYS if form == "mxu" else probes.BLOCK)


def bound_ps_per_pair(form: str, blocks: int) -> float:
    """The least ps a pair the card allows ``form`` on a grid of ``blocks``
    blocks: its FP32 operations over the FP32 peak these blocks can reach,
    or for ``mxu`` the larger of that and its TF32 operations over the
    tensor cores' peak."""
    share = probes.fp32_peak_share(blocks)
    t = PAIR_FLOPS[form] / (probes.PEAK_FP32 * share)
    if form == "mxu":
        t = max(t, MXU_TF32_FLOPS / (probes.PEAK_TF32 * share))
    return t * 1e12


def issue_bound_ps_per_pair(form: str, blocks: int, sm_hz: float,
                            n_spheres: int = SPHERES) -> float:
    """The least ps a pair at which ``blocks`` blocks can issue ``form``'s
    FP32 operations (``PAIR_ISSUES``; the sweep's record gather 9 / S a
    pair), one instruction each, at ``SM_LANES`` a cycle on each SM they
    occupy at ``sm_hz``; for ``mxu`` the larger of that and its TF32
    product over the tensor cores' peak. ``bound_ps_per_pair`` counts a
    fused multiply-add as two at 67 TFLOP/s; built with -fmad=false, the
    kernels fuse none of the function's products and sums, so each is an
    issue of its own, and this bound is the one they can reach."""
    share = probes.fp32_peak_share(blocks)
    ops = PAIR_ISSUES[form] + (RECORD / n_spheres if form == "sweep" else 0.0)
    t = ops / (SM_LANES * sm_hz * probes.SMS * share)
    if form == "mxu":
        t = max(t, MXU_TF32_FLOPS / (probes.PEAK_TF32 * share))
    return t * 1e12


def probe(form: str, t: Dict[str, torch.Tensor], tiles: int, iters: int,
          sm_hz: float = probes.SM_CLOCK_MAX_HZ) -> dict:
    """One form at one shape: ps a pair, Gpairs/s, the shorter launch's
    ms, the FP32-peak bound and the issue bound at the SM clock
    ``sm_hz``."""
    device = t["sph"].device
    n_s = t["sph"].shape[1]
    pairs = probes.R * n_s * tiles
    per_iter, t_lo = probes.time_pair(launcher(form, t, tiles), iters, device)
    n_blocks = blocks(form, tiles)
    ps = per_iter / pairs * 1e12
    return {"form": form, "tiles": tiles, "blocks": n_blocks, "iters": iters, "spheres": n_s,
            "ps_per_pair": ps, "gpairs_s": 1e3 / ps if ps > 0 else float("inf"),
            "ms_per_iter": per_iter * 1e3, "lo_ms": t_lo * 1e3,
            "bound_ps_per_pair": bound_ps_per_pair(form, n_blocks),
            "issue_bound_ps_per_pair": issue_bound_ps_per_pair(form, n_blocks, sm_hz, n_s),
            "sm_hz": sm_hz}


def line(r: dict) -> str:
    """A form's reading, as ``tools/mxu_probe.py`` prints it, and its
    two bounds at the share of the card of ``blocks(form, tiles)``."""
    return (f"{LABELS[r['form']]}: {r['ps_per_pair']:8.2f} ps/pair -> {r['gpairs_s']:7.1f} "
            f"Gpairs/s (lo run {r['lo_ms']:.1f} ms @ {r['iters']} iters) [{r['tiles']} tile(s), "
            f"bound {r['bound_ps_per_pair']:.3f} ps/pair, issue bound "
            f"{r['issue_bound_ps_per_pair']:.3f} at {r['sm_hz'] / 1e6:.0f} MHz, both at "
            f"{r['blocks']} blocks' share]")


def agreement(t: Dict[str, torch.Tensor], iters: int = 3, tiles: int = 1) -> dict:
    """``mxu`` (the kernel on CUDA inputs) against its plain TF32 version
    and against the same form in f32, after ``iters`` trips on ``tiles``
    tiles: the share of rays, over every tile, with the same winner index,
    and the largest |t| difference among those rays."""
    _, last = probes.mxu(t["a"], t["panel"], iters, tiles)
    out = {}
    for name, tf32 in (("plain_tf32", True), ("f32", False)):
        _, ref = probes.mxu_plain(t["a"], t["panel"], iters, tiles, tf32=tf32)
        same = last[..., 1] == ref[..., 1]
        dt = (last[..., 0] - ref[..., 0]).abs()
        out[name] = {"winner_agreement": float(same.float().mean().item()),
                     "max_t_err": float(dt[same].max().item()) if bool(same.any()) else None}
    return out


def run(device="cuda", tiles=(1, probes.CARD_TILES), iters: Optional[int] = None,
        n_spheres: int = SPHERES, out=print) -> List[dict]:
    """Every form at every shape of ``tiles``, one printed line each, then
    ``mxu``'s agreement; returns the readings. ``tiles``, ``iters`` and
    ``n_spheres`` shrink the run for the plain versions on the CPU. The
    issue bound takes the SM clock read under load, after full-card
    launches of ``vbcast``; on the CPU the card's highest."""
    device = torch.device(device)
    sm_hz = probes.SM_CLOCK_MAX_HZ
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("mxu_probe needs a CUDA GPU, and torch.cuda.is_available() "
                               "is False")
        t = inputs(SPHERES, device)
        idle, clock = probes.loaded_clock(
            lambda: probes.vbcast(t["rows"], t["col"], ITERS, probes.CARD_TILES), device)
        sm_hz = probes.clock_hz(clock)
        out(f"{sweep_mod.card()} | SM clock {idle} idle, {clock} under load")
        for form, (regs, spill) in sorted(probes.hit_registers().items()):
            out(f"{form}_kernel: {regs} registers, {spill} B spill")
    else:
        out("cpu: the plain PyTorch versions on the host clock (no device time)")
    iters = int(iters or ITERS)
    t = inputs(n_spheres, device)
    out(f"R={probes.R} rays x S={n_spheres} spheres = {probes.R * n_spheres} pairs/iter a tile, "
        f"base iters {iters}")
    readings = []
    for n_tiles in tiles:
        for form in FORMS:
            # The sweep does several times the work a pair: fewer trips.
            it = max(1, iters // 4) if form == "sweep" else iters
            readings.append(probe(form, t, n_tiles, it, sm_hz))
            out(line(readings[-1]))
    agree = agreement(t)
    for name, a in agree.items():
        out(f"mxu vs {name}: winner agreement {a['winner_agreement']:.6f}, max |t err| on "
            f"agreeing rays {a['max_t_err']}")
    readings.append({"form": "mxu", "agreement": agree})
    if device.type == "cuda":
        out(f"SM clock after: {probes.sm_clock()}")
    return readings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="myraytracer_tpu_torch.mxu_probe", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (the kernels), or cpu (the plain "
                   "versions, for tests)")
    args = p.parse_args(argv)
    run(args.device, out=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
