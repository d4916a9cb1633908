"""Kernel-cost microbenchmarks on one GPU.

    python -m myraytracer_tpu_torch.microbench

The counterpart of the JAX package's ``tools/microbench.py``: what the
primitive parts of one bounce of the trace kernels cost on this card. Each
probe runs ``iters`` trips of one body over a tile of 2048 lanes in a
hand-written CUDA kernel (``kernels/probes.py``, ``csrc/probes.cu``), at
two trip counts whose difference cancels the launch, timed in turns with
CUDA events. What each probe really measures:

* ``fma-chain-64op`` and ``-fused``: 64 dependent FP32 instructions a trip
  (multiply, add and subtract 32 times; the fused chain's multiply-add is
  one instruction), so ns/op is the latency of a warp's dependent
  instruction while the SM's other warps fill the pipeline;
* ``empty-loop``: one dependent FP32 add of a run-time zero and the loop's
  own compare and branch (with no effect at all the compiler deletes the
  loop, and the probe would time nothing);
* ``smem-16reads``, ``smem-32reads``: 16 or 32 dependent adds, each of
  one scalar of the launch's table read straight from the constant bank
  (the table is a kernel parameter, the counterpart of the tool's scalar
  prefetch into SMEM), then one multiply: the chain, with a read a trip
  and no load instruction;
* ``any+cond-gate-warp``, ``-block``: a vote and a branch around one
  multiply: ``__any_sync`` over a warp, ``__syncthreads_or`` over the
  block of 256 threads;
* ``hit-sweep-16sph`` and ``-merged``: the sphere test of the trace
  kernels' sweep on 16 spheres read from the constant bank, with a running
  minimum, or with strict < and the winner's 11 record values (carried as
  an index, gathered once a trip from shared memory); rooted on
  ``sqrtf``'s fast path alone, a lane whose trip meets a discriminant off
  its range (a graze's +0) taking that trip and the rest with IEEE
  ``sqrtf``;
* ``carry-1-baseline``: one multiply and one add.

Two shapes: one tile (8 blocks of 256 threads on 8 of the card's 132 SMs:
latency, and one SM's rate at 8 warps) and ``CARD_TILES`` tiles, which
fill the card. One line a probe and shape, after the card's name, power
limit and SM clock. It needs a CUDA GPU and raises without one; ``device=
"cpu"`` runs the plain PyTorch versions on the host clock instead (for
tests: no such number is a device time).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch

from myraytracer_tpu_torch import mxu_probe, sweep
from myraytracer_tpu_torch.kernels import probes

# Trips of the shorter launch: some milliseconds a launch on an H100.
BASE_ITERS = {
    "fma-chain-64op": 20_000,
    "fma-chain-64op-fused": 20_000,
    "empty-loop": 1_000_000,
    "smem-16reads": 50_000,
    "any+cond-gate-warp": 400_000,
    "any+cond-gate-block": 100_000,
    "hit-sweep-16sph": 5_000,
    "carry-1-baseline": 1_000_000,
    "hit-sweep-16sph-merged": 5_000,
    "smem-32reads": 25_000,
}


def bound_terms(name: str, tiles: int, sm_hz: float) -> Dict[str, float]:
    """The three least ns a trip of probe ``name`` on ``tiles`` tiles:
    its FP32 operations over the peak this grid can reach
    (``"operations"``, the contract's bound); its FP32 instructions
    (``MicroBody.issues``, one an operation under -fmad=false) at
    ``mxu_probe.SM_LANES`` a cycle on each SM the grid occupies at ``sm_hz``
    (``"issue"``); and its longest dependent chain at
    ``probes.FP32_LATENCY_CYCLES`` a link at ``sm_hz`` (``"latency"``): a
    lane's chain cannot finish sooner however few operations it holds."""
    body = probes.MICRO_BODIES[name]
    share = probes.fp32_peak_share(tiles * probes.R // probes.BLOCK)
    lanes = probes.R * tiles
    return {
        "operations": body.flops * lanes / (probes.PEAK_FP32 * share) * 1e9,
        "issue": body.issues * lanes / (mxu_probe.SM_LANES * sm_hz * probes.SMS * share) * 1e9,
        "latency": body.chain * probes.FP32_LATENCY_CYCLES / sm_hz * 1e9,
    }


def bound_ns_per_iter(name: str, tiles: int, sm_hz: float):
    """The least ns a trip of probe ``name`` can take on ``tiles`` tiles,
    and what bounds it: the largest of ``bound_terms``."""
    terms = bound_terms(name, tiles, sm_hz)
    by = max(terms, key=terms.get)
    return terms[by], by


def probe(name: str, tiles: int, device: torch.device, iters: Optional[int] = None,
          sm_hz: float = probes.SM_CLOCK_MAX_HZ) -> dict:
    """One probe at one shape: ns a trip, the shorter launch's ms, ns an
    operation, and the least ns a trip the card allows this grid at the SM
    clock ``sm_hz`` (``bound_ns_per_iter``, bound by ``bound_by``)."""
    body = probes.MICRO_BODIES[name]
    base = int(iters or BASE_ITERS[name])
    per_iter, t_lo = probes.time_pair(
        lambda n: probes.micro(name, n, tiles, device), base, device)
    bound, by = bound_ns_per_iter(name, tiles, sm_hz)
    return {
        "probe": name, "tiles": tiles, "blocks": tiles * probes.R // probes.BLOCK, "iters": base,
        "ns_per_iter": per_iter * 1e9, "fixed_ms": t_lo * 1e3,
        "ns_per_op": per_iter * 1e9 / body.ops if body.ops else None,
        "flops_per_iter": body.flops * probes.R * tiles, "chain": body.chain,
        "bound_ns_per_iter": bound, "bound_by": by, "sm_hz": sm_hz,
        "issues_per_iter": body.issues, "bounds_ns_per_iter": bound_terms(name, tiles, sm_hz),
    }


def line(r: dict) -> str:
    """A probe's reading, as ``tools/microbench.py`` prints it."""
    msg = f"{r['probe']}: {r['ns_per_iter']:.1f} ns/iter (fixed {r['fixed_ms']:.1f} ms)"
    if r["ns_per_op"] is not None:
        msg += f", {r['ns_per_op']:.2f} ns/op"
    terms = ", ".join(f"{k} {v:.3f}" for k, v in r["bounds_ns_per_iter"].items())
    return msg + (f" [{r['tiles']} tile(s), bound {r['bound_ns_per_iter']:.3f} ns/iter by "
                  f"{r['bound_by']} ({terms})]")


def run(device="cuda", tiles=(1, probes.CARD_TILES), iters: Optional[int] = None,
        out=print) -> List[dict]:
    """Every probe at every shape of ``tiles``, one printed line each;
    returns the readings. ``iters`` overrides every probe's trip count. The
    latency bound takes the SM clock read with the card under load
    (``probes.loaded_clock`` after launches of the unfused chain on a full
    card); on the CPU, the card's highest, ``probes.SM_CLOCK_MAX_HZ``."""
    device = torch.device(device)
    sm_hz = probes.SM_CLOCK_MAX_HZ
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("microbench needs a CUDA GPU, and torch.cuda.is_available() "
                               "is False")
        idle, clock = probes.loaded_clock(lambda: probes.micro(
            "fma-chain-64op", BASE_ITERS["fma-chain-64op"], probes.CARD_TILES, device), device)
        sm_hz = probes.clock_hz(clock)
        out(f"{sweep.card()} | SM clock {idle} idle, {clock} under load")
    else:
        out("cpu: the plain PyTorch versions on the host clock (no device time)")
    readings = []
    for n_tiles in tiles:
        blocks = n_tiles * probes.R // probes.BLOCK
        out(f"shape: {n_tiles} tile(s) of {probes.R} lanes = {blocks} blocks of {probes.BLOCK} "
            f"threads on {min(blocks, probes.SMS)} of {probes.SMS} SMs")
        for name in probes.MICRO_BODIES:
            readings.append(probe(name, n_tiles, device, iters, sm_hz))
            out(line(readings[-1]))
    if device.type == "cuda":
        out(f"SM clock after: {probes.sm_clock()}")
    return readings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="myraytracer_tpu_torch.microbench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (the kernels), or cpu (the plain "
                   "versions, for tests)")
    args = p.parse_args(argv)
    run(args.device, out=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
