"""The cost of a per-bounce ray sort on one CUDA GPU: a key sort and a gather.

    python -m myraytracer_tpu_torch.sort_probe

The counterpart of the JAX package's ``tools/sort_probe.py``. A wavefront
renderer that sorts its rays (by material, say) pays, each bounce round,
one key sort and a gather of the whole ray state. This probe prices that
at the headline frame's ray count (1200x800 = 960,000), so the design can
be accepted or rejected on numbers, as ``mxu_probe`` did for the
tensor-core hit.

Method, the JAX tool's: a step derives a pseudo-random u32 key from the
state (``keys_of``: so that steps chain on the device with no host
traffic), sorts the keys stably (``torch.argsort(stable=True)``, as
``jnp.argsort`` is) and gathers the SORT_PAYLOAD f32 arrays by the
permutation (``step_sorted``); the baseline step does the same key
arithmetic and a permutation-free update of the same shapes
(``step_base``). SORT_ITERS steps are chained, one value is read to the
host, and the two chains are timed in turns over 3 rounds; the difference
of their medians is the sort and gather a round. Both are library calls:
this probes a design, it ports no kernel.

Prints the card's name and power limit, the JAX tool's lines, and last one
JSON line of the numbers. Without a GPU it exits non-zero and prints
nothing on stdout.

Env knobs (the JAX tool's): SORT_N (960000), SORT_PAYLOAD (15), SORT_ITERS
(30).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from myraytracer_tpu_torch import quality

M32 = 0xFFFFFFFF
GOLDEN = 2654435761  # the key mix's odd multiplier
ROUNDS = 3


def settings(env) -> dict:
    return dict(n=int(env.get("SORT_N", "960000")), payload=int(env.get("SORT_PAYLOAD", "15")),
                iters=int(env.get("SORT_ITERS", "30")))


def initial_state(n: int, payload: int, device) -> list:
    """The JAX tool's state: ``arange(n) * (0.37 + 0.11 i)`` in f32."""
    return [torch.arange(n, dtype=torch.float32, device=device) * (0.37 + 0.11 * i)
            for i in range(payload)]


def keys_of(state) -> torch.Tensor:
    """The JAX tool's u32 key of a state, ``k * 2654435761 ^ (k >> 13)`` on
    the bits of its first row, as int64 values below 2^32 (torch's uint32
    has few ops). The product is taken in two 16-bit halves of the
    multiplier, so no int64 product overflows."""
    k = state[0].view(torch.int32).to(torch.int64) & M32
    lo = k * (GOLDEN & 0xFFFF)
    hi = ((k * (GOLDEN >> 16)) & 0xFFFF) << 16
    return ((lo + hi) & M32) ^ (k >> 13)


def permutation(state) -> torch.Tensor:
    """The stable sort of the keys: on equal keys the lower index first."""
    return torch.argsort(keys_of(state), stable=True)


def step_sorted(state) -> list:
    perm = permutation(state)
    return [s[perm] for s in state]


def step_base(state) -> list:
    # Same key math, a permutation-free update of matching output shapes.
    kf = keys_of(state).to(torch.float32) * 1e-30
    return [s + kf for s in state]


def chain_ms(step, state, iters: int) -> float:
    """ms a step of ``iters`` chained steps, after a warm-up step, from a
    fresh copy of ``state``; ended by reading one value to the host."""
    out = [s.clone() for s in state]
    out = step(out)  # warm
    out[0][:4].cpu()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(out)
    out[0][:4].cpu()  # force the chain
    return (time.perf_counter() - t0) / iters * 1e3


def run(s: dict, out=print) -> dict:
    n, npay, iters = s["n"], s["payload"], s["iters"]
    state = initial_state(n, npay, "cuda")
    # Interleave rounds to ride out drift.
    ms_sorted, ms_base = [], []
    for _ in range(ROUNDS):
        ms_sorted.append(chain_ms(step_sorted, state, iters))
        ms_base.append(chain_ms(step_base, state, iters))
    s_med, b_med = sorted(ms_sorted)[1], sorted(ms_base)[1]
    out(f"n={n} payload={npay} iters={iters}")
    out(f"sorted chain : {ms_sorted} -> median {s_med:.2f} ms/iter")
    out(f"baseline     : {ms_base} -> median {b_med:.2f} ms/iter")
    out(f"sort+gather  : {s_med - b_med:.2f} ms per round")
    return {"tool": "sort_probe", "n": n, "payload": npay, "iters": iters,
            "sorted_ms": ms_sorted, "base_ms": ms_base, "sorted_median_ms": s_med,
            "base_median_ms": b_med, "sort_gather_ms": s_med - b_med}


def main(env=None) -> int:
    if quality.card_missing("sort_probe"):
        return 2
    s = settings(os.environ if env is None else env)
    print(quality.device_line("cuda"), flush=True)
    res = run(s, out=lambda line: print(line, flush=True))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
