"""Russian roulette against none at equal samples: the equal-RMSE wall clock.

    python -m myraytracer_tpu_torch.rr_bench

The counterpart of the JAX package's ``tools/rr_bench.py``. For each scene
it renders a fixed budget with ``rr`` 0 and ``rr`` N and reports the best
wall clock of RR_REPS calls (each ended by a host read), the segments
traced and the RMSE against a high-spp reference: RR pays where it cuts the
wall clock by more than its added noise costs in samples,
``quality.rr_win`` = (t_0 / t_rr) (rmse_0 / rmse_rr)^2 above 1. A line a
run, then one JSON line of every scene.

Env knobs (the JAX tool's): RR_SCENES ("final,cornell"), RR_N (5), RR_SPP
(128), RR_WH ("1200x800"), RR_DEPTH (50), RR_REF_SPP (1500), RR_REPS (2);
and RR_BACKEND (``cuda``, the default, or ``torch``; ``pallas`` and
``jnp`` name them too).
"""

from __future__ import annotations

import json
import os
import sys

from myraytracer_tpu_torch import quality


def settings(env) -> dict:
    w, h = (int(x) for x in env.get("RR_WH", "1200x800").split("x"))
    return dict(
        scenes=env.get("RR_SCENES", "final,cornell").split(","),
        rr=int(env.get("RR_N", "5")),
        spp=int(env.get("RR_SPP", "128")),
        width=w, height=h,
        depth=int(env.get("RR_DEPTH", "50")),
        ref_spp=int(env.get("RR_REF_SPP", "1500")),
        reps=int(env.get("RR_REPS", "2")),
        backend=quality.backend_name(env.get("RR_BACKEND", "cuda")),
    )


def run(s: dict) -> dict:
    w, h, depth, spp, backend = s["width"], s["height"], s["depth"], s["spp"], s["backend"]
    scenes = []
    for name in s["scenes"]:
        world, scene = quality.setup(name, backend, w, h)
        ref, _, _ = quality.frame(
            quality.renderer(world, backend, w, h, s["ref_spp"], depth), scene, 99)
        rows = {}
        for rr in (0, s["rr"]):
            r = quality.renderer(world, backend, w, h, spp, depth, rr=rr)
            img, _, _ = quality.frame(r, scene, 0)  # warm; its image is scored
            best_t, segs = 1e30, 0.0
            for i in range(s["reps"]):
                _, segs, t = quality.frame(r, scene, 0, (i + 1) * spp)
                best_t = min(best_t, t)
            rows[rr] = dict(rr=rr, t_s=best_t, segments=segs, rmse=quality.rmse(img, ref))
            print(f"{name} rr={rr}: {best_t:6.2f}s  {segs / 1e6:8.1f}M segs  "
                  f"{segs / best_t / 1e6:6.1f} Mrays/s  rmse {rows[rr]['rmse']:.5f}", flush=True)
        t0, e0 = rows[0]["t_s"], rows[0]["rmse"]
        t1, e1 = rows[s["rr"]]["t_s"], rows[s["rr"]]["rmse"]
        win = quality.rr_win(t0, t1, e0, e1)
        print(f"{name}: rr={s['rr']} equal-RMSE wall-clock win = {win:.2f}x  (speed "
              f"{t0 / t1:.2f}x, rmse ratio {e1 / e0:.3f} -> sample-cost {(e1 / e0) ** 2:.2f}x)",
              flush=True)
        scenes.append({"scene": name, "rows": list(rows.values()), "win": win})
    return {"tool": "rr_bench", "size": [w, h], "depth": depth, "spp": spp,
            "backend": backend, "ref_spp": s["ref_spp"], "scenes": scenes}


def main(env=None) -> int:
    out = run(settings(os.environ if env is None else env))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
