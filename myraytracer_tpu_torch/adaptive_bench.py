"""Adaptive against uniform sampling at equal budgets: quality and wall clock.

    python -m myraytracer_tpu_torch.adaptive_bench

The counterpart of the JAX package's ``tools/adaptive_bench.py``. On one
scene (default: final at 1200x800, depth 50) it measures the RMSE against
a high-spp reference of

  * the uniform estimator at sample budgets B_i (one launch of B_i spp),
  * the adaptive session (``render/adaptive.py``) at the same budgets,

with the wall clock of each (the adaptive one after its bootstrap, whose
samples count toward the budget; its seconds are reported beside it; a
throwaway session's bootstrap and round warm the adaptive path first), and
fits the uniform budget that would reach each adaptive RMSE
(``quality.equal_quality_spp``). A line a budget, then one JSON line of
every row.

Env knobs (the JAX tool's): AB_W, AB_H, AB_DEPTH, AB_SPP (a round's spp),
AB_FB (windows a round: 1 by default, 0 = the port's auto), AB_SCENE,
AB_REF_SPP, AB_BUDGETS (comma list in uniform frames of AB_SPP samples),
AB_NSEL (blocks a round, 0 = a quarter of the grid); and AB_BACKEND
(``cuda``, the default, or ``torch``; ``pallas`` and ``jnp`` name them
too). The reference renders every run, on the backend measured.
"""

from __future__ import annotations

import json
import os
import sys
import time

from myraytracer_tpu_torch import quality
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.kernels import trace
from myraytracer_tpu_torch.render.adaptive import AdaptiveSession


def settings(env) -> dict:
    return dict(
        width=int(env.get("AB_W", 1200)),
        height=int(env.get("AB_H", 800)),
        depth=int(env.get("AB_DEPTH", 50)),
        spp=int(env.get("AB_SPP", 8)),
        scene=env.get("AB_SCENE", "final"),
        ref_spp=int(env.get("AB_REF_SPP", 2000)),
        budgets=[int(b) for b in env.get("AB_BUDGETS", "4,8,16,32").split(",")],
        n_sel=int(env.get("AB_NSEL", 0)),
        frame_batch=int(env.get("AB_FB", 1)),
        backend=quality.backend_name(env.get("AB_BACKEND", "cuda")),
    )


def run(s: dict) -> dict:
    w, h, depth, spp, backend = s["width"], s["height"], s["depth"], s["spp"], s["backend"]
    world, scene = quality.setup(s["scene"], backend, w, h)
    print(f"scene={s['scene']} {w}x{h} depth={depth} spp/round={spp} budgets={s['budgets']} "
          f"(x{spp} spp units) backend={backend}", flush=True)
    ref, _, t_ref = quality.frame(
        quality.renderer(world, backend, w, h, s["ref_spp"], depth), scene, 99)
    print(f"reference {s['ref_spp']} spp: {t_ref:.1f}s", flush=True)

    def session(budget):
        # max_frames: the budget bounds auto windows, as the CLI's --frames.
        cfg = RenderConfig(width=w, height=h, samples_per_frame=spp, ray_depth=depth, seed=0,
                           backend=backend, frame_batch=s["frame_batch"], max_frames=budget)
        return AdaptiveSession(world, cfg, n_sel=s["n_sel"])

    # A throwaway session's bootstrap and round warm the adaptive kernel
    # and the score pass, as the uniform arm's untimed call warms its own.
    warm = session(s["budgets"][0])
    warm.bootstrap()
    warm.step()
    warm.framebuffer.cpu()

    rows = []
    for budget in s["budgets"]:
        total = budget * spp
        # Uniform at the budget: one call of total spp, timed after a warm one.
        uni = quality.renderer(world, backend, w, h, total, depth)
        quality.frame(uni, scene, 0)
        img_u, _, t_u = quality.frame(uni, scene, 0)
        e_u = quality.rmse(img_u, ref)

        sess = session(budget)
        a0 = trace.ADAPTIVE.launches
        t0 = time.perf_counter()
        sess.bootstrap()
        sess.framebuffer.cpu()  # waits for the bootstrap: it stays out of t_a
        t_boot = time.perf_counter() - t0
        r0 = sess.rounds
        t0 = time.perf_counter()
        fb = sess.run_budget(budget).cpu().numpy()  # the host read forces every round
        t_a = time.perf_counter() - t0
        n_rounds = sess.rounds - r0
        e_a = quality.rmse(fb, ref)
        spent = sess.samples_spent / (w * h)
        smap = sess.spp_map
        need = quality.equal_quality_spp(total, e_u, e_a)
        row = dict(
            spp=total, rmse_uniform=e_u, t_uniform_s=t_u, rmse_adaptive=e_a,
            t_adaptive_s=t_a, t_bootstrap_s=t_boot, rounds=n_rounds, windows=sess.windows,
            calls=sess.sub_rounds // sess.windows, spp_spent=spent,
            block_spp=[int(smap.min()), int(smap.max())], uniform_spp_needed=need,
            # Uniform's seconds for that many samples over adaptive's, the
            # bootstrap included: above 1, adaptive reaches its RMSE sooner.
            wall_clock_x=t_u * need / total / (t_a + t_boot),
            adaptive_launches=(trace.ADAPTIVE.launches - a0) if backend == "cuda" else None,
        )
        rows.append(row)
        print(f"budget {total:4d} spp | uniform rmse {e_u:.5f} ({t_u:6.2f}s) | adaptive rmse "
              f"{e_a:.5f} ({t_a:6.2f}s post-bootstrap, {t_boot:.2f}s bootstrap, {n_rounds} "
              f"rounds = {1e3 * t_a / max(n_rounds, 1):.0f} ms/round, {spent:6.1f} spp spent, "
              f"block spp {smap.min()}..{smap.max()})", flush=True)

    print("\nequal-quality estimate (uniform spp needed for adaptive's rmse,")
    print("via rmse*sqrt(n)=const fit per uniform row):")
    for r in rows:
        print(f"  adaptive at {r['spp_spent']:6.1f} spp matches uniform "
              f"~{r['uniform_spp_needed']:7.1f} spp "
              f"({r['uniform_spp_needed'] / max(r['spp_spent'], 1e-9):.2f}x); "
              f"wall clock {r['wall_clock_x']:.2f}x", flush=True)
    return {"tool": "adaptive_bench", "scene": s["scene"], "size": [w, h], "depth": depth,
            "backend": backend, "ref_spp": s["ref_spp"],
            "warm_calls": warm.sub_rounds // warm.windows, "rows": rows}


def main(env=None) -> int:
    out = run(settings(os.environ if env is None else env))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
