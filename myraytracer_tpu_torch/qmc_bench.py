"""QMC camera sampling against threefry at equal spp: quality per sample.

    python -m myraytracer_tpu_torch.qmc_bench

The counterpart of the JAX package's ``tools/qmc_bench.py``. For each
scene it measures the RMSE against a converged reference of the default
threefry camera stream and the Owen-scrambled Sobol stream (``qmc``) at
the same sample counts, and fits the uniform spp that would reach the QMC
RMSE (``quality.equal_quality_spp``). QMC restratifies only the camera
dimensions (jitter and lens), so its win lies at edges, in defocus blur
and on smooth backgrounds. With QB_TIME, each variant's frame is timed
too (warmed, a host read ending the call). A line a spp, then one JSON line
of every row.

Env knobs (the JAX tool's): QB_W, QB_H, QB_DEPTH, QB_SCENE (comma list),
QB_SPP (comma list), QB_REF_SPP, QB_BACKEND (``cuda``, the default, or
``torch``; ``pallas`` and ``jnp`` name them too), QB_TIME (1 = time one
frame a variant).
"""

from __future__ import annotations

import json
import os
import sys

from myraytracer_tpu_torch import quality


def settings(env) -> dict:
    return dict(
        width=int(env.get("QB_W", 480)),
        height=int(env.get("QB_H", 270)),
        depth=int(env.get("QB_DEPTH", 50)),
        scenes=env.get("QB_SCENE", "defocus,final").split(","),
        spps=[int(x) for x in env.get("QB_SPP", "4,16,64").split(",")],
        ref_spp=int(env.get("QB_REF_SPP", 4000)),
        backend=quality.backend_name(env.get("QB_BACKEND", "cuda")),
        time=env.get("QB_TIME", "1") not in ("0", ""),
    )


def run(s: dict) -> dict:
    w, h, depth, backend = s["width"], s["height"], s["depth"], s["backend"]
    scenes = []
    for name in s["scenes"]:
        world, scene = quality.setup(name, backend, w, h)
        print(f"\n== scene={name} {w}x{h} depth={depth} backend={backend} "
              f"ref={s['ref_spp']} spp ==", flush=True)
        ref, _, t_ref = quality.frame(
            quality.renderer(world, backend, w, h, s["ref_spp"], depth), scene, 99)
        print(f"reference: {t_ref:.1f}s", flush=True)

        rows = []
        for spp in s["spps"]:
            imgs, times = {}, {}
            for label, q in (("uniform", False), ("qmc", True)):
                r = quality.renderer(world, backend, w, h, spp, depth, qmc=q)
                imgs[label], _, _ = quality.frame(r, scene, 0)  # warm
                if s["time"]:
                    imgs[label], _, times[label] = quality.frame(r, scene, 0)
            e_u, e_q = quality.rmse(imgs["uniform"], ref), quality.rmse(imgs["qmc"], ref)
            rows.append(dict(spp=spp, rmse_uniform=e_u, rmse_qmc=e_q,
                             t_uniform_s=times.get("uniform"), t_qmc_s=times.get("qmc"),
                             uniform_spp_needed=quality.equal_quality_spp(spp, e_u, e_q)))
            extra = ""
            if s["time"]:
                extra = f" | {1e3 * times['uniform']:.0f} vs {1e3 * times['qmc']:.0f} ms/frame"
            print(f"spp {spp:4d} | uniform rmse {e_u:.5f} | qmc rmse {e_q:.5f} | ratio "
                  f"{e_u / max(e_q, 1e-12):.2f}x{extra}", flush=True)

        print("equal-quality estimate (uniform spp to reach qmc's rmse):")
        for r in rows:
            print(f"  qmc at {r['spp']:4d} spp matches uniform ~{r['uniform_spp_needed']:7.1f} "
                  f"spp ({r['uniform_spp_needed'] / r['spp']:.2f}x sample efficiency)",
                  flush=True)
        scenes.append({"scene": name, "rows": rows})
    return {"tool": "qmc_bench", "size": [w, h], "depth": depth, "backend": backend,
            "ref_spp": s["ref_spp"], "scenes": scenes}


def main(env=None) -> int:
    out = run(settings(os.environ if env is None else env))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
