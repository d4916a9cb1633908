"""The denoiser's worth in samples: RMSE against a high-spp reference, raw
and filtered.

    python -m myraytracer_tpu_torch.denoise_bench

The counterpart of the JAX package's ``tools/denoise_bench.py``. One
session accumulates the scene; its framebuffer is kept at several low frame
counts and at the reference's (the low-spp images are prefixes of the
reference's stream, so the only variable is the sample count). For each cut
it reports the RMSE of the raw and the filtered framebuffer against the
reference, linear and in display space (``quality.disp``), and the
filter's worth in samples, ``quality.denoise_efficiency`` = (rmse_raw /
rmse_dn)^2 by the 1/sqrt(n) law, with the filter's seconds (a host read
ending each call) and its worth in wall clock against rendering those
samples (``quality.denoise_wall_clock``, from the display-space worth and
the median seconds of a step); then what ``--denoise auto`` picks at each
cut (``noise_iterations(estimate_noise(raw))``) and its display-space and
wall-clock worth;
with DB_SWEEP=1, a grid of the three edge-stopping sigmas. Tables on
stderr, one JSON line on stdout.

Env knobs (the JAX tool's): DB_SCENE (three-sphere), DB_W/DB_H (320x180),
DB_SPP (spp a frame, 4), DB_DEPTH (16), DB_REF_FRAMES (512), DB_FRAMES
(comma list of low frame counts, "1,2,4,8,16"), DB_BACKEND (``cuda``, the
default, or ``torch``; ``pallas`` and ``jnp`` name them too), DB_SWEEP,
DB_ITERS (comma list of iteration counts, "5").
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from myraytracer_tpu_torch import quality
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.render.denoise import (
    DEFAULT_SIGMA_COLOR, DEFAULT_SIGMA_DEPTH, DEFAULT_SIGMA_NORMAL, Denoiser, atrous_denoise,
    estimate_noise, noise_iterations,
)
from myraytracer_tpu_torch.render.dispatch import make_session
from myraytracer_tpu_torch.scene.presets import get_scene

# Steps timed for the seconds a sample costs.
STEP_REPS = 5

def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settings(env) -> dict:
    return dict(
        scene=env.get("DB_SCENE", "three-sphere"),
        width=int(env.get("DB_W", "320")),
        height=int(env.get("DB_H", "180")),
        spp=int(env.get("DB_SPP", "4")),
        depth=int(env.get("DB_DEPTH", "16")),
        ref_frames=int(env.get("DB_REF_FRAMES", "512")),
        frames=[int(x) for x in env.get("DB_FRAMES", "1,2,4,8,16").split(",")],
        backend=quality.backend_name(env.get("DB_BACKEND") or "cuda"),
        sweep=env.get("DB_SWEEP", "0") == "1",
        iters=[int(x) for x in env.get("DB_ITERS", "5").split(",")],
    )


def run(s: dict) -> dict:
    w, h, spp = s["width"], s["height"], s["spp"]
    world = get_scene(s["scene"], seed=0)
    # One frame a step, so that each cut is a frame count.
    session = make_session(world, RenderConfig(
        width=w, height=h, samples_per_frame=spp, ray_depth=s["depth"], backend=s["backend"],
        frame_batch=1))
    log(f"denoise_bench scene={s['scene']} {w}x{h} spp/frame={spp} depth={s['depth']} "
        f"backend={session.backend_resolved} ref={s['ref_frames'] * spp} spp")

    # One accumulation stream; the framebuffer kept at each cut.
    snaps, done = {}, 0
    for n in sorted(set(s["frames"] + [s["ref_frames"]])):
        while done < n:
            session.step()
            done += 1
        snaps[n] = session.framebuffer.cpu().numpy()
    ref = snaps[s["ref_frames"]]
    cuts = [n for n in s["frames"] if n != s["ref_frames"]]

    # The seconds a sample costs: the median of a few more steps, each
    # ended by a host read (the cuts are taken, so these samples score
    # nothing).
    steps = []
    for _ in range(STEP_REPS):
        t0 = time.perf_counter()
        session.step()
        float(session.framebuffer[0, 0, 0])
        steps.append(time.perf_counter() - t0)
    t_spp = sorted(steps)[len(steps) // 2] / spp
    log(f"one step of {spp} spp: {t_spp * spp * 1e3:.3f} ms (median of {STEP_REPS})")

    dn = Denoiser(world, w, h, iterations=max(s["iters"]), device=session.device)
    albedo, normal, depth = dn.features(session.scene.cam)

    def filtered(raw, iters, *sigmas):
        t0 = time.perf_counter()
        out = atrous_denoise(torch.from_numpy(raw).to(session.device), albedo, normal, depth,
                             iters, *(sigmas or dn.sigmas)).cpu().numpy()
        return out, time.perf_counter() - t0

    # An untimed pass: the first call's start-up stays out of filter_s.
    filtered(ref, max(s["iters"]))
    ref_d = quality.disp(ref)
    rows = []
    for iters in s["iters"]:
        log(f"{'spp':>6} {'rmse raw':>10} {'rmse dn':>10} {'gain':>6} {'eff x':>6} "
            f"{'disp raw':>9} {'disp dn':>9} {'deff':>6} {'wall x':>6}   (iters={iters})")
        for n in cuts:
            raw = snaps[n]
            out, dt = filtered(raw, iters)
            r_raw, r_dn = quality.rmse(raw, ref), quality.rmse(out, ref)
            d_raw = quality.rmse(quality.disp(raw), ref_d)
            d_dn = quality.rmse(quality.disp(out), ref_d)
            eff = quality.denoise_efficiency(r_raw, r_dn)
            deff = quality.denoise_efficiency(d_raw, d_dn)
            wall = quality.denoise_wall_clock(n * spp, deff, t_spp, dt)
            rows.append({"iters": iters, "spp": n * spp, "rmse_raw": r_raw, "rmse_dn": r_dn,
                         "efficiency_x": eff, "rmse_raw_disp": d_raw, "rmse_dn_disp": d_dn,
                         "efficiency_disp_x": deff, "filter_s": dt, "wall_clock_x": wall})
            log(f"{n * spp:>6} {r_raw:>10.5f} {r_dn:>10.5f} {r_raw / r_dn:>6.2f} {eff:>6.2f} "
                f"{d_raw:>9.5f} {d_dn:>9.5f} {deff:>6.2f} {wall:>6.2f}")

    # What --denoise auto picks at each cut, against the same reference.
    auto_rows = []
    log("auto (noise-driven) picks:")
    for n in cuts:
        raw = snaps[n]
        noise = estimate_noise(raw)
        k = noise_iterations(noise)
        out, dt = (raw, 0.0) if k == 0 else filtered(raw, k)
        d_raw = quality.rmse(quality.disp(raw), ref_d)
        d_dn = quality.rmse(quality.disp(out), ref_d)
        deff = 1.0 if k == 0 else quality.denoise_efficiency(d_raw, d_dn)
        wall = quality.denoise_wall_clock(n * spp, deff, t_spp, dt)
        auto_rows.append({"spp": n * spp, "noise": noise, "iters": k,
                          "efficiency_disp_x": deff, "filter_s": dt, "wall_clock_x": wall})
        log(f"  spp={n * spp:>4} noise={noise:.5f} -> k={k} disp-eff={deff:.2f} "
            f"wall-clock {wall:.2f}x")

    best = None
    if s["sweep"]:
        mid = cuts[len(cuts) // 2]
        raw = snaps[mid]
        log(f"sweep at {mid * spp} spp (raw {quality.rmse(raw, ref):.5f})")
        for sc in (1.0, 2.0, 4.0, 8.0, 16.0):
            for sn in (0.15, 0.35, 0.8):
                for sz in (0.03, 0.07, 0.15):
                    r = quality.rmse(filtered(raw, s["iters"][0], sc, sn, sz)[0], ref)
                    if best is None or r < best[0]:
                        best = (r, sc, sn, sz)
                    log(f"  sc={sc:<4} sn={sn:<4} sz={sz:<4} rmse={r:.5f}")
        log(f"best: rmse={best[0]:.5f} sigma_color={best[1]} sigma_normal={best[2]} "
            f"sigma_depth={best[3]} (defaults {DEFAULT_SIGMA_COLOR}/{DEFAULT_SIGMA_NORMAL}/"
            f"{DEFAULT_SIGMA_DEPTH})")

    return {"tool": "denoise_bench", "scene": s["scene"], "size": [w, h], "depth": s["depth"],
            "backend": session.backend_resolved, "ref_spp": s["ref_frames"] * spp,
            "t_spp_s": t_spp, "auto_rows": auto_rows, "rows": rows, "sweep_best": best}


def main(env=None) -> int:
    out = run(settings(os.environ if env is None else env))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
