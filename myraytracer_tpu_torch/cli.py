"""Command-line renderer for the PyTorch port.

The reference's native runner (``native-runner/src/main.rs:4-43``): the
same five flags with the same defaults and the same 0-means-derive size
rule, headless — ``--frames`` bounds the progressive loop and the result is
written to ``--out``. Extensions: scene, seed, backend, output transfer,
checkpoint and resume, frame batching (``--frame-batch``), adaptive
sampling (``--adaptive``), the estimator's modes (``--nee``, ``--rr N``,
``--qmc``), the output denoiser (``--denoise [N|auto]``) and feature images
(``--aov``), and a log line per step (frame, accumulated spp, ms, Mrays/s =
traced ray segments per second, shadow rays included).

Sphere scenes, triangle meshes (``mesh``, ``mesh:N``), large sphere fields
(``spheres:N``), the emissive scenes (``light``, ``cornell``) and the
textured ones (``texture``: checker and marble; ``earth``: an image
texture) render on both backends; the CUDA kernel sweeps them behind the
JAX kernel's chunk gates and evaluates textures in the kernel. The
denoiser and the feature pass run on the session's device: on the GPU with
``--backend cuda``. The JAX package's other flags (serving, interactive
orbits, OBJ input, sharding, ...) are not in the port yet.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pathlib
import sys
import time

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.output.image import parse_gamma, write_image
from myraytracer_tpu_torch.scene.presets import get_scene

log = logging.getLogger("myraytracer_tpu_torch")

_AOV_NAMES = ("albedo", "normal", "depth")


def _denoise_value(s: str):
    """--denoise value: an iteration count, or 'auto' (noise-scheduled,
    render/denoise.py). argparse type callable."""
    if s.strip().lower() == "auto":
        return "auto"
    try:
        n = int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an iteration count or 'auto', got {s!r}"
        )
    if n < 0:
        raise argparse.ArgumentTypeError("iteration count must be >= 0 (or 'auto')")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="myraytracer_tpu_torch",
        description="Progressive path tracer (PyTorch + CUDA)",
    )
    # Reference flags (native-runner/src/main.rs:20-31), same defaults.
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--samples-per-frame", type=int, default=1)
    p.add_argument("--ray-depth", type=int, default=50)
    p.add_argument("--max-framebuffer-weight", type=float, default=1.0)
    # Extensions.
    p.add_argument("--frames", type=int, default=1,
                   help="progressive frames to run")
    p.add_argument(
        "--scene", default="reference", metavar="NAME",
        help="built-in scene: reference, lambertian, three-sphere, defocus, "
        "final, mesh (triangle meshes), spheres:N (final-scene-style 2Nx2N "
        "sphere field, e.g. spheres:100 ~ 40k spheres) or mesh:N (icosphere "
        "subdivisions, ~20*4^N triangles, e.g. mesh:5 ~ 25.6k), light and "
        "cornell (emissive: lit only by DiffuseLight), texture (checker and "
        "marble) and earth (an image texture); all run on --backend cuda and "
        "torch",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--nee", action="store_true",
        help="next-event estimation with MIS: one shadow ray toward a sampled "
        "light per diffuse bounce (unbiased; a no-op without lights)",
    )
    p.add_argument(
        "--rr", type=int, default=0, metavar="N",
        help="Russian-roulette termination from bounce N on (survival p = "
        "clamp(max throughput, 0.05, 0.95), 1/p compensation; unbiased)",
    )
    p.add_argument(
        "--qmc", action="store_true",
        help="low-discrepancy camera sampling: Owen-scrambled Sobol sub-pixel "
        "jitter and lens draws (deterministic, like the default stream)",
    )
    p.add_argument(
        "--backend", choices=["auto", "cuda", "torch"], default="auto",
        help="cuda: the CUDA kernel on the GPU (never falls back to the CPU); "
        "torch: the plain PyTorch integrator on the CPU; auto: cuda when a "
        "GPU is present, else torch",
    )
    p.add_argument(
        "--gamma", type=parse_gamma, default=2.0, metavar="G|srgb|aces",
        help="output transfer: float exponent (2.0 = RTiOW sqrt), 'srgb' or "
        "'aces'",
    )
    p.add_argument(
        "--out", default="out.png",
        help=".png/.ppm (u8, --gamma transfer) or .pfm/.npy (raw linear "
        "float) output path",
    )
    p.add_argument(
        "--frame-batch", type=int, default=0, metavar="K",
        help="progressive frames rendered per kernel launch (bitwise "
        "identical to K separate frames; with --adaptive, sample windows "
        "per round). 0 = auto: measured on the CUDA kernel, 1 on torch",
    )
    p.add_argument(
        "--adaptive", type=int, nargs="?", const=0, default=None,
        metavar="BLOCKS",
        help="variance-guided adaptive sampling: spend the --frames sample "
        "budget where the image is still noisy, at 64x32 pixel-block "
        "granularity (render/adaptive.py). Optional value = blocks "
        "re-rendered per round (default ~1/4 of the grid). Composes with "
        "--frame-batch and --checkpoint/--resume",
    )
    p.add_argument(
        "--denoise", type=_denoise_value, nargs="?", const=0, default=None,
        metavar="ITERS|auto",
        help="edge-avoiding a-trous wavelet denoise of the OUTPUT image "
        "(render/denoise.py), guided by a primary-hit albedo/normal/depth "
        "pass. Optional value = filter iterations (default 5; the support "
        "doubles per iteration), or 'auto' = a count scheduled from the "
        "framebuffer's own noise (raw once it is clean). A display transform "
        "only: checkpoints keep the raw accumulation and no sample stream "
        "changes. Composes with both backends and --adaptive",
    )
    p.add_argument(
        "--aov", type=str, default=None, metavar="LIST",
        help="comma list from {albedo,normal,depth}: write feature images "
        "next to --out as <stem>.<aov><ext>, from the deterministic "
        "primary-hit pass --denoise uses. u8 sinks encode linearly (normal "
        "(n+1)/2, depth t/(1+t)); .pfm/.npy sinks carry the raw float values",
    )
    p.add_argument("--checkpoint", default=None, help="save checkpoint here")
    p.add_argument("--resume", default=None, help="resume from checkpoint")
    p.add_argument("--log-level", default=None,
                   help="debug|info|warning|error (default info; MYRT_LOG env)")
    return p


def _make_denoiser(denoise_arg, config, world, width, height, device):
    """Build the output denoiser on ``device``, or None.

    ``denoise_arg``: None = off, 0 = default iterations, N >= 1 = N
    iterations, "auto" = noise-scheduled iterations. A display transform
    bound to the world, camera and size; applied at the image sinks, never
    to checkpoints.
    """
    if denoise_arg is None:
        return None
    from myraytracer_tpu_torch.render.denoise import Denoiser

    auto = denoise_arg == "auto"
    fixed = 0 if auto else denoise_arg
    return Denoiser(
        world, width, height, t_min=config.t_min, t_max=config.t_max,
        auto=auto, device=device, **({"iterations": fixed} if fixed else {}),
    )


def _parse_aov_names(aov_arg):
    """Validate a --aov comma list → channel names (SystemExit on junk)."""
    names = [s.strip().lower() for s in aov_arg.split(",") if s.strip()]
    bad = [n for n in names if n not in _AOV_NAMES]
    if bad:
        raise SystemExit(f"--aov: unknown channel(s) {bad}; choose from {_AOV_NAMES}")
    return names


def _aov_feature_pass(config, world, width, height, device, denoiser=None):
    """The Denoiser whose primary-hit pass sources the AOVs: the active
    --denoise instance when it was built from this world at this size, else
    a new one on ``device``."""
    if denoiser is not None and denoiser.world is world and (
        denoiser.width, denoiser.height
    ) == (width, height):
        return denoiser
    from myraytracer_tpu_torch.render.denoise import Denoiser

    return Denoiser(world, width, height, t_min=config.t_min, t_max=config.t_max,
                    device=device)


def _aov_images(dn, cam, names, hdr=False):
    """name → image dict from the feature pass. ``hdr`` keeps raw float
    values (signed normals, world-unit depth); else display encodes
    (normal (n+1)/2, depth t/(1+t) so sky→~1; albedo is already [0,1])."""
    import numpy as np

    albedo, normal, depth = (a.cpu().numpy() for a in dn.features(cam))
    out = {}
    for name in names:
        if name == "albedo":
            out[name] = albedo
        elif name == "normal":
            out[name] = normal if hdr else (normal * np.float32(0.5) + np.float32(0.5))
        else:
            out[name] = depth if hdr else np.repeat(
                (depth / (1.0 + depth))[..., None], 3, axis=-1
            )
    return out


def _write_aovs(aov_arg, out_path, config, world, width, height, device,
                cam=None, denoiser=None):
    """Write the AOV images next to ``--out`` as ``<stem>.<aov><ext>``, from
    the feature pass of ``denoiser`` when --denoise is active (same size and
    world), else from one computed here. u8 formats get linear encodes
    (gamma 1.0); .pfm/.npy get the raw float buffers."""
    names = _parse_aov_names(aov_arg)
    dn = _aov_feature_pass(config, world, width, height, device, denoiser)
    out = pathlib.Path(out_path)
    hdr = out.suffix.lower() in (".pfm", ".npy")
    for name, img in _aov_images(dn, cam, names, hdr=hdr).items():
        p = out.with_name(f"{out.stem}.{name}{out.suffix}")
        write_image(p, img, gamma=1.0)
        log.info("aov %s → %s", name, p)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    level_name = args.log_level or os.environ.get("MYRT_LOG") or "info"
    level = getattr(logging, level_name.upper(), None)
    if not isinstance(level, int):
        raise SystemExit(f"unknown log level {level_name!r}")
    logging.basicConfig(
        level=level, format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if args.frames < 1:
        raise SystemExit(f"--frames must be >= 1, got {args.frames}")
    config = RenderConfig(
        width=args.width,
        height=args.height,
        samples_per_frame=args.samples_per_frame,
        ray_depth=args.ray_depth,
        max_framebuffer_weight=args.max_framebuffer_weight,
        seed=args.seed,
        gamma=args.gamma,
        backend=args.backend,
        frame_batch=args.frame_batch,
        max_frames=args.frames,
        nee=args.nee,
        qmc=args.qmc,
        rr=max(0, args.rr),
    )
    from myraytracer_tpu_torch.render.dispatch import make_session

    try:
        world = get_scene(args.scene, seed=config.seed)
    except KeyError as e:
        raise SystemExit(f"--scene: {e.args[0]}") from None
    if args.aov:
        _parse_aov_names(args.aov)  # a bad list fails before the render, not after
    if args.adaptive is not None:
        return _run_adaptive(args, config, world)
    session = make_session(world, config)
    denoise = _make_denoiser(args.denoise, config, world, session.width, session.height,
                             session.device)
    log.info(
        "rendering scene=%s %dx%d spp/frame=%d depth=%d frames=%d "
        "frame_batch=%d backend=%s nee=%s rr=%d qmc=%s",
        args.scene, session.width, session.height, config.samples_per_frame,
        config.ray_depth, args.frames, session.frame_batch,
        session.backend_resolved, config.nee, config.rr, config.qmc,
    )
    if args.resume:
        session.load_checkpoint(args.resume)
        log.info(
            "resumed from %s at frame %d (%d spp)",
            args.resume, session.frame_count, session.accumulated_spp,
        )

    # One step = frame_batch frames; the auto batch never overshoots
    # --frames (config.max_frames), an explicit one may round it up.
    for _ in range(-(-args.frames // session.frame_batch)):
        segs0 = session.segments_traced
        t0 = time.perf_counter()
        session.step()
        segs = session.segments_traced - segs0  # waits for the step
        dt = time.perf_counter() - t0
        log.info(
            "frame=%d spp=%d ms=%.1f Mrays/s=%.1f",
            session.frame_count, session.accumulated_spp,
            dt * 1e3 / session.frame_batch, segs / dt / 1e6,
        )

    if args.checkpoint:
        session.save_checkpoint(args.checkpoint)
        log.info("checkpoint saved to %s", args.checkpoint)
    final = session.framebuffer
    if denoise is not None:
        final = denoise(final, session.scene.cam, spp=session.accumulated_spp)
        log.info("denoised: %d iterations%s", denoise.effective_iterations(
            session.accumulated_spp), " (auto)" if denoise.auto else "")
    write_image(args.out, final.cpu().numpy(), gamma=args.gamma)
    log.info("wrote %s", args.out)
    if args.aov:
        _write_aovs(args.aov, args.out, config, world, session.width, session.height,
                    session.device, cam=session.scene.cam, denoiser=denoise)
    return 0


def _run_adaptive(args, config: RenderConfig, world) -> int:
    """Adaptive-sampling render loop (render/adaptive.py), headless.

    ``--frames N`` is the budget of N uniform frames' worth of samples; the
    session reallocates it toward high-variance pixel blocks after a
    two-cover bootstrap. A resumed run spends N frames more.
    """
    import numpy as np

    from myraytracer_tpu_torch.render.adaptive import AdaptiveSession

    if args.resume and config.frame_batch == 0:
        # The saved session's window count is provenance: inherit it rather
        # than re-deriving it from this run's (possibly other) budget.
        with np.load(args.resume, allow_pickle=False) as data:
            saved = json.loads(str(data["meta"])).get("windows")
        if saved:
            config = config.replace(frame_batch=int(saved))

    session = AdaptiveSession(world, config, n_sel=max(0, args.adaptive))
    denoise = _make_denoiser(args.denoise, config, world, session.width, session.height,
                             session.device)
    if args.resume:
        session.load_checkpoint(args.resume)
        log.info(
            "resumed adaptive state from %s (%d rounds, %d samples spent)",
            args.resume, session.rounds, session.samples_spent,
        )
    budget = args.frames * config.samples_per_frame * session.width * session.height
    budget += session.samples_spent  # a resumed run's budget is extra
    round_cost = session.round_cost()
    log.info(
        "adaptive render %dx%d spp/round=%d depth=%d budget=%d frames "
        "(%d blocks of %dx%d, %d per round, windows=%d%s) backend=%s",
        session.width, session.height, config.samples_per_frame,
        config.ray_depth, args.frames, session.n_blocks, session.block_w,
        session.block_h, session.n_sel, session.windows,
        "" if config.frame_batch > 0 else " auto", session.backend_resolved,
    )
    t_start = t_sync = time.perf_counter()
    segs_start = segs_sync = session.segments_traced
    # The bootstrap (two covers: variance needs two rounds per block) runs
    # on a fresh session even past a tiny budget, so every pixel is
    # rendered; a resumed checkpoint that completed it does not re-pay it.
    if not session.bootstrapped:
        session.bootstrap()
    # Rounds queue on the device; the host syncs about once a second.
    while session.samples_spent + round_cost <= budget:
        session.step()
        if time.perf_counter() - t_sync >= 1.0:
            segs = session.segments_traced  # waits for the queued rounds
            dt = time.perf_counter() - t_sync
            log.info(
                "rounds=%d spent=%.1f%% of budget Mrays/s=%.1f",
                session.rounds, 100.0 * session.samples_spent / budget,
                (segs - segs_sync) / dt / 1e6,
            )
            t_sync, segs_sync = time.perf_counter(), segs
    final = session.framebuffer
    segs = session.segments_traced - segs_start
    dt = time.perf_counter() - t_start
    smap = session.spp_map
    log.info(
        "adaptive done: rounds=%d samples=%d (%.1f%% of budget) "
        "spp min/mean/max=%d/%.1f/%d s=%.3f Mrays/s=%.1f",
        session.rounds, session.samples_spent,
        100.0 * session.samples_spent / budget,
        smap.min(), float(smap.mean()), smap.max(), dt, segs / dt / 1e6,
    )
    if args.checkpoint:
        session.save_checkpoint(args.checkpoint)
        log.info("adaptive checkpoint saved to %s", args.checkpoint)
    if denoise is not None:
        # Adaptive spp is per pixel; the budget's average is the scale a
        # global filter's schedule wants.
        spp = session.samples_spent // (session.width * session.height)
        final = denoise(final, session.scene.cam, spp=spp)
        log.info("denoised: %d iterations%s", denoise.effective_iterations(spp),
                 " (auto)" if denoise.auto else "")
    write_image(args.out, final.cpu().numpy(), gamma=args.gamma)
    log.info("wrote %s", args.out)
    if args.aov:
        _write_aovs(args.aov, args.out, config, world, session.width, session.height,
                    session.device, cam=session.scene.cam, denoiser=denoise)
    return 0


if __name__ == "__main__":
    sys.exit(main())
