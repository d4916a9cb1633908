"""Command-line renderer for the PyTorch port.

The reference's native runner (``native-runner/src/main.rs:4-43``): the
same five flags with the same defaults and the same 0-means-derive size
rule, headless — ``--frames`` bounds the progressive loop and the result is
written to ``--out``. Extensions: scene, seed, backend, output transfer,
checkpoint and resume, and a per-frame log line (frame, accumulated spp,
ms, Mrays/s = traced ray segments per second).

The JAX package's other flags (serving, adaptive sampling, denoising,
AOVs, OBJ input, sharding, NEE, QMC, Russian roulette, ...) are not in the
port yet.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.output.image import parse_gamma, write_image
from myraytracer_tpu_torch.scene.presets import get_scene

log = logging.getLogger("myraytracer_tpu_torch")


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
        "final, or spheres:N (final-scene-style 2Nx2N sphere field)",
    )
    p.add_argument("--seed", type=int, default=0)
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
    p.add_argument("--checkpoint", default=None, help="save checkpoint here")
    p.add_argument("--resume", default=None, help="resume from checkpoint")
    p.add_argument("--log-level", default=None,
                   help="debug|info|warning|error (default info; MYRT_LOG env)")
    return p


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
        max_frames=args.frames,
    )
    from myraytracer_tpu_torch.render.dispatch import make_session

    try:
        world = get_scene(args.scene, seed=config.seed)
    except KeyError as e:
        raise SystemExit(f"--scene: {e.args[0]}") from None
    session = make_session(world, config)
    log.info(
        "rendering scene=%s %dx%d spp/frame=%d depth=%d frames=%d backend=%s",
        args.scene, session.width, session.height, config.samples_per_frame,
        config.ray_depth, args.frames, session.backend_resolved,
    )
    if args.resume:
        session.load_checkpoint(args.resume)
        log.info(
            "resumed from %s at frame %d (%d spp)",
            args.resume, session.frame_count, session.accumulated_spp,
        )

    for _ in range(args.frames):
        segs0 = session.segments_traced
        t0 = time.perf_counter()
        session.step()
        segs = session.segments_traced - segs0  # waits for the frame
        dt = time.perf_counter() - t0
        log.info(
            "frame=%d spp=%d ms=%.1f Mrays/s=%.1f",
            session.frame_count, session.accumulated_spp, dt * 1e3,
            segs / dt / 1e6,
        )

    if args.checkpoint:
        session.save_checkpoint(args.checkpoint)
        log.info("checkpoint saved to %s", args.checkpoint)
    write_image(args.out, session.framebuffer.cpu().numpy(), gamma=args.gamma)
    log.info("wrote %s", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
