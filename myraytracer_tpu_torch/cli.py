"""Command-line renderer for the PyTorch port.

The reference's native runner (``native-runner/src/main.rs:4-43``): the
same five flags with the same defaults and the same 0-means-derive size
rule, headless — ``--frames`` bounds the progressive loop (0 = until
Ctrl-C) and the result is written to ``--out``. Extensions: scene, seed,
backend (``MYRT_BACKEND`` when the flag is left at ``auto``), background
(``--ambient``), output transfer and exposure, checkpoint and resume, frame
batching (``--frame-batch``), adaptive sampling (``--adaptive``), the
estimator's modes (``--nee``, ``--rr N``, ``--qmc``), the output denoiser
(``--denoise [N|auto]``) and feature images (``--aov``), progressive
previews (``--preview-every``), the live viewer (``--serve PORT``, with
camera orbits under ``--interactive``: the analog of the reference's
browser runner), a profiler trace (``--profile``), a NaN check a step
(``--debug-nans``), sharding over a device mesh (``--shard
{tiles,samples,hybrid}``) and over processes (``--multihost``), and a log
line per sync (frame, accumulated spp, ms a frame, Mrays/s = traced ray
segments per second, shadow rays included).

Every scene renders on both backends: ``cuda`` (the default ``auto``) runs
the CUDA kernels on the GPU and never falls back to the CPU; ``torch`` runs
the plain integrator on the CPU. ``cpu`` runs the native C++ renderer on
the host's cores (sphere, mesh and mixed worlds, the default estimator);
``auto`` logs the routing model's verdict on it but stays on the card. An
OBJ file renders with ``--obj FILE`` (``--ground``: on the giant ground
sphere instead of the ground quad). The denoiser and the feature pass run
on the session's device.

``--shard`` renders on a mesh of every local card (``cuda``) or the CPU
(``torch``), one shard an entry (parallel/sharding.py); ``--multihost
HOST:PORT,N,RANK`` joins N processes through ``torch.distributed`` before
any device use, each rank on its own card (or sharing one), and the mesh
spans them. Every rank renders its own shards and joins the collectives
(the segment count a sync, the framebuffer's gather at each image sink and
checkpoint); only rank 0 writes files.
"""

from __future__ import annotations

import argparse
import contextlib
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

# Seconds between host syncs under --serve: each pushes a frame to the
# viewer and polls its camera; steps in between queue on the device.
SERVE_SYNC_S = 0.25


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
    p.add_argument(
        "--frames", type=int, default=1,
        help="progressive frames to run; 0 = accumulate until interrupted "
        "(the reference's unbounded redraw loop, lib.rs:187-196: Ctrl-C "
        "writes the checkpoint and the final image)",
    )
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
        "--ambient", default=None, metavar="R,G,B",
        help="constant background color replacing the scene's sky (e.g. 0,0,0 "
        "for emissive-only light; the reference's sky gradient is hard-coded, "
        "shader.wgsl:331-334)",
    )
    p.add_argument(
        "--obj", default=None, metavar="FILE",
        help="render an OBJ mesh (overrides --scene; native C++ loader), "
        "normalized over a ground quad",
    )
    p.add_argument(
        "--ground", action="store_true",
        help="with --obj: the giant ground sphere instead of the ground quad "
        "(a mixed sphere and mesh world)",
    )
    p.add_argument(
        "--backend", choices=["auto", "cuda", "torch", "cpu"], default="auto",
        help="cuda: the CUDA kernels on the GPU (never falls back to the CPU; "
        "without a GPU it raises); torch: the plain PyTorch integrator on the "
        "CPU; cpu: the native C++ SAH-BVH renderer on the host's cores "
        "(MYRT_CPU_THREADS; its own sample stream); auto: cuda, with the "
        "routing model's verdict on cpu logged. Left at auto, the "
        "MYRT_BACKEND env var overrides (the analog of the reference's "
        "WGPU_BACKEND override, lib.rs:322)",
    )
    p.add_argument(
        "--shard", choices=["none", "tiles", "samples", "hybrid"], default="none",
        help="multi-device sharding mode (image tiles or sample-parallel) over "
        "every local card (cuda) or the CPU (torch)",
    )
    p.add_argument(
        "--multihost", nargs="?", const="", default=None,
        metavar="HOST:PORT[,NPROCS,PID]",
        help="initialize torch.distributed for a process-spanning mesh (one "
        "process per card, or several sharing one). With no value, the "
        "address, world size and rank come from the torchrun environment. "
        "Combine with --shard; only process 0 writes output.",
    )
    p.add_argument(
        "--gamma", type=parse_gamma, default=2.0, metavar="G|srgb|aces",
        help="output transfer: float exponent (2.0 = RTiOW sqrt), 'srgb' or "
        "'aces'",
    )
    p.add_argument(
        "--exposure", type=float, default=1.0, metavar="SCALE",
        help="linear pre-transfer exposure scale for display encodes (1.0 = "
        "neutral, 2.0 = +1 stop): the written image, previews and the viewer. "
        ".pfm/.npy sinks, AOVs and checkpoints carry the unscaled radiance",
    )
    p.add_argument(
        "--out", default="out.png",
        help=".png/.ppm (u8, --gamma transfer) or .pfm/.npy (raw linear "
        "float) output path",
    )
    p.add_argument(
        "--sample-batch", type=int, default=0, metavar="S",
        help="samples the plain torch integrator traces in one vectorized "
        "pass (0 = auto, from the frame size). The CUDA kernel ignores it: "
        "each lane traces its samples in turn",
    )
    p.add_argument(
        "--frame-batch", type=int, default=0, metavar="K",
        help="progressive frames rendered per kernel launch (bitwise "
        "identical to K separate frames; with --adaptive, sample windows "
        "per round). 0 = auto: measured on the CUDA kernel, 1 on torch and "
        "with --serve (keeps the viewer's and the orbit's latency low)",
    )
    p.add_argument(
        "--adaptive", type=int, nargs="?", const=0, default=None,
        metavar="BLOCKS",
        help="variance-guided adaptive sampling: spend the --frames sample "
        "budget where the image is still noisy, at 64x32 pixel-block "
        "granularity (render/adaptive.py). Optional value = blocks "
        "re-rendered per round (default ~1/4 of the grid). Composes with "
        "--frame-batch, --checkpoint/--resume, --serve (a progress view; no "
        "query rebuilds) and --interactive (an orbit restarts the schedule); "
        "not with --frames 0",
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
        "changes. Composes with both backends, --adaptive and --serve",
    )
    p.add_argument(
        "--aov", type=str, default=None, metavar="LIST",
        help="comma list from {albedo,normal,depth}: write feature images "
        "next to --out as <stem>.<aov><ext>, from the deterministic "
        "primary-hit pass --denoise uses. u8 sinks encode linearly (normal "
        "(n+1)/2, depth t/(1+t)); .pfm/.npy sinks carry the raw float values. "
        "With --serve, also published at /aov/<name>.png",
    )
    p.add_argument("--checkpoint", default=None, help="save checkpoint here")
    p.add_argument("--resume", default=None, help="resume from checkpoint")
    p.add_argument("--log-level", default=None,
                   help="debug|info|warning|error (default info; MYRT_LOG env)")
    p.add_argument(
        "--profile", default=None, metavar="LOGDIR",
        help="record a torch.profiler trace of the render loop (CPU and CUDA "
        "activity) into LOGDIR/trace.json (Chrome trace format)",
    )
    p.add_argument(
        "--debug-nans", action="store_true",
        help="check every step's new framebuffer for NaN and inf and stop at "
        "the first (FloatingPointError naming the frame; a sync a step)",
    )
    p.add_argument(
        "--preview-every", type=int, default=0, metavar="N",
        help="rewrite --out every N frames (progressive preview)",
    )
    p.add_argument(
        "--serve", type=int, default=None, metavar="PORT",
        help="serve the accumulating frame at http://localhost:PORT/ (the "
        "analog of the reference's browser runner; 0 picks a free port)",
    )
    p.add_argument(
        "--interactive", action="store_true",
        help="with --serve: drag/wheel in the browser orbits the camera (the "
        "runtime camera operand: no kernel or table rebuild; general-mode "
        "scenes)",
    )
    return p


class _DenoiseOnly(Exception):
    """Control flow: a viewer query that only toggles --denoise (the
    serving loop swaps the output filter without a session rebuild)."""


def _make_denoiser(denoise_arg, config, world, width, height, device):
    """Build the output denoiser on ``device``, or None.

    ``denoise_arg``: None = off, 0 = default iterations, N >= 1 = N
    iterations, "auto" (or the viewer's -1 sentinel) = noise-scheduled
    iterations. A display transform bound to the world, camera and size;
    applied at the image sinks, never to checkpoints.
    """
    if denoise_arg is None:
        return None
    from myraytracer_tpu_torch.render.denoise import Denoiser

    auto = denoise_arg == "auto" or denoise_arg == -1
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


def _parse_ambient(value):
    """--ambient R,G,B → three nonnegative floats (SystemExit on junk)."""
    try:
        amb = tuple(float(c) for c in value.split(","))
        if len(amb) != 3 or any(c < 0 for c in amb):
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"--ambient: expected R,G,B nonnegative floats, got {value!r}"
        ) from None
    return amb


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
    """name → host image dict from the feature pass. ``hdr`` keeps raw float
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


def _make_viewer(args, world):
    """The live viewer of --serve, or None; --interactive needs one, a
    camera that moves and no sharding."""
    if args.interactive and (args.serve is None or world.camera.reference_mode
                             or args.shard != "none"):
        raise SystemExit(
            "--interactive needs --serve, a general-mode (positionable) "
            "camera scene, and --shard none"
        )
    if args.serve is None:
        return None
    from myraytracer_tpu_torch.viewer import LiveViewer

    return LiveViewer(args.serve, gamma=args.gamma, exposure=args.exposure)


def _denoise_stats(denoise, spp):
    """The viewer's denoise fields for ``LiveViewer.update``."""
    return dict(
        denoise=denoise.effective_iterations(spp) if denoise else 0,
        denoise_auto=bool(denoise and denoise.auto),
        denoise_noise=denoise.last_noise if denoise and denoise.auto else None,
    )


def _is_rank0() -> bool:
    """Whether this process writes files: the only one, or rank 0 of a
    --multihost run."""
    from myraytracer_tpu_torch.parallel.sharding import process

    return process() is None or process().rank == 0


def _fetch(session):
    """The session's whole framebuffer; under --multihost every rank joins
    the gather, and its ms is logged."""
    t0 = time.perf_counter()
    fb = session.fetch_framebuffer()
    proc = session.mesh.proc if session.mesh is not None else None
    if proc is not None:
        log.info("framebuffer %dx%d fetched over %d ranks (%s) in %.2f ms", session.width,
                 session.height, proc.world, proc.backend, (time.perf_counter() - t0) * 1e3)
    return fb


def routing_verdict(pred: float, mrays: float):
    """(holds, log line) of a measured steady-state rate against the routing
    model's prediction for the backend that renders: it holds within 3x."""
    from myraytracer_tpu_torch.native.cpu_backend import ANCHORED_ON

    if mrays > 0 and (mrays < pred / 3.0 or mrays > pred * 3.0):
        return False, (
            f"routing model mispredicted this host: measured {mrays:.1f} Mrays/s vs "
            f"predicted {pred:.1f} on the rendering backend; its anchors "
            f"(native/cpu_backend.py) were measured on {ANCHORED_ON} and may not fit "
            f"this hardware: set MYRT_CPU_THREADS or choose the --backend yourself")
    return True, f"routing prediction holds: measured {mrays:.1f} Mrays/s vs predicted {pred:.1f}"


def _check_routing_prediction(session, mrays: float):
    """One-shot check of the routing model against the first steady-state
    frame of a session that carries ``routing_prediction`` (``--backend
    cpu``): the first sync holds the scene's build and only arms it; the
    next warns on a miss past 3x and logs a hit. Returns the verdict when
    it checks, else None."""
    pred = getattr(session, "routing_prediction", None)
    if not pred:
        return None
    if not getattr(session, "_route_check_armed", False):
        session._route_check_armed = True  # skip the warmup-polluted sync
        return None
    session.routing_prediction = None  # check once
    holds, msg = routing_verdict(pred, mrays)
    (log.info if holds else log.warning)("%s", msg)
    return holds


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    level_name = args.log_level or os.environ.get("MYRT_LOG") or "info"
    level = getattr(logging, level_name.upper(), None)
    if not isinstance(level, int):
        raise SystemExit(
            f"unknown log level {level_name!r} (flag --log-level or MYRT_LOG "
            f"env): use debug|info|warning|error"
        )
    logging.basicConfig(
        level=level, format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if args.frames < 0:
        raise SystemExit(f"--frames must be >= 0, got {args.frames}")
    backend = args.backend
    if backend == "auto" and os.environ.get("MYRT_BACKEND"):
        backend = os.environ["MYRT_BACKEND"]
        if backend not in ("auto", "cuda", "torch", "cpu"):
            raise SystemExit(f"MYRT_BACKEND={backend!r}: not auto|cuda|torch|cpu")
    # A live viewer wants a frame's latency, not a batch's throughput: auto
    # frame batching drops to 1 under --serve unless set.
    frame_batch = args.frame_batch
    if frame_batch == 0 and args.serve is not None:
        frame_batch = 1

    def make_config(**over) -> RenderConfig:
        base = dict(
            width=args.width,
            height=args.height,
            samples_per_frame=args.samples_per_frame,
            ray_depth=args.ray_depth,
            max_framebuffer_weight=args.max_framebuffer_weight,
            seed=args.seed,
            gamma=args.gamma,
            sample_batch=args.sample_batch,
            backend=backend,
            frame_batch=frame_batch,
            max_frames=args.frames,
            nee=args.nee,
            qmc=args.qmc,
            rr=max(0, args.rr),
            shard=args.shard,
        )
        base.update(over)
        return RenderConfig(**base)

    def build_world(scene_name: str, config: RenderConfig):
        if args.obj:
            from myraytracer_tpu_torch.scene.presets import obj_scene

            world = obj_scene(args.obj, ground_sphere=args.ground)
        elif args.ground:
            raise SystemExit("--ground needs --obj (it swaps the OBJ "
                             "scene's ground quad for a sphere)")
        else:
            try:
                world = get_scene(scene_name, seed=config.seed)
            except KeyError as e:
                raise SystemExit(f"--scene: {e.args[0]}") from None
        if args.ambient is not None:
            from myraytracer_tpu_torch.scene.api import World

            world = World(world.spheres, camera=world.camera, meshes=world.meshes,
                          ambient=_parse_ambient(args.ambient))
        return world

    if args.aov:
        _parse_aov_names(args.aov)  # a bad list fails before the render, not after
    if args.adaptive is not None:
        for bad, name in (
            (args.shard not in ("none", "tiles"), f"--shard {args.shard} (tile stripes only)"),
            (args.multihost is not None and args.shard != "tiles",
             "--multihost without --shard tiles"),
            (args.multihost is not None and args.serve is not None,
             "--serve under --multihost (the viewer is single-process)"),
            (args.frames == 0, "--frames 0 (needs a bounded budget)"),
        ):
            if bad:
                raise SystemExit(f"--adaptive does not compose with {name}")
    if args.serve is not None and args.multihost is not None:
        # The viewer syncs and rebuilds sessions on one process only; the
        # others would go on issuing collectives and hang.
        raise SystemExit("--serve is single-process; run the viewer without --multihost")
    if args.multihost is not None:
        # Before any device use: the rank takes its card, and the default
        # mesh spans every rank.
        from myraytracer_tpu_torch.parallel.sharding import initialize_multihost

        initialize_multihost(args.multihost,
                             device_type="cuda" if backend in ("auto", "cuda") else "cpu")
    from myraytracer_tpu_torch.utils import profiling

    # The switch is the process's (as jax_debug_nans is); a run restores it.
    nans_before = profiling.debug_nans()
    profiling.enable_debug_nans(args.debug_nans or nans_before)
    trace_cm = (profiling.profile_trace(args.profile) if args.profile
                else contextlib.nullcontext())
    try:
        config = make_config()
        if args.adaptive is not None:
            rc = _run_adaptive(args, config, build_world(args.scene, config), trace_cm)
        else:
            rc = _run_uniform(args, config, make_config, build_world, trace_cm)
        if args.multihost is not None:
            from myraytracer_tpu_torch.parallel.sharding import shutdown_multihost

            shutdown_multihost()
        return rc
    finally:
        profiling.enable_debug_nans(nans_before)


def _run_uniform(args, config, make_config, build_world, trace_cm) -> int:
    """The progressive loop: one step = ``frame_batch`` frames. Headless, a
    step syncs and logs; under --serve the host syncs every
    ``SERVE_SYNC_S``, pushes the frame to the viewer, applies orbits and
    session requests, and steps in between queue on the device."""
    from myraytracer_tpu_torch.render.dispatch import make_session

    def build_session(scene_name: str, config: RenderConfig):
        world = build_world(scene_name, config)
        session = make_session(world, config)
        log.info(
            "rendering scene=%s %dx%d spp/frame=%d depth=%d frames=%s "
            "frame_batch=%d backend=%s shard=%s x%d nee=%s rr=%d qmc=%s",
            f"obj:{args.obj}{' --ground' if args.ground else ''}" if args.obj else scene_name,
            session.width, session.height, config.samples_per_frame,
            config.ray_depth, args.frames if args.frames else "unbounded",
            session.frame_batch, session.backend_resolved, config.shard, session.ndev,
            config.nee, config.rr, config.qmc,
        )
        return world, session

    scene_name = args.scene
    world, session = build_session(scene_name, config)
    proc0 = _is_rank0()
    denoise_arg = args.denoise
    denoise = _make_denoiser(denoise_arg, config, world, session.width, session.height,
                             session.device)

    def post(fb):
        """--denoise at every image sink (never on checkpoints), as a host
        array. Reads the current session and denoiser, which a viewer
        request rebinds."""
        if denoise is not None:
            fb = denoise(fb, session.scene.cam, spp=session.accumulated_spp)
        return fb.cpu().numpy()

    if args.resume:
        session.load_checkpoint(args.resume)
        log.info(
            "resumed from %s at frame %d (%d spp)",
            args.resume, session.frame_count, session.accumulated_spp,
        )

    viewer = _make_viewer(args, world)
    # Orbits turn about the view the run started from: the resumed one.
    orbit_base = session.camera

    aov_names = _parse_aov_names(args.aov) if args.aov else []
    aov_pass = {}  # the viewer's cached feature pass

    def push_aovs():
        """Publish /aov/<name>.png (--aov with --serve). Features are static
        per camera, so this runs when the camera or the session changes
        (start, rebuild, orbit), never a frame; the feature pass is cached."""
        if viewer is None or not aov_names:
            return
        dn = denoise
        if dn is None or (dn.width, dn.height) != (session.width, session.height):
            dn = aov_pass.get("dn")
            if (dn is None
                    or (dn.width, dn.height) != (session.width, session.height)
                    or aov_pass.get("world") is not world):
                dn = _aov_feature_pass(config, world, session.width, session.height,
                                       session.device)
                aov_pass["dn"], aov_pass["world"] = dn, world
        viewer.set_aovs(_aov_images(dn, session.scene.cam, aov_names))
        log.info("aov endpoints live: /aov/{%s}.png", ",".join(aov_names))

    push_aovs()

    # Under the viewer a step is not synced by itself: the host syncs (and
    # pushes to the browser and polls the camera) on a wall-clock cadence,
    # and reads the segment count only there. Headless, every step syncs
    # for its log line.
    sync_interval = SERVE_SYNC_S if viewer is not None else 0.0
    # A while loop: a session rebuild can change frame_batch, and with it
    # the step count.
    n_steps = -(-args.frames // session.frame_batch)
    previews_written = 0
    with trace_cm:
        t_sync = time.perf_counter()
        segs_sync = session.segments_traced
        frames_sync = 0
        try:
            i = 0
            while args.frames == 0 or i < n_steps:
                last = args.frames != 0 and i == n_steps - 1
                i += 1
                if viewer is not None and not last:
                    sreq = viewer.pending_session()
                    if sreq is not None:
                        # URL-query render parameters (the reference web
                        # runner's Args-from-query, lib.rs:72-94): rebuild
                        # the session with the merged config. A bad request
                        # is rejected and the running session kept.
                        try:
                            from myraytracer_tpu_torch.viewer import validate_config_bounds

                            req_scene = sreq.pop("scene", scene_name)
                            # ?denoise=N: 0 = off, N >= 1 = iterations. A
                            # denoise-only query swaps the output filter in
                            # place and keeps the accumulation.
                            req_dn = sreq.pop("denoise", None)
                            if not sreq and req_scene == scene_name and req_dn is not None:
                                denoise_arg = req_dn if req_dn else None
                                denoise = _make_denoiser(
                                    denoise_arg, config, world, session.width,
                                    session.height, session.device)
                                log.info(
                                    "denoise %s (live toggle, accumulation kept)",
                                    ("on (auto)" if denoise.auto else
                                     f"on ({denoise.iterations} iters)") if denoise else "off",
                                )
                                raise _DenoiseOnly
                            req_config = make_config(**sreq)
                            # The merged config, not just the query: ?width=4096
                            # must not combine with a large height.
                            validate_config_bounds(req_config)
                            # The running session stays until the new one is
                            # built; replaced, nothing holds its tables on
                            # the card any more.
                            new_world, new_session = build_session(req_scene, req_config)
                        except _DenoiseOnly:
                            pass
                        except (SystemExit, ValueError, KeyError, TypeError) as e:
                            log.warning("viewer session request rejected: %s", e)
                        else:
                            world, session = new_world, new_session
                            scene_name, config = req_scene, req_config
                            orbit_base = session.camera
                            if req_dn is not None:
                                denoise_arg = req_dn if req_dn else None
                            denoise = _make_denoiser(denoise_arg, config, world,
                                                     session.width, session.height,
                                                     session.device)
                            # The rebuilt session restarts the accumulation
                            # (a page reload), and the frame budget with it.
                            n_steps = -(-args.frames // session.frame_batch)
                            i = 1  # the in-flight step is the first
                            push_aovs()
                        t_sync = time.perf_counter()
                        segs_sync = session.segments_traced
                        frames_sync = 0
                session.step()
                frames_sync += session.frame_batch
                if viewer is not None and not last \
                        and time.perf_counter() - t_sync < sync_interval:
                    continue
                segs = session.segments_traced  # waits for the queued steps
                dt = time.perf_counter() - t_sync
                mrays = (segs - segs_sync) / dt / 1e6
                log.info(
                    "frame=%d spp=%d ms=%.1f Mrays/s=%.1f",
                    session.frame_count, session.accumulated_spp,
                    dt * 1e3 / max(1, frames_sync), mrays,
                )
                _check_routing_prediction(session, mrays)
                t_sync, segs_sync, frames_sync = time.perf_counter(), segs, 0
                if viewer is not None:
                    # The encode runs on the viewer's thread while this one
                    # queues the next steps; the last frame is published
                    # before the run ends.
                    viewer.update(post(session.framebuffer), session.frame_count,
                                  session.accumulated_spp, background=not last,
                                  **_denoise_stats(denoise, session.accumulated_spp))
                    # Not on the last step: a move would zero the
                    # accumulation with nothing left to refill it.
                    if args.interactive and not last:
                        req = viewer.pending_camera()
                        if req is not None:
                            from myraytracer_tpu_torch.render.camera import orbit_camera

                            session.set_camera(orbit_camera(
                                orbit_base, req.get("yaw", 0.0), req.get("pitch", 0.0),
                                req.get("dist", 1.0),
                            ))
                            log.info(
                                "camera orbit yaw=%.2f pitch=%.2f dist=%.2f "
                                "(accumulation reset, no rebuild)",
                                req.get("yaw", 0.0), req.get("pitch", 0.0),
                                req.get("dist", 1.0),
                            )
                            push_aovs()  # the features follow the orbit
                if args.preview_every and session.frame_count > 0 \
                        and session.frame_count // args.preview_every > previews_written:
                    # Threshold crossing, not divisibility: frame_count moves
                    # in frame_batch jumps that rarely land on multiples.
                    # Every rank joins the gather; rank 0 writes.
                    previews_written = session.frame_count // args.preview_every
                    preview = _fetch(session)
                    if proc0:
                        write_image(args.out, post(preview), gamma=args.gamma,
                                    exposure=args.exposure)
                        log.info("preview → %s", args.out)
        except KeyboardInterrupt:
            # The run-forever mode's exit (and any long run's): the
            # checkpoint and the final image below, with what accumulated.
            # A step commits whole, so the state is a step's end.
            log.info(
                "interrupted at frame %d (%d spp) — writing final image",
                session.frame_count, session.accumulated_spp,
            )

    if args.checkpoint:
        # Every rank joins the state's gather; rank 0 writes the file.
        session.save_checkpoint(args.checkpoint if proc0 else None)
        if proc0:
            log.info("checkpoint saved to %s", args.checkpoint)
    fb = _fetch(session)
    if not proc0:
        return 0
    final = post(fb)
    if denoise is not None:
        log.info("denoised: %d iterations%s", denoise.effective_iterations(
            session.accumulated_spp), " (auto)" if denoise.auto else "")
    write_image(args.out, final, gamma=args.gamma, exposure=args.exposure)
    log.info("wrote %s", args.out)
    if args.aov:
        # The features follow the final camera (an orbit moves scene.cam).
        _write_aovs(args.aov, args.out, config, world, session.width, session.height,
                    session.device, cam=session.scene.cam, denoiser=denoise)
    return 0


def _run_adaptive(args, config: RenderConfig, world, trace_cm) -> int:
    """Adaptive-sampling render loop (render/adaptive.py).

    ``--frames N`` is the budget of N uniform frames' worth of samples; the
    session reallocates it toward high-variance pixel blocks after a
    two-cover bootstrap. A resumed run spends N frames more. Under --serve
    the viewer shows the progress (URL-query rebuilds are refused: the
    state is bound to one scene and size, but ``?denoise=`` toggles the
    filter), and under --interactive an orbit restarts the bootstrap and
    the budget.
    """
    import numpy as np

    from myraytracer_tpu_torch.render.adaptive import AdaptiveSession

    viewer = _make_viewer(args, world)
    if args.resume and config.frame_batch == 0:
        # The saved session's window count is provenance: inherit it rather
        # than re-deriving it from this run's (possibly other) budget.
        with np.load(args.resume, allow_pickle=False) as data:
            saved = json.loads(str(data["meta"])).get("windows")
        if saved:
            config = config.replace(frame_batch=int(saved))

    session = AdaptiveSession(world, config, n_sel=max(0, args.adaptive))
    proc0 = _is_rank0()
    denoise = _make_denoiser(args.denoise, config, world, session.width, session.height,
                             session.device)

    def avg_spp():
        # Adaptive spp is per pixel; the budget's average is the scale a
        # global filter's schedule wants.
        return session.samples_spent // (session.width * session.height)

    def post(fb):
        """--denoise as a host array; the runtime camera rides along, so the
        guide features follow an orbit."""
        if denoise is not None:
            fb = denoise(fb, session.scene.cam, spp=avg_spp())
        return fb.cpu().numpy()

    if args.resume:
        session.load_checkpoint(args.resume)
        log.info(
            "resumed adaptive state from %s (%d rounds, %d samples spent)",
            args.resume, session.rounds, session.samples_spent,
        )
    orbit_base = session.camera
    aov_dn = None
    if viewer is not None and args.aov:
        aov_dn = _aov_feature_pass(config, world, session.width, session.height,
                                   session.device, denoise)
        viewer.set_aovs(_aov_images(aov_dn, session.scene.cam, _parse_aov_names(args.aov)))
    budget = args.frames * config.samples_per_frame * session.width * session.height
    budget += session.samples_spent  # a resumed run's budget is extra
    round_cost = session.round_cost()
    log.info(
        "adaptive render %dx%d spp/round=%d depth=%d budget=%d frames "
        "(%d blocks of %dx%d, %d per round, windows=%d%s) backend=%s "
        "shard=%s x%d",
        session.width, session.height, config.samples_per_frame,
        config.ray_depth, args.frames, session.n_blocks, session.block_w,
        session.block_h, session.n_sel, session.windows,
        "" if config.frame_batch > 0 else " auto", session.backend_resolved,
        config.shard, session.ndev,
    )
    # Rounds queue on the device; the host syncs about once a second, or on
    # the viewer's cadence. Under --multihost a sync is a collective, which
    # a wall-clock cadence would issue at different rounds on each rank: the
    # ranks sync only at the end.
    sync_interval = SERVE_SYNC_S if viewer is not None else 1.0
    if args.multihost is not None:
        sync_interval = float("inf")
    with trace_cm:
        t_start = t_sync = time.perf_counter()
        segs_start = segs_sync = session.segments_traced
        try:
            # The bootstrap (two covers: variance needs two rounds per block)
            # runs on a fresh session even past a tiny budget, so every pixel
            # is rendered; a resumed checkpoint that completed it does not
            # pay it again.
            if not session.bootstrapped:
                session.bootstrap()
            while session.samples_spent + round_cost <= budget:
                session.step()
                if time.perf_counter() - t_sync < sync_interval:
                    continue
                segs = session.segments_traced  # waits for the queued rounds
                dt = time.perf_counter() - t_sync
                log.info(
                    "rounds=%d spent=%.1f%% of budget Mrays/s=%.1f",
                    session.rounds, 100.0 * session.samples_spent / budget,
                    (segs - segs_sync) / dt / 1e6,
                )
                t_sync, segs_sync = time.perf_counter(), segs
                if viewer is None:
                    continue
                viewer.update(post(session.framebuffer), session.rounds, avg_spp(),
                              background=True, **_denoise_stats(denoise, avg_spp()))
                if args.interactive:
                    req = viewer.pending_camera()
                    if req is not None:
                        from myraytracer_tpu_torch.render.camera import orbit_camera

                        session.set_camera(orbit_camera(
                            orbit_base, req.get("yaw", 0.0), req.get("pitch", 0.0),
                            req.get("dist", 1.0),
                        ))
                        log.info(
                            "camera orbit yaw=%.2f pitch=%.2f dist=%.2f "
                            "(adaptive schedule restarted, no rebuild)",
                            req.get("yaw", 0.0), req.get("pitch", 0.0), req.get("dist", 1.0),
                        )
                        if args.aov:
                            aov_dn = _aov_feature_pass(
                                config, world, session.width, session.height,
                                session.device, denoise or aov_dn)
                            viewer.set_aovs(_aov_images(aov_dn, session.scene.cam,
                                                        _parse_aov_names(args.aov)))
                sreq = viewer.pending_session()
                if sreq is not None:
                    req_dn = sreq.pop("denoise", None)
                    if sreq or req_dn is None:
                        log.warning(
                            "viewer session request ignored: the adaptive state is "
                            "bound to one scene and size (restart with new flags)"
                        )
                    else:
                        # A display transform: the schedule and the
                        # accumulation are untouched.
                        denoise = _make_denoiser(req_dn if req_dn else None, config, world,
                                                 session.width, session.height,
                                                 session.device)
                        log.info(
                            "denoise %s (live toggle, schedule kept)",
                            ("on (auto)" if denoise.auto else
                             f"on ({denoise.iterations} iters)") if denoise else "off",
                        )
        except KeyboardInterrupt:
            log.info(
                "interrupted at round %d (%d samples) — writing final image",
                session.rounds, session.samples_spent,
            )
    segs = session.segments_traced - segs_start  # waits for the queued rounds
    dt = time.perf_counter() - t_start
    fb = _fetch(session)  # every rank joins the gather
    final = post(fb) if proc0 else None
    smap = session.spp_map
    log.info(
        "adaptive done: rounds=%d samples=%d (%.1f%% of budget) "
        "spp min/mean/max=%d/%.1f/%d s=%.3f Mrays/s=%.1f",
        session.rounds, session.samples_spent,
        100.0 * session.samples_spent / budget,
        smap.min(), float(smap.mean()), smap.max(), dt, segs / dt / 1e6,
    )
    if viewer is not None:
        viewer.update(final, session.rounds, avg_spp(), **_denoise_stats(denoise, avg_spp()))
    if args.checkpoint:
        # Every rank joins the state's gather; rank 0 writes the file.
        session.save_checkpoint(args.checkpoint if proc0 else None)
        if proc0:
            log.info("adaptive checkpoint saved to %s", args.checkpoint)
    if not proc0:
        return 0
    if denoise is not None:
        log.info("denoised: %d iterations%s", denoise.effective_iterations(avg_spp()),
                 " (auto)" if denoise.auto else "")
    write_image(args.out, final, gamma=args.gamma, exposure=args.exposure)
    log.info("wrote %s", args.out)
    if args.aov:
        # The features follow the final camera (an orbit may have moved it).
        _write_aovs(args.aov, args.out, config, world, session.width, session.height,
                    session.device, cam=session.scene.cam, denoiser=denoise)
    return 0


if __name__ == "__main__":
    sys.exit(main())
