"""Batch sweeps of the CUDA kernels on one GPU, and the kernel-config A/B.

    python -m myraytracer_tpu_torch.sweep
    python -m myraytracer_tpu_torch.sweep --variants

The auto policies of ``config.resolve_frame_batch`` and
``config.resolve_adaptive_windows`` come from these numbers, taken on the
final scene at 1200x800, depth 50 (PERF.md):

* frames: the uniform kernel at spp 1 with K in FRAMES frames a launch --
  kernel ms per frame (CUDA events around whole launches) and Mrays/s;
* windows: an adaptive session at spp 8 with F in WINDOWS windows a round
  -- kernel ms per window of one round's launch, and the session's ms per
  round (launch, fold and scores, host clock to a device sync) with its
  Mrays/s;
* staging: the uniform kernel at spp 1 on STAGING_SCENES with the gate
  tables staged in shared memory (the default plan) and left in global
  memory (``KernelConfig(SMEM_LIMIT=0)``: nothing staged), in turns -- what
  the kernel variant that reads its gates from global memory costs.

The sweeps run PASSES times in turn, so drift spreads over every point.
Each measurement is one JSON line on stdout; the line before them gives the
card's name and power limit as ``nvidia-smi`` reports them. It needs a CUDA
GPU and exits non-zero without one.

``--variants`` is the counterpart of the JAX package's ``tools/sweep.py``:
it renders one scene (spatially sorted) under each ``KernelConfig`` override
of ``VARIANTS`` -- the JAX table's entries whose every key has a counterpart
here, under their names and with their overrides, and the port's own entries
-- and times them. ``_PARTITION`` goes to ``compile_scene(partition=...,
partition_chunk=CULL_CHUNK)``; every build option of a config is a build of
``csrc/trace.cu`` of its own (``kernels.trace.kernel_flags``). The JAX
entries with a key that has no counterpart are in ``NO_COUNTERPART``, with
the reason for that key. Every build is started at once (one ``nvcc`` each),
every renderer is built and checked before the timing: each variant at CHECK
(96x64, spp 2, depth 8) against the plain version under the same config and
the same compiled scene, bit for bit (``SQRT_RSQRT`` within
``tests/test_pallas.py``'s rtol 1e-5, atol 1e-6 and equal segments, since a
root of another form may move a path; ``LANE_GATE`` False there too, or else
within its statistical fallback ``LOOSE``, since the warp's gate may take a
grazing hit that the plain version's per-lane gate skips), raising on a
mismatch; then the full-size image against the first variant's, whose
differing pixels are printed and not raised on, as the JAX tool's ``!!`` (a
new compile order moves equal-t ties, and ``rsqrt`` and the warp's gate
differ by design). The timing runs REPS rounds round robin, in reverse on
odd rounds, each call a CUDA-event time of one render; a variant's line
gives its median ms, its Mrays/s and the per-round median of its ratio to
the first variant (the JAX tool's ``median``, the upper one), the pixels
that differ, and its build's registers, spill bytes and SASS instructions in
final's kernel variant (``spheres<1,0,0>``) and the extras one
(``spheres<1,1,0>``). The card's name and power limit come first and one
JSON line last. Env (the JAX tool's): SWEEP_SPP (32), SWEEP_REPS (3),
SWEEP_DEPTH (50), SWEEP_SCENE (final), SWEEP_WH (1200x800), SWEEP_ONLY (a
comma list of names; the first of them in the table's order is the
baseline).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import time

import torch

from myraytracer_tpu_torch.config import KernelConfig, RenderConfig
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.kernels import build as kbuild
from myraytracer_tpu_torch.kernels import trace
from myraytracer_tpu_torch.render.adaptive import (
    AdaptiveSession, _block_scores, select_blocks,
)
from myraytracer_tpu_torch.render.camera import pack_camera
from myraytracer_tpu_torch.render.session import wants_spatial_sort
from myraytracer_tpu_torch.scene.compile import compile_scene
from myraytracer_tpu_torch.scene.presets import get_scene

WIDTH, HEIGHT, DEPTH = 1200, 800, 50
# --variants: (name, {KernelConfig field or _PARTITION: value}). The JAX
# table's entries (tools/sweep.py:27-129) whose keys all have a counterpart,
# in its order, under its names and with its overrides; the port's
# defaults differ from JAX's in five sweep forms (config.KernelConfig), so
# an entry that sets a JAX default may be the port's baseline ("guard",
# "w1", "window-old", "unmerged", "lane-gate"). Then the port's own.
VARIANTS = [
    ("baseline", {}),
    ("guard", {"SQRT_GUARD": True}),
    ("w1", {"SWEEP_WIDTH": 1}),
    ("w2", {"SWEEP_WIDTH": 2}),
    ("w8", {"SWEEP_WIDTH": 8}),
    ("w16", {"SWEEP_WIDTH": 16}),
    ("w4-chunk64", {"CULL_CHUNK": 64}),
    ("w4-chunk96", {"CULL_CHUNK": 96}),
    ("window-old", {"WINDOW_FUSE": False}),
    ("static-cam", {"STATIC_CAM": True}),
    ("chunk32-s4", {"SUPER": 4, "SUPER_MIN": 4}),
    ("chunk16-s8", {"CULL_CHUNK": 16, "SUPER": 8, "SUPER_MIN": 8}),
    ("chunk16-s4", {"CULL_CHUNK": 16, "SUPER": 4, "SUPER_MIN": 4}),
    ("chunk8-s8", {"CULL_CHUNK": 8, "SUPER": 8, "SUPER_MIN": 8}),
    ("no-cull", {"FORCE_CULL": False}),
    ("chunk128", {"CULL_CHUNK": 128}),
    ("chunk32", {"CULL_CHUNK": 32}),
    ("no-cull-unrolled", {"FORCE_CULL": False, "UNROLL_MAX": 512}),
    ("chunk16", {"CULL_CHUNK": 16}),
    ("chunk24", {"CULL_CHUNK": 24}),
    ("chunk48", {"CULL_CHUNK": 48}),
    ("merged", {"MERGED_FETCH": True}),
    ("merged-unrolled", {"MERGED_FETCH": True, "FORCE_CULL": False,
                         "UNROLL_MAX": 512}),
    ("merged-chunk32", {"MERGED_FETCH": True, "CULL_CHUNK": 32}),
    ("unmerged", {"MERGED_FETCH": False}),
    ("chunk96", {"CULL_CHUNK": 96}),
    ("tri64", {"TRI_CHUNK": 64}),
    ("tri32", {"TRI_CHUNK": 32}),
    ("tri16", {"TRI_CHUNK": 16}),
    ("tri8", {"TRI_CHUNK": 8}),
    ("tri16-s16", {"TRI_CHUNK": 16, "SUPER": 16}),
    ("tri32-s4", {"TRI_CHUNK": 32, "SUPER": 4}),
    ("tri128", {"TRI_CHUNK": 128}),
    ("tri32-s16", {"TRI_CHUNK": 32, "SUPER": 16}),
    ("s16", {"SUPER": 16}),
    ("s32", {"SUPER": 32}),
    ("s4", {"SUPER": 4}),
    ("morton", {"_PARTITION": "morton"}),
    ("lane-gate", {"LANE_GATE": True}),
    ("kd", {"_PARTITION": "kd"}),
    ("kd-lane", {"_PARTITION": "kd", "LANE_GATE": True}),
    ("kd-chunk16", {"_PARTITION": "kd", "CULL_CHUNK": 16}),
    ("kd-chunk16-s8", {"_PARTITION": "kd", "CULL_CHUNK": 16,
                       "SUPER": 8, "SUPER_MIN": 8}),
    ("kd-chunk24", {"_PARTITION": "kd", "CULL_CHUNK": 24}),
    ("kd-chunk48", {"_PARTITION": "kd", "CULL_CHUNK": 48}),
    ("rsqrt", {"SQRT_RSQRT": True}),
    ("chunk48-m", {"CULL_CHUNK": 48}),
    ("kd-chunk64", {"_PARTITION": "kd", "CULL_CHUNK": 64}),
    ("kd-chunk96", {"_PARTITION": "kd", "CULL_CHUNK": 96}),
    ("kd-chunk128", {"_PARTITION": "kd", "CULL_CHUNK": 128}),
    ("chunk40", {"CULL_CHUNK": 40}),
    ("chunk56", {"CULL_CHUNK": 56}),
    # The port's own: JAX's default forms one at a time, the warp's tile,
    # and JAX's five default forms together.
    ("no-guard", {"SQRT_GUARD": False}),
    ("window-fuse", {"WINDOW_FUSE": True}),
    ("warp-gate", {"LANE_GATE": False}),
    ("tile-w8", {"TILE_W": 8}),
    ("tile-w32", {"TILE_W": 32}),
    ("jax-sweep", {"SQRT_GUARD": False, "WINDOW_FUSE": True, "SWEEP_WIDTH": 4,
                   "MERGED_FETCH": True, "LANE_GATE": False}),
]
PORT_VARIANTS = ("no-guard", "window-fuse", "warp-gate", "tile-w8", "tile-w32", "jax-sweep")
# JAX keys with no counterpart in the port, and why.
NO_COUNTERPART_KEYS = {
    "DEFAULT_TILE_ROWS": "Mosaic's vector tile of 128-lane rows; the port lays a warp's 32 "
                         "rays over the image as TILE_W x 32/TILE_W pixels (tile-w8, tile-w32)",
    "BLOCK_W": "Mosaic's pixel block for the tile-to-pixel map; the port's is the warp tile "
               "(TILE_W), and the adaptive block stays 64x32 so that block ids match",
    "GATED_FETCH": "the port reads the winner's record by its index after the sweep, or "
                   "carries it (MERGED_FETCH): there is no fetch sweep to gate",
    "_NO_STATIC_IOR": "the port's kernels always read the IOR off the scene: its baseline is "
                      "JAX's dyn-ior",
}
# The JAX entries with such a key: (name, overrides, reason).
NO_COUNTERPART = [
    (name, overrides, "; ".join(NO_COUNTERPART_KEYS[k] for k in overrides
                                if k in NO_COUNTERPART_KEYS))
    for name, overrides in [
        ("w4-tile8", {"DEFAULT_TILE_ROWS": 8}),
        ("w4-tile24", {"DEFAULT_TILE_ROWS": 24}),
        ("block32", {"BLOCK_W": 32}),
        ("block128", {"BLOCK_W": 128}),
        ("ungated-fetch", {"GATED_FETCH": False}),
        ("no-cull+ungated", {"FORCE_CULL": False, "GATED_FETCH": False}),
        ("tile8", {"DEFAULT_TILE_ROWS": 8}),
        ("dyn-ior", {"_NO_STATIC_IOR": True}),
        ("tile24", {"DEFAULT_TILE_ROWS": 24}),
        ("tile32", {"DEFAULT_TILE_ROWS": 32}),
        ("tile24-chunk96", {"DEFAULT_TILE_ROWS": 24, "CULL_CHUNK": 96}),
        ("tile24-chunk128", {"DEFAULT_TILE_ROWS": 24, "CULL_CHUNK": 128}),
        ("mesh-tile8", {"DEFAULT_TILE_ROWS": 8}),
        ("mesh-tile8-tri32", {"DEFAULT_TILE_ROWS": 8, "TRI_CHUNK": 32}),
        ("kd-chunk64-t24", {"_PARTITION": "kd", "CULL_CHUNK": 64,
                            "DEFAULT_TILE_ROWS": 24}),
    ]
]
# The check every variant passes before its timing: width, height, spp, depth.
CHECK = (96, 64, 2, 8)
# The kernel variants whose build figures a line gives: final's (the
# general sweep, gates staged) and the extras one.
VARIANT_KERNELS = ("spheres<1,0,0>", "spheres<1,1,0>")

FRAMES = (1, 4, 16, 64)
WINDOWS = (1, 2, 4, 8, 16)
PASSES = 2
STAGING_SCENES = ("final", "spheres:100", "mesh:5")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def scene_args(name: str, width: int, height: int, device):
    """(compiled scene on ``device``, packed camera or None, sky) as the
    session builds them."""
    world = get_scene(name)
    scene = compile_scene(world, spatial_sort=wants_spatial_sort(world), device=device)
    cam = None
    if not world.camera.reference_mode:
        cam = torch.from_numpy(pack_camera(world.camera, width, height)).to(device)
    return scene, cam, world.ambient


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds of ``reps`` calls of ``fn`` on the current stream (CUDA
    events around them all), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def frame_ms(k: int):
    """The uniform kernel on the final scene at spp 1 with ``k`` frames a
    launch, about 64 frames in all: (ms per frame, Mrays/s)."""
    scene, cam, sky = scene_args("final", WIDTH, HEIGHT, "cuda")
    tables = trace.gate_tables(scene)
    key = crng.key_from_seed(0)
    launches = max(1, 64 // k)
    segs = []

    def launch():
        _, s = trace.trace_spheres(scene, cam, key, WIDTH, HEIGHT, 0, HEIGHT, 0, 1,
                                   DEPTH, 1e-3, 1e4, sky, frames=k, tables=tables)
        segs.append(s)

    ms = cuda_ms(launch, launches)
    seg_per_launch = float(segs[-1].sum(dtype=torch.float64).item())
    return ms / (launches * k), seg_per_launch * launches / ms / 1e3


def adaptive_ms(windows: int, rounds: int = 3):
    """An adaptive session on the final scene at spp 8 with ``windows``
    windows a round, after its bootstrap: (kernel ms per window of one
    round's launch, session ms per round over ``rounds`` rounds, session
    Mrays/s, n_sel)."""
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples_per_frame=8,
                       ray_depth=DEPTH, backend="cuda", frame_batch=windows)
    s = AdaptiveSession(get_scene("final"), cfg)
    s.bootstrap()
    _, s1, s2, _, r_b, cursor = s._state
    ids = select_blocks(_block_scores(s1, s2, r_b)[: s.n_blocks], s.n_sel)
    kern = cuda_ms(lambda: s._render(s.scene, s.key, ids, cursor[ids]), 2) / 2
    segs0 = s.segments_traced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        s.step()
    segs = s.segments_traced - segs0  # waits for the rounds
    dt = time.perf_counter() - t0
    return kern / windows, dt * 1e3 / rounds, segs / dt / 1e6, s.n_sel


def staging_ms(name: str, reps: int = 5, width: int = WIDTH, height: int = HEIGHT,
               depth: int = DEPTH) -> dict:
    """The uniform kernel on scene ``name`` at spp 1 with the default
    staging plan and with nothing staged (gate and primitive tables read
    from global memory), ``reps`` one-launch CUDA-event times each, in
    turns, each after a warm-up launch. The two launches must be bitwise equal.
    Returns the plans (gates, spheres, triangles, bytes) and the times."""
    scene, cam, sky = scene_args(name, width, height, "cuda")
    key = crng.key_from_seed(0)
    tables = {"staged": trace.gate_tables(scene),
              "global": trace.gate_tables(scene, KernelConfig(SMEM_LIMIT=0))}
    out, ms = {}, {k: [] for k in tables}

    def launch(k):
        out[k] = trace.trace_spheres(scene, cam, key, width, height, 0, height, 0, 1, depth,
                                     1e-3, 1e4, sky, tables=tables[k])

    for _ in range(reps):
        for k in tables:
            ms[k].append(cuda_ms(lambda: launch(k), 1))
    if not all(torch.equal(a, b) for a, b in zip(out["staged"], out["global"])):
        raise AssertionError(f"{name}: the launch that stages nothing differs from the default")
    return {"scene": name, "width": width, "height": height, "depth": depth,
            "plan": {k: [int(v) for v in trace.staging_of(t, "cuda")] for k, t in tables.items()},
            "ms": ms}


def settings(env) -> dict:
    """``--variants``' knobs from ``env``, with the JAX tool's defaults."""
    width, height = (int(x) for x in env.get("SWEEP_WH", "1200x800").split("x"))
    only = env.get("SWEEP_ONLY")
    names = [n for n, _ in VARIANTS]
    if only:
        unknown = [n for n in only.split(",") if n not in names]
        if unknown:
            raise ValueError(f"SWEEP_ONLY: no variants {unknown}")
    return dict(spp=int(env.get("SWEEP_SPP", "32")), reps=int(env.get("SWEEP_REPS", "3")),
                depth=int(env.get("SWEEP_DEPTH", "50")), scene=env.get("SWEEP_SCENE", "final"),
                width=width, height=height,
                variants=[(n, o) for n, o in VARIANTS if not only or n in only.split(",")])


def option_builds():
    """(name, config) of each distinct build of ``csrc/trace.cu`` that
    ``VARIANTS`` reaches besides the default one, under the first entry's
    name."""
    seen, out = {trace.kernel_flags(None)}, []
    for name, overrides in VARIANTS:
        cfg = config_of(overrides)
        flags = trace.kernel_flags(cfg)
        if flags not in seen:
            seen.add(flags)
            out.append((name, cfg))
    return out


def config_of(overrides: dict) -> KernelConfig:
    """The ``KernelConfig`` of a ``VARIANTS`` entry (its ``_`` keys go to
    the scene's compile)."""
    return KernelConfig(**{k: v for k, v in overrides.items() if not k.startswith("_")})


def median(xs):
    """The JAX tool's median: the upper one of an even count."""
    xs = sorted(xs)
    return xs[len(xs) // 2]


def round_ratios(times: dict, base: str) -> dict:
    """Each variant's median over the rounds of its time over the
    baseline's in the same round (the JAX tool's per-round ratio)."""
    reps = len(times[base])
    return {name: median([t[r] / times[base][r] for r in range(reps)])
            for name, t in times.items()}


def build_figures(config: KernelConfig) -> dict:
    """Registers, spill bytes and SASS instructions of ``VARIANT_KERNELS``
    in ``config``'s build (built already)."""
    lib = kbuild.library_path(trace.SOURCE, trace.kernel_flags(config))
    regs = trace.variant_registers(lib.with_suffix(".log").read_text())
    insns = trace.sass_instructions(kbuild.sass(lib))
    return {v: {"registers": regs[v][0], "spill_bytes": regs[v][1], "sass": insns[v]}
            for v in VARIANT_KERNELS}


# The contract of the TPU kernel with its oracle (tests/test_pallas.py), and
# its statistical fallback (tests/test_torch_trace.py), for the builds that
# are not bitwise their plain version: the rsqrt root is held to STRICT,
# the warp's gate (LANE_GATE False), which may take a grazing hit the
# plain version's per-lane gate skips, to STRICT or else LOOSE.
STRICT = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5, pixel_frac=0.98, mean_rel=1e-4, segs_rel=0.01)


def within_loose(img, want, segs: float, want_segs: float) -> bool:
    """LOOSE: pixels within rtol/atol on ``pixel_frac`` of the image, the
    means and the segments within their relative bounds."""
    close = torch.isclose(img, want, rtol=LOOSE["rtol"], atol=LOOSE["atol"]).all(-1)
    mean_rel = abs(float(img.mean()) - float(want.mean())) / max(abs(float(want.mean())), 1e-30)
    return (float(close.float().mean()) >= LOOSE["pixel_frac"] and mean_rel <= LOOSE["mean_rel"]
            and abs(segs - want_segs) <= LOOSE["segs_rel"] * max(want_segs, 1.0))


def check_plain(name: str, config: KernelConfig, got, plain, spp: int) -> float:
    """Hold a variant's render at CHECK to the plain version's sums and
    segments: bitwise; ``SQRT_RSQRT`` within STRICT with equal segments;
    ``LANE_GATE`` False within STRICT with equal segments, or else LOOSE.
    Raises on a mismatch; returns max |d|."""
    img, segs = got
    sums, psegs = plain
    want = sums * (1.0 / spp)
    err = float((img - want).abs().max())
    segs, psegs = float(segs), float(psegs.sum(dtype=torch.float64))
    ok = segs == psegs and (torch.allclose(img, want, **STRICT) if not config.bitwise
                            else torch.equal(img, want))
    if not ok and not config.LANE_GATE:
        ok = within_loose(img, want, segs, psegs)
    if not ok or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{name}: the kernel differs from its plain version at "
                             f"{CHECK[0]}x{CHECK[1]}: max|d| {err}, segments {segs} vs {psegs}")
    return err


def _call_ms(fn, device) -> float:
    """Milliseconds of one call of ``fn``: CUDA events on the card, the
    host clock on the CPU."""
    if device == "cpu":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def variants_run(s: dict, out=print, device: str = "cuda") -> dict:
    """The A/B of ``s["variants"]`` (see the module's docstring). On
    ``device`` "cpu" (the tests' small runs) the renderers are the plain
    version, nothing is built and the build figures are None."""
    from myraytracer_tpu_torch.render.camera import pack_camera

    width, height, spp, depth, reps = s["width"], s["height"], s["spp"], s["depth"], s["reps"]
    world = get_scene(s["scene"], seed=0)
    mats = tuple(sorted({sp.material.type_id for sp in world.spheres}
                        | {m.material.type_id for m in world.meshes}))
    key = crng.key_from_seed(0)
    configs = [config_of(o) for _, o in s["variants"]]
    out(f"scene={s['scene']} {width}x{height} spp={spp} depth={depth} reps={reps}")
    t0 = time.perf_counter()
    if device != "cpu":
        trace.build_variants(configs)
    build_s = time.perf_counter() - t0
    cw, ch, cspp, cdepth = CHECK
    cam = None
    if not world.camera.reference_mode:
        cam = torch.from_numpy(pack_camera(world.camera, cw, ch)).to(device)
    scenes, plains, built, base_img = {}, {}, [], None
    for (name, overrides), cfg in zip(s["variants"], configs):
        part = (overrides.get("_PARTITION", "kd"), cfg.CULL_CHUNK)
        if part not in scenes:
            scenes[part] = compile_scene(world, spatial_sort=True, partition=part[0],
                                         partition_chunk=part[1], device=device)
        scene = scenes[part]
        check = trace.make_renderer(world.camera, cw, ch, cspp, cdepth, material_set=mats,
                                    sky=world.ambient, config=cfg)
        got = check(scene, key, 0)
        tables = check.tables(scene)
        # The plain version ignores every build option but the root's form.
        g = tables.gates
        pkey = (part, g.sph_cull, g.chunk, g.saabb is None, g.tri_cull, g.tri_chunk,
                g.tsaabb is None, g.super_w, g.sqrt_rsqrt)
        if pkey not in plains:
            plains[pkey] = trace.trace_spheres_plain(scene, cam, key, cw, ch, 0, ch, 0, cspp,
                                                     cdepth, 1e-3, 1e4, world.ambient,
                                                     tables=tables)
        err = check_plain(name, cfg, got, plains[pkey], cspp)
        render = trace.make_renderer(world.camera, width, height, spp, depth, material_set=mats,
                                     sky=world.ambient, config=cfg)
        t1 = time.perf_counter()
        img, segs = render(scene, key, 0)
        img = img.cpu()
        first_s = time.perf_counter() - t1
        row = {"name": name, "overrides": overrides, "flags": list(trace.kernel_flags(cfg)[
            len(kbuild.NVCC_FLAGS):]), "check_max_abs": err, "first_call_s": first_s,
            "segments": float(segs), "differing_px": 0, "max_diff": 0.0}
        if base_img is None:
            base_img = img
        elif not torch.equal(img, base_img):
            row["differing_px"] = int((img != base_img).any(dim=-1).sum())
            row["max_diff"] = float((img - base_img).abs().max())
            out(f"!! {name}: differs from baseline on {row['differing_px']} px "
                f"(maxdiff {row['max_diff']:.2e})")
        out(f"built {name} (first call {first_s:.1f}s; {cw}x{ch} check max|d| {err:.3g})")
        built.append((name, render, scene, row))
    times = {name: [] for name, *_ in built}
    for r in range(reps):  # round robin, in reverse on odd rounds
        for name, render, scene, _ in (built if r % 2 == 0 else built[::-1]):
            times[name].append(_call_ms(lambda: render(scene, key, 0), device))
    base = built[0][0]
    ratios = round_ratios(times, base)
    # Each build's figures, read from its report and its SASS, together.
    flags_of = [trace.kernel_flags(cfg) for cfg in configs]
    figures = dict.fromkeys(flags_of)
    if device != "cpu":
        first = {f: cfg for f, cfg in zip(flags_of, configs)}
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            figures = dict(zip(first, ex.map(build_figures, first.values())))
    rows = []
    for (name, _, _, row), flags in zip(built, flags_of):
        t = median(times[name])
        row.update(ms=t, reps_ms=times[name], mrays_s=row["segments"] / t / 1e3,
                   ratio=ratios[name], build=figures[flags])
        rel = ("" if name == base
               else f"  ({(ratios[name] - 1) * 100:+.1f}% vs {base}, per-round median)")
        fig = "no build" if figures[flags] is None else "; ".join(
            f"{v} {f['registers']} regs, {f['spill_bytes']} B spill, {f['sass']} SASS"
            for v, f in figures[flags].items())
        out(f"{name:18s} {t:8.1f} ms  {row['mrays_s']:6.1f} Mrays/s{rel}  "
            f"{row['differing_px']} px differ; {fig}")
        rows.append(row)
    return {"tool": "sweep --variants", "scene": s["scene"], "width": width, "height": height,
            "spp": spp, "depth": depth, "reps": reps, "build_s": build_s, "baseline": base,
            "rows": rows}


def variants_main(env=None) -> int:
    from myraytracer_tpu_torch import quality

    if quality.card_missing("sweep --variants"):
        return 2
    s = settings(os.environ if env is None else env)
    print(card(), flush=True)
    res = variants_run(s, out=lambda line: print(line, flush=True))
    print(json.dumps(res), flush=True)
    return 0


def main(argv=()) -> int:
    if list(argv) == ["--variants"]:
        return variants_main()
    if argv:
        print("usage: python -m myraytracer_tpu_torch.sweep [--variants]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sweep: no CUDA GPU", file=sys.stderr)
        return 2
    print(card(), flush=True)
    for rep in range(PASSES):
        for name in STAGING_SCENES:
            print(json.dumps({"sweep": "staging", "rep": rep, **staging_ms(name)}), flush=True)
        for k in FRAMES:
            ms, mrays = frame_ms(k)
            print(json.dumps({"sweep": "frames", "rep": rep, "K": k, "spp": 1,
                              "ms_per_frame": ms, "kernel_mrays_s": mrays}), flush=True)
        for f in WINDOWS:
            kms, rms, mrays, n_sel = adaptive_ms(f)
            print(json.dumps({"sweep": "windows", "rep": rep, "F": f, "spp": 8,
                              "n_sel": n_sel, "kernel_ms_per_window": kms,
                              "session_ms_per_round": rms,
                              "session_mrays_s": mrays}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
