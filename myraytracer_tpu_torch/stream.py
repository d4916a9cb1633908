"""Progressive streaming ladder at small sample windows.

    python -m myraytracer_tpu_torch.stream

The counterpart of the JAX package's ``tools/stream.py``. The reference's
default workload is progressive accumulation at ``samples_per_frame=1``;
this tool measures pipelined streaming throughput -- every call dispatched
back to back, then forced in order, as the accumulation loop runs -- at
spp 1/4/8/32/125 on the final scene, where a call's fixed costs show. Each
call renders K frames (STREAM_BATCH); each K-frame stack is freed once it
is forced. On the card the dispatch loop refuses host syncs
(``quality.no_host_sync``); each row records its seconds (``dispatch_s``).

The renderer is the one a session builds for the config
(``dispatch.renderer_factory`` with ``session.renderer_kwargs``): unlike
the JAX tool, which passes no sky, an emissive scene renders under its own
black background.

Env knobs (the JAX tool's): STREAM_SPPS (1,4,8,32,125), STREAM_WH
(1200x800), STREAM_SCENE (final), STREAM_DEPTH (50), STREAM_MIN_SAMPLES
(256: calls per spp = max(2, ceil(MIN_SAMPLES / (spp K)))), STREAM_BACKEND
(``cuda``, or ``torch``: the plain version on the CPU; ``pallas`` and
``jnp`` name them too), STREAM_BATCH (frames a call K: an int, or ``auto``
= the port's own policy, ``RenderConfig.resolve_frame_batch``),
STREAM_SHARD (``none``, or ``tiles``: through
``parallel.sharding.make_tile_sharded_renderer`` on the default mesh).

Prints the card's name and power limit first (or that the plain version
runs on the CPU), the JAX tool's lines, and last one JSON line with every
row's numbers and the segments of each call. On ``cuda`` without a GPU it
exits non-zero and prints nothing on stdout.
"""

from __future__ import annotations

import json
import os
import sys
import time

from myraytracer_tpu_torch import quality
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.render import dispatch
from myraytracer_tpu_torch.render.session import renderer_kwargs


def settings(env) -> dict:
    width, height = (int(x) for x in env.get("STREAM_WH", "1200x800").split("x"))
    return dict(
        spps=[int(s) for s in env.get("STREAM_SPPS", "1,4,8,32,125").split(",")],
        width=width, height=height,
        depth=int(env.get("STREAM_DEPTH", "50")),
        scene=env.get("STREAM_SCENE", "final"),
        min_samples=int(env.get("STREAM_MIN_SAMPLES", "256")),
        backend=quality.backend_name(env.get("STREAM_BACKEND", "pallas")),
        batch=env.get("STREAM_BATCH", "1"),
        shard=env.get("STREAM_SHARD", "none"),
    )


def config_of(s: dict, spp: int) -> RenderConfig:
    """The render config of one rung; ``frame_batch`` is K."""
    cfg = RenderConfig(width=s["width"], height=s["height"], samples_per_frame=spp,
                       ray_depth=s["depth"], backend=s["backend"], shard=s["shard"])
    k = cfg.resolve_frame_batch(s["backend"]) if s["batch"] == "auto" else max(1, int(s["batch"]))
    return cfg.replace(frame_batch=k)


def make_renderer(s: dict, world, spp: int):
    """One rung's renderer, as a session builds it for ``config_of``, and
    its K."""
    cfg = config_of(s, spp)
    render = dispatch.renderer_factory(s["backend"], world, cfg)(
        world.camera, s["width"], s["height"], spp, s["depth"],
        **renderer_kwargs(world, cfg, frames=cfg.frame_batch))
    return render, cfg.frame_batch


def run(s: dict, out=print) -> dict:
    backend, width, height = s["backend"], s["width"], s["height"]
    if s["shard"] not in ("none", "tiles"):
        raise ValueError(f"STREAM_SHARD {s['shard']!r}: use none or tiles")
    world, scene = quality.setup(s["scene"], backend, width, height)
    key = crng.key_from_seed(0)
    out(f"scene={s['scene']} {width}x{height} depth={s['depth']} "
        f"backend={backend} shard={s['shard']} (pipelined streaming)")

    rows = []
    for spp in s["spps"]:
        render, K = make_renderer(s, world, spp)
        n_calls = max(2, -(-s["min_samples"] // (spp * K)))
        t0 = time.perf_counter()
        img, segs = render(scene, key, 0)
        quality.force(img)
        first_s = time.perf_counter() - t0
        # one forced steady-state warm call
        img, _ = render(scene, key, K * spp)
        quality.force(img)
        del img

        t0 = time.perf_counter()
        with quality.no_host_sync(backend):
            calls = [render(scene, key, (i + 2) * K * spp) for i in range(n_calls)]
        dispatch_s = time.perf_counter() - t0
        segments = []
        for j, (img, segs) in enumerate(calls):
            quality.force(img)  # force in order
            segments.append(float(segs))
            calls[j] = img = None  # free the K-frame stack
        dt = time.perf_counter() - t0
        n_frames = n_calls * K
        mrays = sum(segments) / dt / 1e6
        ms_frame = dt / n_frames * 1e3
        rows.append(dict(spp=spp, K=K, frames=n_frames, ms_per_frame=ms_frame, mrays_s=mrays,
                         first_call_s=first_s, dispatch_s=dispatch_s,
                         sample_bases=[(i + 2) * K * spp for i in range(n_calls)],
                         segments=segments))
        out(f"spp={spp:4d} K={K:3d}  {n_frames:4d} frames "
            f"{ms_frame:8.1f} ms/frame  {mrays:7.1f} Mrays/s "
            f"(first call {first_s:.0f}s)")

    out("\n| samples/frame | frame batch | ms/frame | Mrays/s/chip |")
    out("|---|---|---|---|")
    for r in rows:
        out(f"| {r['spp']} | {r['K']} | {r['ms_per_frame']:.1f} | {r['mrays_s']:.1f} |")
    return {"tool": "stream", "scene": s["scene"], "width": width, "height": height,
            "depth": s["depth"], "backend": backend, "shard": s["shard"], "rows": rows}


def main(env=None) -> int:
    s = settings(os.environ if env is None else env)
    if quality.card_missing("stream", s["backend"]):
        return 2
    print(quality.device_line(s["backend"]), flush=True)
    res = run(s, out=lambda line: print(line, flush=True))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
