"""Progressive render session.

Port of ``myraytracer_tpu.render.session``: owns the accumulation
framebuffer and drives frame steps. Accumulation reproduces the
reference's ``State::redraw`` blend (``lib.rs:299-306``,
``shader.wgsl:385``):

    fb' = mix(frame_mean, fb, w)   with   w = min(max_weight, n / (n + 1))

where ``n`` counts completed frames and the first weight is 0
(``lib.rs:424``): with ``max_weight = 1`` the framebuffer is the exact
running mean over frames.

Sessions checkpoint: ``(framebuffer, frame_count, sample_cursor, seed)``
round-trips through an npz in the JAX package's format (version 3), and a
resumed session continues the identical sample stream (counter-based RNG).
The backend that produced the stream (``torch`` or ``cuda``) is part of
the checkpoint, and a resume on the other one is refused.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import NamedTuple

import numpy as np
import torch

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.kernels import blend as kblend
from myraytracer_tpu_torch.render.camera import pack_camera
from myraytracer_tpu_torch.render.lights import extract_lights
from myraytracer_tpu_torch.scene import api
from myraytracer_tpu_torch.scene.compile import SCENE_LEAVES, compile_scene, leaf
from myraytracer_tpu_torch.utils import profiling

CHECKPOINT_VERSION = 3

# Spheres or triangles above which the compiler sorts the scene spatially,
# as the JAX session does; the order decides equal-t ties, so it must match.
SPATIAL_SORT_MIN = 64
# Triangles above which the plain integrator's scene carries a triangle BVH,
# as the JAX jnp session's does (the CUDA kernel sweeps behind its gates).
TRIANGLE_BVH_MIN = 512


def wants_spatial_sort(world: api.World) -> bool:
    """The JAX sessions' rule (``render/session.py:118``,
    ``render/adaptive.py:336``): sort when either table passes 64."""
    return (len(world.spheres) > SPATIAL_SORT_MIN
            or world.triangle_count > SPATIAL_SORT_MIN)


def wants_triangle_bvh(world: api.World, backend: str) -> bool:
    """The JAX sessions' rule (``render/session.py:116-121``,
    ``render/adaptive.py:337``) for the port: the plain torch integrator
    traverses a BVH past 512 triangles; the kernel never gets one."""
    return backend == "torch" and world.triangle_count > TRIANGLE_BVH_MIN


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` in f32 with one rounding, as XLA's CPU backend computes
    the products it contracts into FMAs.

    The f32 product is exact in f64; the f64 sum is rounded to odd (its
    rounding error, from TwoSum, sets the last bit), so the final rounding
    to f32 is the correctly rounded fused result on every device.
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def blend_plain(fb_hwc: torch.Tensor, imgs_kchw: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Blend K per-frame images ([K,3,H,W]) into the framebuffer ([H,W,3])
    in turn, with per-frame f32 weights: ``img*(1-w) + fb*w``.

    XLA compiles the JAX package's blend with the ``fb*w`` product fused
    into the add (one rounding), so this does the same (``fma_f32``): the
    result is bitwise the JAX blend's, on every device. The plain version
    of ``kernels.blend.blend``.
    """
    fb = fb_hwc.permute(2, 0, 1)
    for img, w in zip(imgs_kchw, weights):
        fb = fma_f32(fb, w, img * (1.0 - w))
    return fb.permute(1, 2, 0).contiguous()


def _blend_chain(fb_hwc: torch.Tensor, imgs_kchw: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """A step's blend (``blend_plain``'s arguments and result): on CPU
    tensors the plain chain, otherwise the CUDA kernel in one launch
    (``kernels.blend.blend``, bitwise the chain), which raises on what it
    does not take."""
    if all(t.device.type == "cpu" for t in (fb_hwc, imgs_kchw, weights)):
        return blend_plain(fb_hwc, imgs_kchw, weights)
    return kblend.blend(fb_hwc, imgs_kchw, weights)


def scene_fingerprint(scene) -> str:
    """Content hash of the compiled scene's tensors (not the camera).

    Hashes the same leaves in the same order, dtype and shape as the JAX
    package's ``scene_fingerprint`` (its pytree order: the sphere leaves,
    then a mesh scene's triangle leaves), so one world gives one
    fingerprint in both packages.
    """
    h = hashlib.sha256()
    for name in SCENE_LEAVES:
        t = leaf(scene, name)
        if t is None:
            continue
        arr = t.detach().cpu().numpy()
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


def camera_view(cam: api.Camera) -> dict:
    """A camera's fields as checkpoint metadata (JSON)."""
    return dataclasses.asdict(cam)


def camera_from_view(view: dict) -> api.Camera:
    return api.Camera(**{k: tuple(v) if isinstance(v, list) else v for k, v in view.items()})


class Accumulation(NamedTuple):
    """A session's accumulation state, replaced whole by one store."""

    framebuffer: torch.Tensor
    frame_count: int  # lib.rs:232 sample_count
    sample_cursor: int  # global sample index (per pixel)


def resolve_device_backend(backend: str) -> str:
    """``auto`` → ``cuda``: the port renders on the card unless the caller
    names ``torch`` (the plain integrator on the CPU) or ``cpu`` (the native
    C++ renderer)."""
    if backend == "auto":
        return "cuda"
    if backend not in ("cuda", "torch", "cpu"):
        raise ValueError(f"unknown backend {backend!r}: use auto|cuda|torch|cpu")
    return backend


def session_scene(world: api.World, backend: str, width: int, height: int):
    """The compiled scene a session of ``backend`` renders, on its device
    (the card for ``cuda``), with the packed runtime camera of a general
    camera at ``width`` x ``height``: ``set_camera`` swaps it, and the
    renderer reads it each frame."""
    device = torch.device("cuda" if backend == "cuda" else "cpu")
    scene = compile_scene(
        world, spatial_sort=wants_spatial_sort(world), device=device,
        triangle_bvh=wants_triangle_bvh(world, backend),
    )
    if not world.camera.reference_mode:
        scene = scene._replace(cam=torch.from_numpy(
            pack_camera(world.camera, width, height)
        ).to(device))
    return scene


def renderer_kwargs(world: api.World, config: RenderConfig, frames: int = 1) -> dict:
    """The keyword arguments a session passes its renderer factory after
    (camera, width, height, samples_per_frame, ray_depth)."""
    return dict(
        t_min=config.t_min,
        t_max=config.t_max,
        sample_batch=config.resolve_sample_batch(),
        material_set=world.material_set or None,
        frames=frames,
        sky=world.ambient,
        nee_lights=extract_lights(world) if config.nee else None,
        texture_set=world.texture_set or None,
        qmc=config.qmc,
        rr=config.rr,
    )


class RenderSession:
    """Progressive accumulation over frames of ``samples_per_frame`` samples.

    ``renderer_factory`` builds the frame renderer (``make_renderer`` of
    ``render.integrator`` or ``kernels.trace``, or ``make_cpu_factory`` of
    ``native.cpu_backend``). By default the config's backend picks it
    through ``dispatch``: ``auto`` and ``cuda`` render with the CUDA kernel
    on the GPU (and raise without one), ``torch`` with the plain integrator
    on the CPU, ``cpu`` with the native renderer. The recorded backend is
    the one that renders (checkpoint provenance).
    """

    def __init__(
        self,
        world: api.World,
        config: RenderConfig = RenderConfig(),
        renderer_factory=None,
    ):
        with profiling.span("session.init"):
            self.world = world
            self.config = config
            # The view being rendered: set_camera's last camera, or the one a
            # checkpoint recorded (the base of the viewer's orbits).
            self.camera = world.camera
            self.width, self.height = config.resolve_size()
            if renderer_factory is None:
                from myraytracer_tpu_torch.render import dispatch

                resolved = dispatch.resolve_backend(config)
                renderer_factory = dispatch.renderer_factory(resolved, world, config)
            else:
                resolved = resolve_device_backend(config.backend)
            self.backend_resolved = resolved
            self.device = torch.device("cuda" if resolved == "cuda" else "cpu")
            # The routing model's CPU rate for this world, which the CLI holds
            # the first steady-state frame to (cli._check_routing_prediction).
            self.routing_prediction = None
            if resolved == "cpu":
                from myraytracer_tpu_torch.native import cpu_backend

                pred = cpu_backend.route_prediction(world, config)
                self.routing_prediction = pred[0] if pred else None
            self.scene = session_scene(world, resolved, self.width, self.height)
            self.key = crng.key_from_seed(config.seed)

            self.frame_batch = config.resolve_frame_batch(resolved)
            if self.frame_batch > 1 and config.shard not in ("none", "tiles"):
                # Tile stripes keep contiguous sample windows across frame
                # buckets; sample and hybrid shards do not (parallel/sharding.py).
                raise ValueError("frame_batch > 1 requires shard 'none' or 'tiles'")
            self._render = renderer_factory(
                world.camera,
                self.width,
                self.height,
                config.samples_per_frame,
                config.ray_depth,
                **renderer_kwargs(world, config, self.frame_batch),
            )
            # One attribute, so that a step commits with one store: an interrupt
            # (Ctrl-C under --frames 0) between separate stores could leave a
            # framebuffer with a frame that the counters do not count, and a
            # resume would then repeat a window of samples.
            self._acc = Accumulation(torch.zeros(
                (self.height, self.width, 3), dtype=torch.float32, device=self.device
            ), 0, 0)
            # A sharded renderer's mesh and the rows each entry renders: under
            # several processes a rank's framebuffer holds only its own rows.
            self.mesh = getattr(self._render, "mesh", None)
            self.ndev = self.mesh.size if self.mesh is not None else 1
            self._rows = getattr(self._render, "rows", None)
            # Per-step segment totals stay on the device until read, so a step
            # does not wait for the device; they fold into a float64 host total.
            self._segs_total = 0.0
            self._segs_pending = []
            self._fingerprint = None

    @property
    def framebuffer(self) -> torch.Tensor:
        return self._acc.framebuffer

    @framebuffer.setter
    def framebuffer(self, fb: torch.Tensor) -> None:
        self._acc = self._acc._replace(framebuffer=fb)

    @property
    def frame_count(self) -> int:
        return self._acc.frame_count

    @frame_count.setter
    def frame_count(self, n: int) -> None:
        self._acc = self._acc._replace(frame_count=n)

    @property
    def sample_cursor(self) -> int:
        return self._acc.sample_cursor

    @sample_cursor.setter
    def sample_cursor(self, n: int) -> None:
        self._acc = self._acc._replace(sample_cursor=n)

    @property
    def segments_traced(self) -> float:
        """Total ray segments traced (waits for pending device work); under
        several processes every rank's, an ``all_reduce`` that every rank
        must join."""
        from myraytracer_tpu_torch.parallel.sharding import total_segments

        pending, self._segs_pending = self._segs_pending, []
        if pending or (self.mesh is not None and self.mesh.proc is not None):
            with profiling.host_sync("session.segments"):
                self._segs_total += total_segments(pending, self.mesh)
        return self._segs_total

    def fetch_framebuffer(self) -> torch.Tensor:
        """The whole framebuffer on the session's device: the framebuffer
        itself, unless it is split across processes, where every rank's
        rows are gathered (``sharding.fetch_array``, a collective)."""
        if self._rows is None or self._rows.mesh.proc is None:
            return self.framebuffer
        from myraytracer_tpu_torch.parallel.sharding import fetch_array

        with profiling.host_sync("session.fetch_gather"):
            return torch.from_numpy(fetch_array(self.framebuffer, self._rows)).to(self.device)

    @property
    def accumulated_spp(self) -> int:
        return self.frame_count * self.config.samples_per_frame

    def step(self) -> torch.Tensor:
        """Render one step of ``frame_batch`` frames and blend it in; returns
        the new framebuffer. The state changes only once the render and the
        blend have returned, in one store."""
        with profiling.span("session.step"):
            acc = self._acc
            next_cursor = (
                acc.sample_cursor
                + self.config.samples_per_frame * self.frame_batch
            )
            # QMC reserves the top two draw words for its per-pixel scrambles.
            cap = crng.M32 - (crng.QMC_SCRAMBLE_SLOTS if self.config.qmc else 0)
            if next_cursor * crng.DRAWS_PER_SAMPLE > cap:
                # The draw index is sample_id * DRAWS_PER_SAMPLE + slot in
                # uint32: past ~16.9M samples/pixel it would wrap and silently
                # reuse the earliest samples' draws.
                raise RuntimeError(
                    f"sample cursor {next_cursor} would overflow the uint32 "
                    f"draw-index space ({crng.M32 // crng.DRAWS_PER_SAMPLE} "
                    f"samples/pixel max): the RNG stream would alias"
                )
            img, segs = self._render(self.scene, self.key, acc.sample_cursor)
            # Weights from the count of previously completed frames (0 for the
            # first frame, lib.rs:424), in f32 as the JAX session passes them.
            cap = self.config.max_framebuffer_weight
            ws = torch.tensor(
                [
                    min(cap, n / (n + 1)) if n else 0.0
                    for n in range(acc.frame_count, acc.frame_count + self.frame_batch)
                ],
                dtype=torch.float32,
            )
            if self.device.type == "cuda":
                # From pinned memory, without waiting: a pageable copy would
                # sync the stream, so the host could not queue the next step
                # while the card renders this one.
                ws = ws.pin_memory().to(self.device, non_blocking=True)
            if self.frame_batch == 1:
                img = img.permute(2, 0, 1)[None]
            with profiling.span("session.blend"):
                fb = _blend_chain(acc.framebuffer, img, ws)
            frames = acc.frame_count + self.frame_batch
            if profiling.debug_nans():
                profiling.check_finite(fb, f"frame {frames} (sample cursor {acc.sample_cursor})")
            self._acc = Accumulation(fb, frames, next_cursor)
            self._segs_pending.append(segs)
            return fb

    def run(self, frames: int) -> torch.Tensor:
        """Run at least ``frames`` progressive frames; ``frames <= 0`` is a
        no-op."""
        for _ in range(max(0, -(-frames // self.frame_batch))):
            self.step()
        if self.device.type == "cuda":
            with profiling.host_sync("session.run"):
                torch.cuda.synchronize(self.device)
        return self.framebuffer

    def set_camera(self, cam: api.Camera) -> None:
        """Move the camera: repack the runtime camera operand and reset the
        accumulation (the sample stream continues from the cursor)."""
        if cam.reference_mode or self.world.camera.reference_mode:
            raise ValueError(
                "the reference-mode camera is fixed by contract; "
                "use a general (lookfrom/lookat) camera scene to move"
            )
        with profiling.span("session.set_camera"):
            packed = torch.from_numpy(pack_camera(cam, self.width, self.height))
            with profiling.host_sync("session.camera_upload"):
                packed = packed.to(self.device)
            self.scene = self.scene._replace(cam=packed)
            self.camera = cam
            self._acc = self._acc._replace(
                framebuffer=torch.zeros_like(self._acc.framebuffer), frame_count=0)

    # -- checkpoint / resume --------------------------------------------------

    @property
    def scene_fingerprint(self) -> str:
        """Content hash of the compiled scene (cached; excludes camera)."""
        if self._fingerprint is None:
            fp = scene_fingerprint(self.scene)
            if self.world.ambient is not None:
                # The background color changes the image but lives outside
                # the compiled tensors: fold it into the provenance hash.
                h = hashlib.sha256(fp.encode())
                h.update(repr(self.world.ambient).encode())
                fp = h.hexdigest()[:16]
            self._fingerprint = fp
        return self._fingerprint

    def save_checkpoint(self, path) -> None:
        """Save accumulation state to ``path`` (npz).

        ``path=None`` joins the framebuffer's gather and the segment count's
        reduction without writing a file: under several processes those are
        collectives every rank must join, while one rank owns the file.
        """
        meta = {
            "version": CHECKPOINT_VERSION,
            "width": self.width,
            "height": self.height,
            "samples_per_frame": self.config.samples_per_frame,
            "ray_depth": self.config.ray_depth,
            "max_framebuffer_weight": self.config.max_framebuffer_weight,
            "seed": self.config.seed,
            "t_min": self.config.t_min,
            "t_max": self.config.t_max,
            "nee": self.config.nee,
            "nee_estimator": "mis" if self.config.nee else None,
            "qmc": self.config.qmc,
            "rr": self.config.rr,
            # Exact-continuation provenance: the scene content, the compute
            # path that produced the stream, and the sharding mode.
            "scene": self.scene_fingerprint,
            "backend": self.backend_resolved,
            "shard": self.config.shard,
        }
        if self.scene.cam is not None:
            meta["view"] = camera_view(self.camera)
        arrays = dict(
            framebuffer=self.fetch_framebuffer().cpu().numpy(),
            frame_count=np.int64(self.frame_count),
            sample_cursor=np.int64(self.sample_cursor),
            segments_traced=np.float64(self.segments_traced),
            meta=json.dumps(meta),
        )
        if self.scene.cam is not None:
            # The runtime camera is part of the accumulation state.
            arrays["camera"] = self.scene.cam.cpu().numpy()
        if path is not None:
            np.savez(pathlib.Path(path), **arrays)

    def load_checkpoint(self, path) -> None:
        with np.load(pathlib.Path(path), allow_pickle=False) as data:
            self._load(data)

    def _load(self, data) -> None:
        meta = json.loads(str(data["meta"]))
        if meta["version"] != CHECKPOINT_VERSION:
            raise ValueError(f"checkpoint version {meta['version']} unsupported")
        if meta.get("adaptive"):
            raise ValueError(
                "adaptive checkpoint: resume it with "
                "AdaptiveSession.load_checkpoint (render/adaptive.py)"
            )
        for field in (
            "width", "height", "samples_per_frame", "ray_depth", "seed",
            "max_framebuffer_weight", "t_min", "t_max", "nee",
        ):
            have = getattr(self, field, None)
            if have is None:
                have = getattr(self.config, field)
            if meta[field] != have:
                raise ValueError(
                    f"checkpoint {field}={meta[field]} != session {have}"
                )
        if int(meta.get("rr", 0)) != self.config.rr:
            raise ValueError(
                f"checkpoint rr={meta.get('rr', 0)} != session "
                f"{self.config.rr}: different termination streams"
            )
        if bool(meta.get("qmc", False)) != self.config.qmc:
            raise ValueError(
                f"checkpoint qmc={meta.get('qmc', False)} != session "
                f"{self.config.qmc}: different sample streams"
            )
        if meta["scene"] != self.scene_fingerprint:
            raise ValueError(
                f"checkpoint scene fingerprint {meta['scene']} != session "
                f"{self.scene_fingerprint}: refusing to blend frames from "
                f"a different world"
            )
        if meta["backend"] != self.backend_resolved:
            raise ValueError(
                f"checkpoint backend={meta['backend']} != session "
                f"{self.backend_resolved}: streams from two compute paths "
                f"agree only statistically, so an exact resume must stay on "
                f"the producing backend"
            )
        if meta["shard"] != self.config.shard:
            raise ValueError(
                f"checkpoint shard={meta['shard']} != session "
                f"{self.config.shard}"
            )
        if "camera" in data:
            if self.scene.cam is None:
                raise ValueError(
                    "checkpoint carries a runtime camera but this session "
                    "was built for the fixed reference camera"
                )
            self.scene = self.scene._replace(
                cam=torch.from_numpy(data["camera"]).to(self.device)
            )
            self.camera = camera_from_view(meta["view"]) if "view" in meta else self.world.camera
        elif self.scene.cam is not None:
            raise ValueError(
                "checkpoint has no runtime camera (fixed reference view) "
                "but this session renders a positionable camera"
            )
        self._acc = Accumulation(torch.from_numpy(data["framebuffer"]).to(self.device),
                                 int(data["frame_count"]), int(data["sample_cursor"]))
        self._segs_total = float(data["segments_traced"])
        self._segs_pending = []


def render(
    world: api.World,
    config: RenderConfig = RenderConfig(),
    frames: int = 1,
    renderer_factory=None,
) -> np.ndarray:
    """One-shot convenience: run a session for ``frames`` frames on the
    config's backend and return the framebuffer on the host."""
    session = RenderSession(world, config, renderer_factory=renderer_factory)
    return session.run(frames).cpu().numpy()
