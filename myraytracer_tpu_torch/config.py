"""Render configuration.

Analog of the reference's ``Args`` struct (``raytracer/src/lib.rs:19-37``;
CLI defaults at ``native-runner/src/main.rs:20-31``): same five knobs with
the same defaults, plus device-side controls (sample batching, kernel
backend, sharding mode) that have no reference counterpart. The fields and
defaults are those of ``myraytracer_tpu.config``, so a configuration means
the same render in both packages, the estimator's modes (``nee``, ``rr``,
``qmc``) included.

Size inference mirrors ``lib.rs:113-134``: a 0 width or height means
"derive" — one zero makes the image square from the other dimension; both
zero fall back to a default headless size (there is no window to follow on
a headless accelerator host).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from myraytracer_tpu_torch.scene.compile import _auto_tri_chunk

DEFAULT_WIDTH = 640
DEFAULT_HEIGHT = 360

# Auto batching on the CUDA kernels, from the sweeps on an NVIDIA H100 in
# PERF.md (final scene, 1200x800, depth 50). The uniform kernel takes frames
# until a launch holds about CUDA_FRAME_WINDOW samples per pixel: at spp 1,
# 16 frames a launch run a frame in about half the time of a one-frame
# launch (whose last paths leave the card idle while the queue drains), and
# 64 frames cut it by 3.5-5% more for 4x the bucket memory. An adaptive
# round takes windows until it holds about CUDA_ADAPTIVE_WINDOW samples, at
# most CUDA_ADAPTIVE_CAP windows (the largest count measured): at spp 8 the
# session's rate rose up to 16 windows, as the per-round score pass spreads
# over more samples.
CUDA_FRAME_WINDOW = 16
CUDA_ADAPTIVE_WINDOW = 128
CUDA_ADAPTIVE_CAP = 16

# The kernel's components that ``KernelConfig.ABLATE`` can run twice, in
# the order of their bits in ``csrc/trace.cu`` (MRT_ABLATE_*): the names of
# the JAX package's ``tools/ablate.py``.
ABLATE_COMPONENTS = ("hit", "gates", "fetch", "rng", "samplers", "scatter", "regen")
# KernelConfig.SWEEP_WIDTH's widths (the JAX tool's w1-w16) and TILE_W's
# tile widths (a warp's 32 lanes as TILE_W x 32/TILE_W pixels).
SWEEP_WIDTHS = (1, 2, 4, 8, 16)
TILE_WIDTHS = (8, 16, 32)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 0
    height: int = 0
    samples_per_frame: int = 1
    ray_depth: int = 50
    max_framebuffer_weight: float = 1.0

    # Device-side knobs (no reference counterpart).
    seed: int = 0
    t_min: float = 1e-3  # shader.wgsl:340
    t_max: float = 1e4  # shader.wgsl:340
    # Output transfer: a float exponent (2.0 = RTiOW's sqrt) or "srgb"
    # (piecewise sRGB encode, the inverse EOTF — what the reference's sRGB
    # surface format applies, lib.rs:1105-1107). Display-only: never part
    # of the sample stream.
    gamma: Union[float, str] = 2.0
    sample_batch: int = 0  # samples traced per vectorized pass; 0 = auto
    backend: str = "auto"  # "cuda" | "torch" | "cpu" | "auto" (= cuda)
    shard: str = "none"  # "none" | "tiles" | "samples" | "hybrid" (parallel/sharding.py)
    # Progressive frames rendered per device call (0 = auto). K > 1
    # batches K frames into one kernel launch with per-frame outputs,
    # bitwise identical to K separate frames.
    frame_batch: int = 0
    # Total frames the caller intends to render (0 = unbounded). Only a
    # hint: auto frame batching must not batch past the requested count
    # (e.g. --frames 2 at spp 1 would otherwise run a 64-frame window).
    max_frames: int = 0
    # Next-event estimation (direct light sampling): one shadow ray per
    # diffuse bounce toward a sampled light (render/lights.py). Unbiased;
    # a different sample stream than the default estimator (so it is part
    # of checkpoint provenance). No-op on scenes without DiffuseLight.
    nee: bool = False
    # Russian-roulette path termination (extension): 0 = off; N > 0 kills
    # paths probabilistically before tracing bounce N and beyond, with
    # survival p = clamp(max(throughput), 0.05, 0.95) and 1/p compensation —
    # unbiased, and it cuts the long-tail glass chains that otherwise run
    # to full ray_depth and gate the kernel's tile tails. A different
    # sample estimator (checkpoint provenance, like nee/qmc); the decision
    # stream rides a derived key so the main draws are unchanged.
    rr: int = 0
    # Low-discrepancy camera sampling: the sub-pixel jitter and lens-disk
    # dimension pairs come from a per-pixel Owen-scrambled Sobol (0,2)
    # sequence instead of threefry (core/rng.py) — better convergence per
    # sample on smooth integrands, still deterministic and backend/shard
    # invariant. A different sample stream than the default estimator
    # (checkpoint provenance, like nee).
    qmc: bool = False

    def resolve_size(self) -> Tuple[int, int]:
        """Apply the reference's 0-means-derive rule (lib.rs:113-134)."""
        w, h = self.width, self.height
        if w == 0 and h == 0:
            return DEFAULT_WIDTH, DEFAULT_HEIGHT
        if w == 0:
            return h, h
        if h == 0:
            return w, w
        return w, h

    def resolve_sample_batch(self) -> int:
        """Samples traced in one vectorized pass.

        Auto mode bounds live wavefront state to roughly 4M lanes' worth of
        work split sensibly: small frames vectorize many samples at once,
        large frames trace one sample per pass.
        """
        if self.sample_batch > 0:
            return min(self.sample_batch, max(1, self.samples_per_frame))
        w, h = self.resolve_size()
        lanes_budget = 4 << 20  # ~4M lanes ≈ 260MB of wavefront state
        per_pass = max(1, lanes_budget // max(1, w * h))
        return max(1, min(per_pass, self.samples_per_frame))

    def resolve_frame_batch(self, backend: str) -> int:
        """Frames per device call. Auto (0) batches toward a
        ``CUDA_FRAME_WINDOW``-sample launch on the CUDA kernel, where one
        frame at small spp idles the card while its last paths end, and stays
        at one frame on the plain torch backend. Never more frames than
        ``max_frames`` asks for: the batch shrinks to a ceil split."""
        if self.frame_batch > 0:
            return self.frame_batch
        if backend != "cuda" or self.shard not in ("none", "tiles"):
            return 1
        auto = max(1, CUDA_FRAME_WINDOW // max(1, self.samples_per_frame))
        if self.max_frames > 0:
            # e.g. --frames 100 at auto 64 runs 2x50, not 2x64 = 128 frames.
            auto = min(auto, self.max_frames)
            steps = -(-self.max_frames // auto)
            auto = -(-self.max_frames // steps)
        return auto

    def resolve_adaptive_windows(self, backend: str = "cuda") -> int:
        """Sub-windows per adaptive round (F; render/adaptive.py).

        Explicit ``frame_batch`` wins. Auto (0) is 1 on the plain torch
        backend; on the CUDA kernel it targets ``CUDA_ADAPTIVE_WINDOW``
        samples a launch (F * spp), at most ``CUDA_ADAPTIVE_CAP`` windows,
        and at most a quarter of a bounded budget, so that one bootstrap
        pass (every block once at F windows) leaves rounds to spend.
        """
        if self.frame_batch > 0:
            return self.frame_batch
        if backend != "cuda":
            return 1
        auto = max(1, min(CUDA_ADAPTIVE_CAP,
                          CUDA_ADAPTIVE_WINDOW // max(1, self.samples_per_frame)))
        if self.max_frames > 0:
            auto = max(1, min(auto, self.max_frames // 4))
        return auto

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """The closest-hit sweep's settings, passed to the kernel factories
    (``kernels/trace.py``) as the JAX package's ``config=``.

    The names are those of the JAX ``KernelConfig``
    (``myraytracer_tpu/kernels/trace.py:188-257``). The gate fields keep
    its defaults: ``compile_scene``'s kd partition aligns sphere groups to
    ``CULL_CHUNK`` = 48 and triangle groups to ``TRI_CHUNK_AUTO``, and that
    order decides equal-t ties.

    * ``UNROLL_MAX``: tables at most this wide (after padding) are swept
      with no gates. On the CUDA kernel it unrolls nothing.
    * ``CULL_MIN``: the sphere table is gated when it is wider than this
      (``FORCE_CULL`` None); ``FORCE_CULL`` True or False overrides. The
      triangle table is gated whenever it is wider than ``UNROLL_MAX``.
    * ``CULL_CHUNK``: spheres per gated chunk after the ``LEADERS``
      prologue; ``TRI_CHUNK``: triangles per chunk (0 = the auto ladder,
      ``resolve_tri_chunk``).
    * ``SUPER``: chunks under one outer gate, from ``SUPER_MIN`` chunks on.
    * ``SMEM_LIMIT`` (the port's own): the shared memory in bytes a launch
      may stage its tables in; None is the card's opt-in limit. A smaller
      value sends tables to global memory (``kernels.trace.stage_plan``), so
      that a small scene can take every staging route.
    * ``ABLATE``: names of ``ABLATE_COMPONENTS`` that the CUDA kernel runs a
      second time, inert (``python -m myraytracer_tpu_torch.ablate``). The
      plain version ignores it.

    The sweep's forms (``python -m myraytracer_tpu_torch.sweep --variants``
    times them). Five defaults are the forms ``csrc/trace.cu`` computes
    without build options, not the JAX defaults; each pair computes the
    same winners:

    * ``SQRT_GUARD`` True (JAX False): the root of the clamped discriminant
      and a ``disc >= 0`` term; False roots ``disc`` itself, and a miss's
      NaN fails every window compare.
    * ``WINDOW_FUSE`` False (JAX True): both window bounds spelled out;
      True tests the near root against ``t_min`` only and leaves the upper
      bound to ``t < t_best``, since ``t_best <= t_max`` always.
    * ``SWEEP_WIDTH`` 1 (JAX 4): W candidates (t, index), reduced pairwise
      with strict ``<``, the earlier on the left, merge into the carry
      once; the lowest index still wins ties. 1, 2, 4, 8 or 16.
    * ``LANE_GATE`` True (JAX False): each lane sweeps a chunk only if its
      own slab test passes; False: the warp enters a chunk, or an outer
      box, when any of its lanes does, and every lane sweeps it (JAX's
      ``jnp.any(enter)``). Not exact: the eps-padded slab test is
      conservative only up to rounding, so a lane may take a grazing hit
      that its own test skips, and which lanes share a warp is the tile
      queue's. The same winners on final; on an H100 it moved 43 of 3.29 M
      segments of spheres:100 at 1200x800, spp 1 (PERF.md).
    * ``MERGED_FETCH`` False (JAX True): the sweep carries (t, index) and
      the winner's record is read after it; True: the sweep carries the
      winner's record rows.

    ``SQRT_RSQRT`` (False, as in JAX) is a diagnostic: the root as ``disc *
    rsqrt(disc)``, which differs in ulps and drops exact tangents; it keeps
    ``SQRT_GUARD``'s ``disc >= 0`` term, and the plain version computes it
    too. ``STATIC_CAM`` (False, as in JAX): the packed camera travels by
    value in the launch's parameters, the construction camera's host copy
    taken once by the renderer, in place of the packed device operand.
    ``TILE_W`` (the port's own; 16): the width of a warp's tile of
    pixels, ``32 / TILE_W`` rows high: 8, 16 or 32; the counterpart of
    JAX's ``DEFAULT_TILE_ROWS`` and ``BLOCK_W``. Every option but
    ``SMEM_LIMIT`` that is not its default makes a separate build of
    ``csrc/trace.cu`` (``kernels.trace.kernel_flags``); every one but
    ``SQRT_RSQRT`` and ``LANE_GATE`` False leaves the image and the
    segments bit for bit those of the default build (``bitwise``), and the
    plain version ignores every one but ``SQRT_RSQRT``.
    """

    UNROLL_MAX: int = 64
    CULL_MIN: int = 64
    CULL_CHUNK: int = 48
    TRI_CHUNK: int = 0
    SUPER: int = 8
    SUPER_MIN: int = 24
    FORCE_CULL: Optional[bool] = None
    SMEM_LIMIT: Optional[int] = None
    ABLATE: Tuple[str, ...] = ()
    SQRT_GUARD: bool = True
    WINDOW_FUSE: bool = False
    SQRT_RSQRT: bool = False
    SWEEP_WIDTH: int = 1
    LANE_GATE: bool = True
    MERGED_FETCH: bool = False
    STATIC_CAM: bool = False
    TILE_W: int = 16

    def __post_init__(self):
        object.__setattr__(self, "ABLATE", tuple(self.ABLATE))
        unknown = [c for c in self.ABLATE if c not in ABLATE_COMPONENTS]
        if unknown:
            raise ValueError(f"ABLATE: unknown components {unknown}; the kernel's are "
                             f"{ABLATE_COMPONENTS}")
        if self.SWEEP_WIDTH not in SWEEP_WIDTHS:
            raise ValueError(f"SWEEP_WIDTH must be one of {SWEEP_WIDTHS}, got {self.SWEEP_WIDTH}")
        if self.TILE_W not in TILE_WIDTHS:
            raise ValueError(f"TILE_W must be one of {TILE_WIDTHS}, got {self.TILE_W}")

    @property
    def bitwise(self) -> bool:
        """Whether this config's build renders the default build's image and
        segments bit for bit: every sweep form but ``SQRT_RSQRT`` and the
        warp's gate (``LANE_GATE`` False)."""
        return self.LANE_GATE and not self.SQRT_RSQRT

    def cull_spheres(self, n_spheres: int) -> bool:
        """Whether a padded sphere table of ``n_spheres`` slots is swept
        behind gates (``trace.py:1032-1036``, ``1876-1881``)."""
        cull = self.FORCE_CULL if self.FORCE_CULL is not None else n_spheres > self.CULL_MIN
        return n_spheres > self.UNROLL_MAX and bool(cull)

    def cull_triangles(self, n_tris: int) -> bool:
        """Whether a padded triangle table of ``n_tris`` slots is swept
        behind gates (``trace.py:1219``), whatever ``FORCE_CULL`` says."""
        return n_tris > self.UNROLL_MAX


DEFAULT_KERNEL_CONFIG = KernelConfig()


def resolve_tri_chunk(cfg: KernelConfig, n_tris: int) -> int:
    """The triangle chunk width for a scene of ``n_tris`` (compiled, padded)
    triangles: ``cfg.TRI_CHUNK`` when set, else the ``TRI_CHUNK_AUTO``
    ladder (JAX ``kernels/trace.py:270-284``)."""
    return cfg.TRI_CHUNK or _auto_tri_chunk(n_tris)
