"""Edge-avoiding à-trous wavelet denoiser (output post-process).

Port of ``myraytracer_tpu.render.denoise``: torch ops on an explicit
device, no kernel (the JAX module has none).

* **à-trous wavelet** (Dammertz et al., "Edge-Avoiding À-Trous Wavelet
  Transform for Fast Global Illumination Filtering", HPG 2010): N
  iterations of a 5×5 B3-spline cross-bilateral kernel with tap spacing
  doubling each iteration. Every tap is a static image shift and
  elementwise math over [H, W, 3].
* **Feature buffers** come from one deterministic primary-hit pass
  (center-of-pixel ray through the lens center, ``closest_hit``): per-pixel
  albedo (texture-evaluated), shading normal and hit distance.
* **Albedo demodulation**: the filter runs on irradiance
  (``color / max(albedo, eps)``) and remodulates afterwards, so texture
  detail survives aggressive smoothing.

The filter is a display transform: checkpoints store the raw accumulation
state and ``--denoise`` changes no sample stream.

Arithmetic: the JAX filter's expression trees in its order (the tap sums
are accumulated tap by tap), every product and sum rounded on its own, so
the result is bitwise JAX's run eagerly; jitted, XLA's CPU backend
contracts multiply-adds and the two differ by rounding. ``exp`` is each
device's own.

The feature pass sweeps behind the kernels' gates on large scenes
(``kernels.trace.gate_tables`` with the default ``KernelConfig``; scenes of
at most 64 primitive slots are ungated) and in chunks of rays, so that a
1200x800 pass over 40,000 spheres stays within a bounded memory.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from myraytracer_tpu_torch.core.vec import V3
from myraytracer_tpu_torch.render import camera as cam_mod
from myraytracer_tpu_torch.render.hit import closest_hit
from myraytracer_tpu_torch.render.textures import apply_texture
from myraytracer_tpu_torch.scene import api
from myraytracer_tpu_torch.scene.compile import compile_scene

# Demodulation floor: out = filter(fb / max(albedo, EPS)) * max(albedo, EPS)
# is exactly identity-consistent for an unfiltered signal at any albedo.
ALBEDO_EPS = 0.05

# 1-D B3 spline taps; the 5x5 kernel is the outer product (Dammertz §3).
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)

# The JAX package's defaults: sigma_color is dimensionless (the luminance
# distance is normalized by a per-pixel noise estimate), normal is
# unit-vector L2², depth relative.
DEFAULT_ITERATIONS = 5
DEFAULT_SIGMA_COLOR = 4.0
DEFAULT_SIGMA_NORMAL = 0.35
DEFAULT_SIGMA_DEPTH = 0.07

# Rec.709 luma weights (the color weight runs on luminance, SVGF-style).
_LUM = (0.2126, 0.7152, 0.0722)
# 1-D 3-tap Gaussian for the local noise-moment estimate.
_G3 = (0.25, 0.5, 0.25)

# The spp anchor of the fallback schedule (``auto_iterations``) and the
# noise anchor of the auto schedule (``noise_iterations``): the JAX
# package's calibration, so ``--denoise auto`` picks the same count in both.
AUTO_CROSSOVER_SPP = 64
NOISE_ITERS_REF = 0.005

# Elements of one [boxes, rays] temporary of the gated feature sweep.
_FEATURE_BUDGET = 16 << 20


def auto_iterations(spp: int, crossover: int = AUTO_CROSSOVER_SPP) -> int:
    """spp-scheduled iteration count: the auto fallback when no
    framebuffer is at hand.

    ``iters = clamp(ceil(log2(crossover / spp)), 0, DEFAULT_ITERATIONS)``
    i.e. 5 at <=2 spp, 4 at 4 spp, 3 at 8, 2 at 16, 1 at 32, 0 (raw) at
    >= ``crossover``.
    """
    spp = max(1, int(spp))
    if spp >= crossover:
        return 0
    return min(DEFAULT_ITERATIONS, max(1, math.ceil(math.log2(crossover / spp))))


def noise_iterations(noise: float, ref: float = NOISE_ITERS_REF) -> int:
    """Noise-driven iteration count for ``--denoise auto``: one support
    doubling per noise octave above the anchor. NaN/zero-safe: a clean (or
    unrendered) framebuffer passes through raw."""
    if not noise > ref * (2.0 ** -0.5):  # round() threshold, NaN-safe
        return 0
    return min(
        DEFAULT_ITERATIONS,
        max(0, int(round(math.log2(noise / ref)))),
    )


def estimate_noise(fb) -> float:
    """Global noise scalar of a linear framebuffer: the median local (3x3
    Gaussian) luminance sigma of its display-space encode (clip + sRGB).
    Numpy on the host, as in the JAX package: one image pass."""
    if isinstance(fb, torch.Tensor):
        fb = fb.detach().cpu().numpy()
    a = np.clip(np.asarray(fb, np.float32), 0.0, 1.0)
    a = np.where(
        a <= 0.0031308,
        a * np.float32(12.92),
        1.055 * np.power(np.maximum(a, 1e-8), 1.0 / 2.4) - 0.055,
    )
    lum = (
        np.float32(_LUM[0]) * a[..., 0]
        + np.float32(_LUM[1]) * a[..., 1]
        + np.float32(_LUM[2]) * a[..., 2]
    )

    def blur(x):
        p = np.pad(x, ((1, 1), (0, 0)), mode="edge")
        x = 0.25 * p[:-2] + 0.5 * p[1:-1] + 0.25 * p[2:]
        p = np.pad(x, ((0, 0), (1, 1)), mode="edge")
        return 0.25 * p[:, :-2] + 0.5 * p[:, 1:-1] + 0.25 * p[:, 2:]

    mu = blur(lum)
    m2 = blur(lum * lum)
    sigma = np.sqrt(np.maximum(m2 - mu * mu, 0.0))
    return float(np.median(sigma))


def _ray_chunk(n_rays: int, gates) -> int:
    """Rays a pass of the feature sweep, so that the gated sweep's
    [boxes, rays] temporaries stay within ``_FEATURE_BUDGET`` elements."""
    boxes = 64
    if gates is not None:
        boxes = max(boxes, gates.aabb.shape[1] + gates.traabb.shape[1])
    return max(1024, min(n_rays, _FEATURE_BUDGET // boxes))


def aux_buffers(
    scene,
    ray_gen,
    width: int,
    height: int,
    t_min: float,
    t_max: float,
    gates=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One primary-hit feature pass → (albedo [H,W,3], normal [H,W,3],
    depth [H,W]) on the scene's device.

    Deterministic center rays: sub-pixel uniforms 0.5 and the lens-disk
    draw pinned to the aperture center. Miss lanes get albedo 1 (sky is
    demodulation-neutral), normal ``-d`` and depth ``t_max`` (a hard
    relative-depth edge against all geometry). ``gates`` are the sweep's
    gates (``kernels.trace.gate_tables(scene).gates``), or None for the
    ungated sweep; the rays go through in chunks.
    """
    n = height * width
    dev = scene.device
    chunk = _ray_chunk(n, gates)
    albedo, normal, depth = [], [], []
    for lo in range(0, n, chunk):
        pix = torch.arange(lo, min(n, lo + chunk), dtype=torch.int64, device=dev)
        ix = (pix % width).to(torch.int32)
        iy = (pix // width).to(torch.int32)
        half = torch.full(pix.shape, 0.5, dtype=torch.float32, device=dev)
        zero = torch.zeros(pix.shape, dtype=torch.float32, device=dev)
        o, d = ray_gen(ix, iy, half, half, zero, zero)
        hit = closest_hit(o, d, scene, t_min, t_max, gates)
        hit = apply_texture(hit, image=scene.tex_image)
        one = torch.ones_like(half)
        alb = V3.where(hit.mask, hit.albedo, V3(one, one, one))
        nrm = V3.where(hit.mask, hit.normal, -d)
        albedo.append(torch.stack([alb.x, alb.y, alb.z], dim=-1))
        normal.append(torch.stack([nrm.x, nrm.y, nrm.z], dim=-1))
        depth.append(hit.t)  # == t_max on miss by closest_hit's contract
    return (torch.cat(albedo).reshape(height, width, 3),
            torch.cat(normal).reshape(height, width, 3),
            torch.cat(depth).reshape(height, width))


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = a[clamp(y + dy), clamp(x + dx)] (edge-replicated)."""
    h, w = a.shape[0], a.shape[1]
    if dy:
        a = a[(torch.arange(h, device=a.device) + dy).clamp_(0, h - 1)]
    if dx:
        a = a[:, (torch.arange(w, device=a.device) + dx).clamp_(0, w - 1)]
    return a


def atrous_denoise(
    fb: torch.Tensor,
    albedo: torch.Tensor,
    normal: torch.Tensor,
    depth: torch.Tensor,
    iterations: int = DEFAULT_ITERATIONS,
    sigma_color: float = DEFAULT_SIGMA_COLOR,
    sigma_normal: float = DEFAULT_SIGMA_NORMAL,
    sigma_depth: float = DEFAULT_SIGMA_DEPTH,
) -> torch.Tensor:
    """Filter a linear [H, W, 3] framebuffer with its feature buffers, all
    f32 on one device.

    Weights per tap q around pixel p (all edge-stopping):

    * color (noise-adaptive, the SVGF form):
      ``exp(-|l_p - l_q| / (σ_c · sqrt(var_p) + ε))`` where ``l`` is the
      demodulated luminance and ``var_p`` a local 3×3 Gaussian moment
      estimate of its variance, recomputed each iteration from the current
      filtered signal;
    * normal: ``exp(-|n_p - n_q|² / σ_n²)``;
    * depth:  ``exp(-((t_p - t_q) / (σ_z · max(t_p, t_q)))²)``: relative
      distance, so sky (t = t_max) is a hard edge against every surface.
    """
    f32 = torch.float32
    dev = fb.device
    as_f32 = lambda v: torch.tensor(v, dtype=f32, device=dev)  # noqa: E731
    alb = torch.clamp_min(albedo, ALBEDO_EPS)
    c = fb / alb
    sn = as_f32(sigma_normal)
    inv_sn2 = 1.0 / (sn * sn)
    inv_sz = 1.0 / as_f32(sigma_depth)
    sigma_color = as_f32(sigma_color)
    lw = [float(np.float32(v)) for v in _LUM]
    lum = lambda a: lw[0] * a[..., 0] + lw[1] * a[..., 1] + lw[2] * a[..., 2]  # noqa: E731
    for i in range(int(iterations)):
        step = 1 << i
        l = lum(c)  # noqa: E741
        mu = torch.zeros_like(l)
        m2 = torch.zeros_like(l)
        for gy in range(3):
            for gx in range(3):
                g = float(np.float32(_G3[gy] * _G3[gx]))
                lq = _shift(l, gy - 1, gx - 1)
                mu = mu + g * lq
                m2 = m2 + g * lq * lq
        noise = sigma_color * torch.sqrt(torch.clamp_min(m2 - mu * mu, 0.0)) + 1e-4
        num = torch.zeros_like(c)
        den = torch.zeros_like(depth)
        for ty in range(5):
            for tx in range(5):
                dy, dx = (ty - 2) * step, (tx - 2) * step
                h = float(np.float32(_B3[ty] * _B3[tx]))
                cq = _shift(c, dy, dx)
                nq = _shift(normal, dy, dx)
                zq = _shift(depth, dy, dx)
                dc = (l - _shift(l, dy, dx)).abs() / noise
                dn = ((normal - nq) ** 2).sum(dim=-1)
                dz = (depth - zq) * (inv_sz / torch.clamp_min(torch.maximum(depth, zq), 1e-6))
                w = h * torch.exp(-dc - dn * inv_sn2 - dz * dz)
                num = num + w[..., None] * cq
                den = den + w
        c = num / den[..., None]  # den >= center tap weight > 0
    return c * alb


class Denoiser:
    """Bound filter: scene features computed once a camera, reused per frame.

    Built from the API world, not a session's compiled scene, so it serves
    any session of that world. ``device`` is where the feature pass and the
    filter run: the caller names it (the session's), there is no default; a
    packed runtime camera (the session's
    ``scene.cam``) is passed per call, and the feature buffers are cached
    and recomputed only when its values change.
    """

    def __init__(
        self,
        world: api.World,
        width: int,
        height: int,
        iterations: int = DEFAULT_ITERATIONS,
        sigma_color: float = DEFAULT_SIGMA_COLOR,
        sigma_normal: float = DEFAULT_SIGMA_NORMAL,
        sigma_depth: float = DEFAULT_SIGMA_DEPTH,
        t_min: float = 1e-3,
        t_max: float = 1e4,
        auto: bool = False,
        *,
        device,
    ):
        if iterations < 1:
            raise ValueError(f"denoise iterations must be >= 1, got {iterations}")
        # The session's rule for the order of the primitives; the kernels'
        # gates want the sorted order.
        from myraytracer_tpu_torch.kernels.trace import gate_tables
        from myraytracer_tpu_torch.render.session import wants_spatial_sort

        # auto: the iteration count follows the framebuffer's noise per
        # call; ``iterations`` is then the fallback only.
        self.auto = bool(auto)
        # The originating world, so that a caller reusing a Denoiser as an
        # AOV source can check it was built from the same scene.
        self.world = world
        self.width, self.height = int(width), int(height)
        self.iterations = int(iterations)
        self.sigmas = (float(sigma_color), float(sigma_normal), float(sigma_depth))
        self.device = torch.device(device)
        self._scene = compile_scene(
            world, spatial_sort=wants_spatial_sort(world), device=self.device)
        self._gates = gate_tables(self._scene).gates
        self._t = (float(t_min), float(t_max))
        self._static_gen = cam_mod.make_ray_generator(world.camera, self.width, self.height)
        self._reference_mode = world.camera.reference_mode
        self._aux = None
        self._aux_cam = None
        self._last_auto = None  # last noise-driven auto count (__call__)
        self._noise_at = None  # (spp, estimate) cache for the auto path
        self.last_noise = None  # last measured estimate

    def _features(self, cam):
        # Keyed by the packed camera's values (76 bytes), not its identity:
        # a replaced camera tensor can reuse an address.
        key = None if cam is None else np.asarray(
            cam.detach().cpu() if isinstance(cam, torch.Tensor) else cam, np.float32).tobytes()
        if self._aux is None or key != self._aux_cam:
            if cam is None or self._reference_mode:
                gen = self._static_gen
            else:
                packed = torch.as_tensor(cam, dtype=torch.float32).to(self.device)
                gen = (lambda ix, iy, u1, u2, l1, l2: cam_mod.rays_from_packed(
                    packed, self.width, self.height, ix, iy, u1, u2, l1, l2))
            self._aux = aux_buffers(self._scene, gen, self.width, self.height, *self._t,
                                    gates=self._gates)
            self._aux_cam = key
        return self._aux

    def features(self, cam=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The (albedo [H,W,3], normal [H,W,3], depth [H,W]) feature
        buffers for the current camera: also the CLI's --aov source."""
        return self._features(cam)

    def effective_iterations(self, spp: Optional[int] = None) -> int:
        """Iteration count for reporting: in ``auto`` mode, the last
        noise-driven count a call computed, else the spp fallback
        schedule; the construction count otherwise."""
        if self.auto:
            if self._last_auto is not None:
                return self._last_auto
            if spp is not None:
                return auto_iterations(spp)
        return self.iterations

    def __call__(self, fb, cam=None, spp: Optional[int] = None) -> torch.Tensor:
        """Denoise a linear [H, W, 3] framebuffer (numpy or torch) → an f32
        tensor on the denoiser's device.

        ``cam`` is the session's packed runtime camera, or None for the
        construction camera. In ``auto`` mode the iteration count is
        ``noise_iterations(estimate_noise(fb))``, re-estimated when the
        accumulated ``spp`` has grown 25% or moved backwards.
        """
        fb = torch.as_tensor(fb, dtype=torch.float32).to(self.device)
        if self.auto:
            cached = self._noise_at
            if (
                spp is not None and cached is not None
                and cached[0] is not None
                and cached[0] <= spp < cached[0] * 1.25
            ):
                noise = cached[1]
            else:
                noise = estimate_noise(fb)
                self._noise_at = (spp, noise)
            iters = noise_iterations(noise)
            self._last_auto = iters
            self.last_noise = noise
        else:
            iters = self.effective_iterations(spp)
        if iters <= 0:
            return fb
        albedo, normal, depth = self._features(cam)
        return atrous_denoise(fb, albedo, normal, depth, iters, *self.sigmas)


def make_denoiser(world: api.World, width: int, height: int, **kwargs) -> Denoiser:
    """CLI-facing constructor (see Denoiser; ``device`` is required)."""
    return Denoiser(world, width, height, **kwargs)
