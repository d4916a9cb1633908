"""Frozen copy of ``myraytracer_tpu_torch/render/integrator.py`` at commit 32ae5bc, for
the benchmark's reference; imports made local. Edits: the MIS cosine in the float type of ``vec.computing_in``.

The wavefront integrator in plain PyTorch: the port's oracle.

Port of ``myraytracer_tpu.render.integrator`` for the slice the CUDA
kernel covers (spheres and triangle meshes; Lambertian, Metal, Dielectric
and DiffuseLight; checker, marble and image textures; gradient or constant
sky; threefry or QMC camera draws; next-event estimation with MIS, Russian
roulette, paged depth). It is the
plain version of the kernel in ``kernels/trace.py``: the kernel runs it
for CPU tensors, and ``chip_smoke.py`` holds the kernel against it on the
card. With ``gates`` (``render.hit.SweepGates``) the closest-hit sweeps --
the path's and the shadow ray's -- take the kernel's gates; without, they
are the ungated sweep of the JAX jnp integrator.

The reference's per-pixel bounce loop (``shader.wgsl:336-358``) becomes a
loop over bounces on a batch of lanes:

* miss lanes add ``throughput * sky`` and retire (shader.wgsl:343-345);
* emissive hits add ``throughput * emit`` (MIS-weighted under NEE) and
  retire;
* under NEE a Lambertian hit samples one light and adds its shadow-tested
  term (``render/lights.py``); its shadow ray counts as a segment;
* absorbed lanes retire black (shader.wgsl:349-350);
* depth exhaustion leaves the radiance untouched = black (shader.wgsl:357);
* throughput multiplies the attenuation and the next direction is
  normalized (shader.wgsl:353-354); then Russian roulette, in the JAX
  kernel's order (after the depth test).

Each bounce works only on the lanes still alive (the JAX oracle masks
dead lanes instead); per lane the arithmetic and the order of the radiance
additions are the same, so the result is too.

Every random draw is ``threefry(key, (pixel_lane, sample*254 + slot))``,
so the result is independent of batching: ``make_block_renderer`` renders
any row window for any sample window. ``rng_mode="hw"`` (the JAX kernels'
option) draws the scatter, NEE and camera slots from the Philox stream
``philox4x32(key, (pixel_lane, sample, bounce + 1, slot >> 1))`` instead
(``core.rng.uniform4_hw``), as independent of batching.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import rng as crng
from .vec import V3, float_dtype
from . import camera as cam_mod
from . import lights as lights_mod
from .hit import SweepGates, closest_hit, closest_t
from .materials import color_sky, scatter
from .textures import apply_texture
from . import api
from .api import Camera
from .compile import CompiledScene

M32 = crng.M32

# The sample streams of the kernels' ``rng_mode``: threefry (the JAX
# integrator's, the default) and the Philox stream that stands in for the
# TPU's hardware generator (``crng.uniform4_hw``).
RNG_MODES = ("threefry", "hw")


def check_rng_mode(rng_mode: str) -> None:
    """Raise ValueError unless ``rng_mode`` is one of ``RNG_MODES``."""
    if rng_mode not in RNG_MODES:
        raise ValueError(f"rng_mode must be 'threefry' or 'hw', got {rng_mode!r}")


def _sky_color(d: V3, sky) -> V3:
    if sky is None:
        return color_sky(d.y)
    zs = torch.zeros_like(d.y)
    return V3(zs + float(sky[0]), zs + float(sky[1]), zs + float(sky[2]))


def _add_at(rad: V3, idx: torch.Tensor, c: V3) -> None:
    """``rad[idx] = rad[idx] + c``, in place (``idx`` holds no repeats)."""
    for r, v in zip(rad, c):
        r[idx] = r[idx] + v


def trace(
    o: V3,
    d: V3,
    lane_id: torch.Tensor,
    sample_id: torch.Tensor,
    key,
    scene: CompiledScene,
    depth: int,
    t_min: float,
    t_max: float,
    sky=None,
    gates: Optional[SweepGates] = None,
    nee_lights=None,
    rr: int = 0,
    rng_mode: str = "threefry",
) -> Tuple[V3, torch.Tensor]:
    """Trace normalized rays (1-D lanes) to completion.

    ``lane_id`` and ``sample_id`` are int64 tensors of u32 values. Returns
    (radiance V3, segments int32) where ``segments`` counts the bounces in
    which each lane's path was alive, shadow rays included. ``sky`` is an
    optional constant background color (``World.ambient``); ``None`` keeps
    the gradient. ``nee_lights`` (``lights.extract_lights``; empty or None
    = off) enables next-event estimation with MIS; ``rr > 0`` Russian
    roulette before bounce ``rr`` and later, its decision drawn under the
    ``RR_KEY_FOLD`` key of the bounce's page. Depths past ``MAX_DEPTH`` draw
    their bounces from paged keys (``crng.depth_page_key``). ``rng_mode``
    ``"hw"`` draws the bounces from the Philox stream instead
    (``crng.uniform4_hw``: one call for slots 0-1, one for slots 2-3, the
    counter holding the absolute bounce, so no page key); Russian roulette
    keeps its threefry key.
    """
    hw = rng_mode == "hw"
    nee = bool(nee_lights)
    rr = int(rr)
    n = o.x.shape[0]
    dev = o.x.device
    rad = V3.zeros((n,), dev)
    segs = torch.zeros((n,), dtype=torch.int32, device=dev)
    # State of the lanes still alive; ``live`` maps them to their lanes.
    live = torch.arange(n, device=dev)
    atten = V3.ones((n,), dev)
    lane, sid = lane_id, sample_id
    draw_base = (sample_id * crng.DRAWS_PER_SAMPLE + crng.CAMERA_DRAWS) & M32
    # Cosine of the last diffuse scatter (MIS pickup weight; 0 = specular).
    prev_cos = torch.zeros((n,), dtype=float_dtype(), device=dev)
    shadow_scale = 1.0 - lights_mod.SHADOW_EPS
    for i in range(int(depth)):
        if live.numel() == 0:
            break
        segs[live] += 1
        hit = closest_hit(o, d, scene, t_min, t_max, gates)

        # Miss → attenuation * sky, retire (shader.wgsl:343-345).
        miss = ~hit.mask
        if bool(miss.any()):
            _add_at(rad, live[miss], atten.index(miss) * _sky_color(d.index(miss), sky))
        # Emissive hit → attenuation * emission (the albedo rows), retire;
        # under NEE weighted against the light sampler's density.
        is_light = hit.mask & (hit.mat_ty == api.MATERIAL_LIGHT)
        if bool(is_light.any()):
            c = atten.index(is_light) * hit.albedo.index(is_light)
            if nee:
                pd = prev_cos[is_light]
                piq = lights_mod.light_pdf_at_hit(
                    nee_lights, o.index(is_light), d.index(is_light), hit.t[is_light])
                c = c * torch.where(pd > 0.0, pd / torch.clamp_min(pd + piq, 1e-12), 1.0)
            _add_at(rad, live[is_light], c)
        keep = hit.mask & ~is_light
        live, lane, sid, draw_base = live[keep], lane[keep], sid[keep], draw_base[keep]
        o, d, atten = o.index(keep), d.index(keep), atten.index(keep)
        hit = _select_lanes(hit, keep)
        # The texture's value at the hit replaces the albedo (no-op on an
        # untextured scene), so NEE and the scatter see the effective color
        # (JAX integrator.py:101-105). Applied to the scattering lanes only:
        # lights are never textured, so emission above reads the same rows.
        hit = apply_texture(hit, image=scene.tex_image)
        if nee:
            prev_cos = prev_cos[keep]

        # Scatter draws: slot 0 = unit sphere; slots 1-2 = unit ball; slot
        # 2's second word = the dielectric reflect draw (and NEE's light
        # pick); slot 3 = NEE's light point.
        page, local = divmod(i, crng.BOUNCES_PER_PAGE)
        bkey = crng.depth_page_key(key, page)
        draw = (draw_base + local * crng.DRAWS_PER_BOUNCE) & M32
        if hw:
            us1, us2, ub1, ub2 = crng.uniform4_hw(key, lane, sid, i, 0)
            ub3, ud, hn1, hn2 = crng.uniform4_hw(key, lane, sid, i, 1)
        else:
            us1, us2 = crng.uniform2(bkey, lane, draw)
            ub1, ub2 = crng.uniform2(bkey, lane, draw + 1)
            ub3, ud = crng.uniform2(bkey, lane, draw + 2)
        sphere_sample = crng.unit_sphere_from_uniforms(us1, us2)
        ball_sample = crng.unit_ball_from_uniforms(ub1, ub2, ub3)

        is_lamb = hit.mat_ty == api.MATERIAL_LAMBERTIAN
        if nee and bool(is_lamb.any()):
            # One shadow ray per Lambertian hit, counted whether or not the
            # sample is usable; the sweep starts at the light distance.
            sel = is_lamb.nonzero().squeeze(1)
            if hw:
                n1, n2 = hn1[sel], hn2[sel]
            else:
                n1, n2 = crng.uniform2(bkey, lane[sel], draw[sel] + 3)
            point, normal = hit.point.index(sel), hit.normal.index(sel)
            omega, t_p, contrib, add = lights_mod.sample_lights(
                nee_lights, point, normal, ud[sel], n1, n2)
            segs[live[sel]] += 1
            sel, omega, t_p, contrib = (sel[add], omega.index(add), t_p[add],
                                        contrib.index(add))
            limit = t_p * shadow_scale
            t_sh = closest_t(point.index(add), omega, scene, t_min, t_max, limit, gates)
            lit = ~(t_sh < limit)
            sel = sel[lit]
            c = (atten.index(sel) * hit.albedo.index(sel)) * contrib.index(lit)
            _add_at(rad, live[sel], c)

        sc = scatter(d, hit, sphere_sample, ball_sample, ud)
        ok = sc.ok  # absorbed → retire black (shader.wgsl:349-350)
        live, lane, draw, is_lamb = live[ok], lane[ok], draw[ok], is_lamb[ok]
        sid, draw_base = sid[ok], draw_base[ok]
        normal = hit.normal.index(ok)
        atten = atten.index(ok) * sc.attenuation.index(ok)
        o = hit.point.index(ok)
        d = sc.direction.index(ok).normalize()  # shader.wgsl:354
        if nee:
            prev_cos = torch.where(is_lamb, torch.clamp_min(d.dot(normal), 0.0), 0.0)
        if rr and rr <= i + 1 < depth:
            # Russian roulette before bounce i+1: kill with probability
            # 1-p, divide the survivors' throughput by p.
            u, _ = crng.uniform2(crng.fold_key(bkey, crng.RR_KEY_FOLD), lane, draw)
            p = torch.clamp(torch.maximum(atten.x, torch.maximum(atten.y, atten.z)),
                            0.05, 0.95)
            live_on = ~(u >= p)
            live, lane, draw_base = live[live_on], lane[live_on], draw_base[live_on]
            sid = sid[live_on]
            o, d = o.index(live_on), d.index(live_on)
            atten = atten.index(live_on) * (1.0 / p[live_on])
            if nee:
                prev_cos = prev_cos[live_on]
    return rad, segs


def _select_lanes(hit, idx):
    """The hit record of the selected lanes."""
    return type(hit)(*(
        None if f is None else f.index(idx) if isinstance(f, V3) else f[idx] for f in hit
    ))


def render_sample_batch(
    scene: CompiledScene,
    ray_gen,
    ix: torch.Tensor,
    iy: torch.Tensor,
    lane_id: torch.Tensor,
    sample_id: torch.Tensor,
    key,
    depth: int,
    t_min: float,
    t_max: float,
    sky=None,
    lens_draws: bool = True,
    gates: Optional[SweepGates] = None,
    nee_lights=None,
    qmc: bool = False,
    rr: int = 0,
    rng_mode: str = "threefry",
) -> Tuple[V3, torch.Tensor]:
    """Camera-generate and trace one batch of (pixel, sample) lanes.

    Camera draw slots: 0 = sub-pixel jitter, 1 = lens disk. Slots are
    absolute, so a camera without a lens (reference mode) skips slot 1
    and nothing else in the stream moves. Under ``qmc`` both pairs come
    from the Owen-scrambled Sobol sequence instead (``crng``), and slots
    0-1 are not drawn. Under ``rng_mode`` ``"hw"`` slots 0-1 are one
    Philox call (``crng.uniform4_hw`` at bounce -1).
    """
    if qmc:
        u1, u2 = crng.qmc_camera_uniforms(key, lane_id, sample_id, 0)
        if lens_draws:
            l1, l2 = crng.qmc_camera_uniforms(key, lane_id, sample_id, 1)
        else:
            l1 = l2 = torch.zeros_like(u1)
    elif rng_mode == "hw":
        u1, u2, l1, l2 = crng.uniform4_hw(key, lane_id, sample_id, -1, 0)
        if not lens_draws:
            l1 = l2 = torch.zeros_like(u1)
    else:
        cam_draw = (sample_id * crng.DRAWS_PER_SAMPLE) & M32
        u1, u2 = crng.uniform2(key, lane_id, cam_draw)
        if lens_draws:
            l1, l2 = crng.uniform2(key, lane_id, cam_draw + 1)
        else:
            l1 = l2 = torch.zeros_like(u1)
    o, d = ray_gen(ix, iy, u1, u2, l1, l2)
    return trace(o, d, lane_id, sample_id, key, scene, depth, t_min, t_max, sky=sky,
                 gates=gates, nee_lights=nee_lights, rr=rr, rng_mode=rng_mode)


def ray_generator(cam: Camera, width: int, height: int,
                  packed: Optional[torch.Tensor]):
    """The ray generator a block uses: the packed runtime camera when the
    scene carries one (general mode only — the reference camera is fixed by
    definition), else the construction camera."""
    if packed is not None and not cam.reference_mode:
        return lambda ix, iy, u1, u2, l1, l2: cam_mod.rays_from_packed(  # noqa: E731
            packed, width, height, ix, iy, u1, u2, l1, l2
        )
    return cam_mod.make_ray_generator(cam, width, height)


def pixel_sums(
    scene: CompiledScene,
    ray_gen,
    ix: torch.Tensor,
    iy: torch.Tensor,
    sample_start,
    n_samples: int,
    key,
    width: int,
    depth: int,
    t_min: float,
    t_max: float,
    sky=None,
    lens_draws: bool = True,
    sample_batch: int = 1,
    gates: Optional[SweepGates] = None,
    nee_lights=None,
    qmc: bool = False,
    rr: int = 0,
    rng_mode: str = "threefry",
) -> Tuple[V3, torch.Tensor]:
    """Radiance sums and segment counts of 1-D pixel lanes ``(ix, iy)``
    over sample indices ``[sample_start, sample_start + n_samples)``.

    ``sample_start`` is an int, or an int64 tensor with one start a lane.
    Samples are traced ``sample_batch`` at a time and added to a lane's sum
    one at a time in sample order, as the CUDA kernels add them, so the
    sums do not depend on the batching or on which other lanes are traced
    with them. Returns (sums V3, segments int32).
    """
    n = ix.shape[0]
    dev = ix.device
    lane_id = (iy * width + ix) & M32
    acc = V3.zeros((n,), dev)
    segs = torch.zeros((n,), dtype=torch.int32, device=dev)
    b = max(1, min(int(sample_batch), int(n_samples)))
    for j0 in range(0, int(n_samples), b):
        k = min(b, int(n_samples) - j0)
        rows = torch.arange(k, dtype=torch.int64, device=dev)[:, None]
        sample_id = ((sample_start + j0 + rows) & M32).expand(k, n)
        rad, sg = render_sample_batch(
            scene, ray_gen,
            ix.expand(k, n).reshape(-1),
            iy.expand(k, n).reshape(-1),
            lane_id.expand(k, n).reshape(-1),
            sample_id.reshape(-1),
            key, depth, t_min, t_max, sky=sky, lens_draws=lens_draws,
            gates=gates, nee_lights=nee_lights, qmc=qmc, rr=rr, rng_mode=rng_mode,
        )
        rad = V3(*(c.view(k, n) for c in rad))
        for r in range(k):
            acc = acc + V3(rad.x[r], rad.y[r], rad.z[r])
        segs = segs + sg.view(k, n).sum(dim=0, dtype=torch.int32)
    return acc, segs


def make_block_renderer(
    cam: Camera,
    width: int,
    height: int,
    n_rows: int,
    max_samples: int,
    ray_depth: int,
    t_min: float = 1e-3,
    t_max: float = 1e4,
    sample_batch: int = 1,
    material_set=None,
    sky=None,
    nee_lights=None,
    texture_set=None,
    qmc: bool = False,
    rr: int = 0,
    frames: int = 1,
    gates: Optional[SweepGates] = None,
    rng_mode: str = "threefry",
):
    """Build the composable rendering primitive.

    Returns ``block(scene, key, row0, sample_start, n_valid) ->
    (radiance_sum [n_rows, width, 3] f32, segments [n_rows, width] f32)``:
    the SUM of radiance over sample indices ``[sample_start, sample_start +
    n_valid)`` (``n_valid <= max_samples``) for image rows ``[row0, row0 +
    n_rows)``, channels last, and each pixel's traced-segment count. The
    caller divides by the sample count.

    ``frames = K > 1`` is the plain version of the CUDA kernel's frame
    buckets: ``n_valid`` must be ``K * max_samples``, and the sum becomes
    ``[K, 3, n_rows, width]``, frame ``f`` summing samples ``[sample_start
    + f*max_samples, sample_start + (f+1)*max_samples)``. Each frame is a
    one-frame block call of its own, so it is bitwise that call; the
    segment counts are totals over the K frames.

    ``gates`` (the scene's, from ``kernels.trace.gate_tables``) makes the
    closest-hit sweeps the CUDA kernel's gated sweep. ``nee_lights``,
    ``qmc`` and ``rr`` select the estimator's modes (``trace``,
    ``render_sample_batch``), ``rng_mode`` the stream (``"threefry"`` or
    ``"hw"``, the kernels' Philox stream; ``check_rng_mode``);
    ``material_set`` and ``texture_set`` are not needed (emission and the
    texture rows are read from the compiled scene).
    """
    del material_set, texture_set  # emission and textures are read off the scene
    check_rng_mode(rng_mode)
    frames = int(frames)
    n_pixels = n_rows * width

    def one(scene: CompiledScene, key, row0, sample_start, n_valid):
        dev = scene.device
        pix = torch.arange(n_pixels, dtype=torch.int64, device=dev)
        acc, segs = pixel_sums(
            scene, ray_generator(cam, width, height, scene.cam),
            pix % width, pix // width + int(row0), int(sample_start),
            int(n_valid), key, width, ray_depth, t_min, t_max, sky=sky,
            lens_draws=not cam.reference_mode, sample_batch=sample_batch,
            gates=gates, nee_lights=nee_lights, qmc=qmc, rr=rr, rng_mode=rng_mode,
        )
        img_sum = acc.stacked(-1).view(n_rows, width, 3)
        return img_sum, segs.to(torch.float32).view(n_rows, width)

    def block(scene: CompiledScene, key, row0, sample_start, n_valid):
        n_valid = int(n_valid)
        if frames == 1:
            if n_valid > max_samples:
                raise ValueError(f"n_valid {n_valid} > max_samples {max_samples}")
            return one(scene, key, row0, sample_start, n_valid)
        if n_valid != frames * max_samples:
            raise ValueError(
                f"n_valid {n_valid} != frames {frames} x max_samples {max_samples}"
            )
        sums, segs = zip(*(
            one(scene, key, row0, int(sample_start) + f * max_samples, max_samples)
            for f in range(frames)
        ))
        return (torch.stack([s.permute(2, 0, 1) for s in sums]),
                torch.stack(segs).sum(dim=0))

    return block


def make_renderer(
    cam: Camera,
    width: int,
    height: int,
    samples_per_frame: int,
    ray_depth: int,
    t_min: float = 1e-3,
    t_max: float = 1e4,
    sample_batch: int = 1,
    material_set=None,
    frames: int = 1,
    sky=None,
    nee_lights=None,
    texture_set=None,
    qmc: bool = False,
    rr: int = 0,
    rng_mode: str = "threefry",
):
    """Build a single-device frame renderer on the plain integrator.

    Returns ``render(scene, key, sample_base) -> (image [H,W,3] f32,
    segments f64 scalar)``: the mean radiance over ``samples_per_frame``
    samples from global sample index ``sample_base``, and the number of
    ray segments traced. The analog of one ``State::redraw`` trace pass
    (``lib.rs:241-307``) without the accumulation blend.

    ``frames = K > 1`` returns K per-frame mean images ``[K, 3, H, W]``
    (JAX ``render/integrator.py:378-424``), each bitwise the image of a
    one-frame call at its sample base.
    """
    spp = int(samples_per_frame)
    block = make_block_renderer(
        cam, width, height, height, spp, ray_depth, t_min=t_min, t_max=t_max,
        sample_batch=sample_batch, material_set=material_set, sky=sky,
        nee_lights=nee_lights, texture_set=texture_set, qmc=qmc, rr=rr,
        frames=frames, rng_mode=rng_mode,
    )
    return frame_renderer(block, spp, frames)


def frame_renderer(block, spp: int, frames: int = 1):
    """``render(scene, key, sample_base)`` over a full-image ``block`` of
    ``frames`` frames: the sums divided by ``spp`` and the segment total in
    float64."""
    n_valid = int(frames) * int(spp)

    def render(scene: CompiledScene, key, sample_base):
        img_sum, segs = block(scene, key, 0, int(sample_base), n_valid)
        return img_sum * (1.0 / spp), segs.sum(dtype=torch.float64)

    # The kernel's table cache, where the block has one (kernels/trace.py).
    render.tables = getattr(block, "tables", None)
    return render
