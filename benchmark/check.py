"""The comparison that decides ``correct``: the framebuffers that the timed
path fetched to host memory, at pixels spread over the whole image, and
the segment count it reported, against the plain reference.

The reference (``benchmark.reference``, a frozen copy of the program's
plain integrator, sweep, gates, materials, lights, camera, RNG and scene
compiler, or the copy the cell's configuration names) works everything
out again from the configuration file: the world and the views, built by
the cell's world module with the reference's scene API, the compiled
scene, the gates, the lights.
It takes from the run only what the run asked of the program (which view,
which sample window, how many frames) and, to judge them, the program's
answers. For each picked answer it traces every sample of every frame
blended into it at the picked pixels, divides by the samples a frame and
blends the frames in the session's order with the session's weights, and
compares the result with the program's pixels. Only the counts of one
picked pixel set are known to the reference, so the segments are compared
as segments a sample: the program's over the whole image against the
reference's over the picked pixels.

An adaptive image (``Answer.blocks``) is judged the same way, but its
pixels are not uniform frames: each picked pixel's block got its own
count of samples from its own cursor. The reference traces each of the
pixel's windows as a lane of its own and folds the windows in sample
order as the session does (``benchmark.reference.adaptive``); its
samples are what the spp map says, and the program's segments a sample
are over the samples it traced, the image's pixels only.

``Reference(..., dtype=torch.bfloat16)`` is the control: the same
reference computed in the precision below the configuration's float32.

A configuration names its world module and its reference package in its
``"world"`` and ``"reference"`` keys (``registry.py``); without them the
check builds with ``benchmark/world.py`` and ``benchmark.reference``. A
reference copy holds every module this file uses
(``registry.REFERENCE_MODULES``: ``adaptive``, ``api``, ``camera``,
``compile``, ``gates``, ``hit``, ``integrator``, ``lights``, ``rng``,
``vec``) with the same interfaces, and what they import, its own modules
imported relatively, in plain torch and numpy, importing nothing of the
program, of JAX or of the JAX package; it is frozen once a cell that uses
it is accepted.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from benchmark import registry

# The renderer's window (RenderConfig's defaults; shader.wgsl:340).
T_MIN, T_MAX = 1e-3, 1e4
# The compiler sorts a scene spatially past 64 spheres or 64 triangles
# (myraytracer_tpu_torch/render/session.py:wants_spatial_sort, 32ae5bc).
SPATIAL_SORT_MIN = 64
# Rays the reference traces in one pass (bounds its memory on the card).
RAY_BUDGET = 1 << 19


class Blocks(NamedTuple):
    """What an adaptive image asked of each pixel block: the block's sample
    cursor at the last camera move and the samples it got since, both
    [blocks_y, blocks_x] int64 and read from the spp map, the block's size
    in pixels, the samples traced over the image's pixels (the spp map's
    sum), and the samples the run asked for, whole blocks counted."""

    start: np.ndarray
    count: np.ndarray
    width: int
    height: int
    samples: int
    asked: int


class Answer(NamedTuple):
    """What the run asked of the program for one framebuffer that reached
    host memory, and what it got. An adaptive image has ``blocks``, its
    ``spp`` is a window's samples and its ``sample_start`` and ``frames``
    are 0."""

    view: Optional[int]  # turntable step, or None for the published camera
    sample_start: int  # the session's sample cursor at the last reset
    frames: int  # frames blended in since the last reset
    spp: int  # samples a frame
    segments: float  # segments the program reported for those frames
    framebuffer: np.ndarray  # [H, W, 3] float32, as fetched
    blocks: Optional[Blocks] = None


class Reading(NamedTuple):
    """The reference's (or the control's) side of some answers: pixel
    values [answers, P, 3], segments and samples over the picked pixels,
    and the sweep's tests when counted."""

    values: np.ndarray
    segments: int
    samples: int
    tests: Optional[dict]


def fma_f32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``a*b + c`` in float32 with one rounding (copied from
    ``myraytracer_tpu_torch/render/session.py:fma_f32`` at 32ae5bc, in
    numpy): the float32 product is exact in float64, the float64 sum is
    rounded to odd, so the last rounding is the correctly rounded one."""
    p = a.astype(np.float64) * b.astype(np.float64)
    cd = c.astype(np.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(np.int64) & 1) == 0
    toward = np.where(err > 0, np.inf, -np.inf)
    s = np.where((err != 0) & even, np.nextafter(s, toward), s)
    return s.astype(np.float32)


def blend(frames: np.ndarray, max_weight: float = 1.0) -> np.ndarray:
    """The session's accumulation of per-frame images ``[n, ...]`` from a
    reset: ``fb = fma(fb, w, img * (1 - w))`` with ``w = min(max_weight,
    k / (k + 1))`` for the k-th frame, in float32 (``_blend_chain``)."""
    fb = np.zeros(frames.shape[1:], np.float32)
    one = np.float32(1.0)
    for k, img in enumerate(frames):
        w = np.float32(min(max_weight, k / (k + 1)) if k else 0.0)
        fb = fma_f32(fb, w, img * (one - w))
    return fb


class Reference:
    """The plain reference of one cell, on ``device``, in ``dtype``: the
    reference package ``reference`` (``Cell.reference``; by default
    ``benchmark.reference``), its world and views built by the world
    module ``world`` (``Cell.world``; by default ``benchmark/world.py``)."""

    def __init__(self, cfg: dict, traffic: dict, key_seed: int, device, dtype=torch.float32,
                 world=None, reference=None):
        self.pkg = pkg = reference or registry.reference_package(registry.HERE.parent)
        world = world or registry.world_module(registry.HERE.parent)
        self.width, self.height = int(cfg["width"]), int(cfg["height"])
        self.depth = int(cfg["max_depth"])
        self.device = torch.device(device)
        self.dtype = dtype
        self.world = world.build_world(cfg, pkg.api)
        self.views = world.views(cfg, traffic, pkg.api)
        sort = (len(self.world.spheres) > SPATIAL_SORT_MIN
                or self.world.triangle_count > SPATIAL_SORT_MIN)
        scene = pkg.compile.compile_scene(self.world, spatial_sort=sort, device=self.device)
        self.tables = pkg.gates.gate_tables(scene)
        gates = self.tables.gates
        if dtype != torch.float32:
            scene = _cast_scene(scene, dtype)
            gates = gates._replace(**{k: None if getattr(gates, k) is None
                                      else getattr(gates, k).to(dtype)
                                      for k in ("aabb", "saabb", "traabb", "tsaabb")})
        self.scene, self.gates = scene, gates
        self.lights = pkg.lights.extract_lights(self.world) if cfg["nee"] else None
        self.sky = self.world.ambient
        self.key = pkg.rng.key_from_seed(key_seed)

    def camera(self, view: Optional[int]):
        cam = self.world.camera if view is None else self.views[view]
        packed = self.pkg.camera.pack_camera(cam, self.width, self.height)
        return torch.from_numpy(packed).to(self.device, self.dtype)

    def _frames(self, ans: Answer, ix: np.ndarray, iy: np.ndarray) -> tuple:
        """Per-frame images [frames, P, 3] of ``ans`` at the pixels, and
        the segments traced."""
        n_pix = ix.shape[0]
        lanes = n_pix * ans.frames
        cam = self.camera(ans.view)
        rint = self.pkg.integrator
        ray_gen = rint.ray_generator(self.pkg.api.Camera(), self.width, self.height, cam)
        dev = self.device
        pix_x = torch.from_numpy(np.tile(ix, ans.frames)).to(dev)
        pix_y = torch.from_numpy(np.tile(iy, ans.frames)).to(dev)
        starts = (ans.sample_start
                  + ans.spp * torch.arange(ans.frames, dtype=torch.int64).repeat_interleave(n_pix))
        starts = starts.to(dev)
        per = max(1, RAY_BUDGET // max(1, ans.spp))
        out, segs = [], 0
        for a in range(0, lanes, per):
            b = min(lanes, a + per)
            acc, sg = rint.pixel_sums(
                self.scene, ray_gen, pix_x[a:b], pix_y[a:b], starts[a:b], ans.spp, self.key,
                self.width, self.depth, T_MIN, T_MAX, sky=self.sky, lens_draws=True,
                sample_batch=max(1, RAY_BUDGET // (b - a)), gates=self.gates,
                nee_lights=self.lights)
            # The renderer's division (integrator.frame_renderer), on the device.
            out.append((acc.stacked(-1) * (1.0 / ans.spp)).float().cpu())
            segs += int(sg.sum())
        imgs = torch.cat(out).numpy().reshape(ans.frames, n_pix, 3)
        return imgs, segs

    def _adaptive(self, ans: Answer, ix: np.ndarray, iy: np.ndarray) -> tuple:
        """An adaptive image's pixels [P, 3], as the session folds them,
        the segments traced and the samples: each pixel's windows of
        ``ans.spp`` samples from its block's cursor, one lane a window."""
        b = ans.blocks
        start = b.start[iy // b.height, ix // b.width]
        count = b.count[iy // b.height, ix // b.width]
        if np.any(count % ans.spp):
            raise ValueError("a block's samples are not whole windows")
        windows = count // ans.spp
        pix = np.repeat(np.arange(ix.shape[0]), windows)
        win = np.arange(pix.shape[0]) - np.repeat(np.cumsum(windows) - windows, windows)
        cam = self.camera(ans.view)
        rint = self.pkg.integrator
        ray_gen = rint.ray_generator(self.pkg.api.Camera(), self.width, self.height, cam)
        dev = self.device
        pix_x = torch.from_numpy(ix[pix]).to(dev)
        pix_y = torch.from_numpy(iy[pix]).to(dev)
        starts = torch.from_numpy(start[pix] + ans.spp * win).to(dev)
        sums = torch.zeros((int(windows.max(initial=0)), ix.shape[0], 3), dtype=torch.float32)
        lanes = pix.shape[0]
        per = max(1, RAY_BUDGET // ans.spp)
        segs = 0
        for a in range(0, lanes, per):
            e = min(lanes, a + per)
            acc, sg = rint.pixel_sums(
                self.scene, ray_gen, pix_x[a:e], pix_y[a:e], starts[a:e], ans.spp, self.key,
                self.width, self.depth, T_MIN, T_MAX, sky=self.sky, lens_draws=True,
                sample_batch=max(1, RAY_BUDGET // (e - a)), gates=self.gates,
                nee_lights=self.lights)
            sums[torch.from_numpy(win[a:e]), torch.from_numpy(pix[a:e])] = \
                acc.stacked(-1).float().cpu()
            segs += int(sg.sum())
        values = self.pkg.adaptive.fold(sums, torch.from_numpy(windows), ans.spp).numpy()
        return values, segs, int(count.sum())

    def read(self, answers, ix: np.ndarray, iy: np.ndarray, count: bool = False) -> Reading:
        """The reference's pixels of each answer (blended as the session
        blends), its segments and samples; with ``count`` the sweep's
        tests too (``hit.count_tests``)."""
        values, segs, samples = [], 0, 0
        counting = self.pkg.hit.count_tests() if count else contextlib.nullcontext()
        with counting as tests, self.pkg.vec.computing_in(self.dtype), torch.no_grad():
            for ans in answers:
                if ans.blocks is not None:
                    v, s, n = self._adaptive(ans, ix, iy)
                    values.append(v)
                    segs += s
                    samples += n
                    continue
                imgs, s = self._frames(ans, ix, iy)
                values.append(blend(imgs))
                segs += s
                samples += ix.shape[0] * ans.frames * ans.spp
        return Reading(np.stack(values), segs, samples, tests)


def _cast_scene(scene, dtype):
    """The compiled scene with its float tables in ``dtype``."""
    def cast(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype) if v.is_floating_point() else v
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*(cast(x) for x in v))
        return v
    return cast(scene)


def program_values(answers, ix: np.ndarray, iy: np.ndarray) -> np.ndarray:
    """The program's framebuffers at the pixels, [answers, P, 3]."""
    return np.stack([a.framebuffer[iy, ix, :] for a in answers]).astype(np.float32)


def max_abs_diff(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want|; a NaN on one side only is infinitely far,
    on both sides it agrees."""
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    both = np.isnan(got) & np.isnan(want)
    d = np.where(both, 0.0, d)
    d = np.where(np.isnan(d), np.inf, d)
    return float(d.max()) if d.size else 0.0


def segments_gap(prog_segments: float, prog_samples: float, ref: Reading) -> float:
    """|program's segments a sample - the reference's| / the reference's."""
    if not prog_samples or not ref.samples or not ref.segments:
        return math.inf
    want = ref.segments / ref.samples
    return abs(prog_segments / prog_samples - want) / want


def samples_gap(answers) -> float:
    """The largest |samples an adaptive image's spp map holds - samples the
    run asked of it| / asked, whole blocks counted; 0 with no adaptive
    answer."""
    gaps = [abs(int(a.blocks.count.sum()) * a.blocks.width * a.blocks.height - a.blocks.asked)
            / a.blocks.asked for a in answers if a.blocks is not None]
    return max(gaps, default=0.0)


def numbers(answers, reading: Reading, ix, iy, width: int, height: int) -> dict:
    """The numbers compared, for the program's answers."""
    prog_segs = sum(a.segments for a in answers)
    prog_samples = sum(width * height * a.frames * a.spp if a.blocks is None else a.blocks.samples
                       for a in answers)
    nums = {
        "fb_max_abs_diff": max_abs_diff(program_values(answers, ix, iy), reading.values),
        "segs_rel_gap": segments_gap(prog_segs, prog_samples, reading),
    }
    if any(a.blocks is not None for a in answers):
        nums["samples_gap"] = samples_gap(answers)
    return nums


def control_numbers(control: Reading, reading: Reading, answers=()) -> dict:
    """The same numbers for the control put in the program's place: its
    pixels, and its segments a sample over the same pixels; an adaptive
    image's samples are the program's schedule, which the control takes."""
    nums = {
        "fb_max_abs_diff": max_abs_diff(control.values, reading.values),
        "segs_rel_gap": segments_gap(control.segments, control.samples, reading),
    }
    if any(a.blocks is not None for a in answers):
        nums["samples_gap"] = samples_gap(answers)
    return nums


def verdict(nums: dict, limits: dict) -> dict:
    """Each number beside its limit, in the order of ``limits``."""
    return {k: {"value": nums[k], "limit": limits[k]} for k in limits}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
