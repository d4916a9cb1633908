"""Variance-guided adaptive sampling (extension; no reference counterpart).

Port of ``myraytracer_tpu.render.adaptive`` for one device. The image is
split into ``BLOCK_W`` x ``BLOCK_H`` pixel blocks; each block tracks the
variance of its per-round mean estimates, and every round renders only the
``n_sel`` blocks with the largest expected error reduction. A pixel's n-th
sample is the same threefry draw whenever its block is scheduled, so an
adaptive render of a block is bitwise the uniform render of its pixels over
the same sample window, and the estimator stays a plain per-pixel mean.

Scoring: for a block rendered r rounds of k samples, each pixel's
round-means m_i are iid with Var(m) = sigma^2/k, estimated by S2 = (s2 -
s1^2/r)/(r-1). One more round shrinks the pixel's MSE from S2/r to
S2/(r+1), so the block score is the pixel mean of S2/(r(r+1)). Blocks with
r < 2 score +inf (the bootstrap covers every block twice first).

The statistics are held bitwise to the JAX package's on the same inputs:
the fold and the scores reproduce the arithmetic XLA's CPU backend
compiles (its fused multiply-adds, its reduction order), and the selection
breaks ties toward the lowest block id as ``lax.top_k`` does. A state on
the CPU takes the plain functions here (``_update_stats``,
``_block_scores``, ``select_blocks``); a state on a CUDA device takes their
kernels (``kernels.adaptive``: one launch to score and pick a round, one
to fold a call's windows), bitwise the plain functions.

Tile sharding (``config.shard = "tiles"``, a mesh of ``ndev > 1``
entries): entry d owns the contiguous block-id stripe ``[d*local_nb,
(d+1)*local_nb)`` of the grid, keeps that stripe's statistics on its device
(``local_nb + 1`` rows, the spare one for sentinels), and picks its own top
``n_sel_local`` blocks a round: one adaptive launch a stripe a round, with
no communication between stripes. Ids past the grid in the last stripe are
dead and scheduled as the sentinel. A block renders the same wherever it is
owned (the sample stream is per pixel), so a sharded schedule is bitwise
the unsharded one. Under several processes each rank holds only its own
stripes; the framebuffer, the spp map, the segments and checkpoints gather
them (``parallel.sharding.fetch_array``), collectives every rank joins.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.kernels import adaptive as kadaptive
from myraytracer_tpu_torch.parallel import sharding
from myraytracer_tpu_torch.render import integrator
from myraytracer_tpu_torch.render.camera import pack_camera
from myraytracer_tpu_torch.render.dispatch import resolve_backend
from myraytracer_tpu_torch.render.lights import extract_lights
from myraytracer_tpu_torch.render.session import (
    CHECKPOINT_VERSION, camera_from_view, camera_view, fma_f32, scene_fingerprint,
    session_scene,
)
from myraytracer_tpu_torch.scene import api
from myraytracer_tpu_torch.scene.compile import CompiledScene
from myraytracer_tpu_torch.utils import profiling

# The JAX kernel's 16x128 lane tile as a pixel block: BLOCK_W = 64 and
# block_h = DEFAULT_TILE_ROWS * LANES // BLOCK_W = 16 * 128 // 64. Part of
# checkpoint provenance, and what makes block ids match the reference's.
BLOCK_W = 64
BLOCK_H = 32

# XLA's CPU backend reduces a [.., 32, 64] block in windows of 32x32
# elements, each summed in row-major order, then adds the windows.
_REDUCE_WINDOW = 32


def block_geometry(width, height, block_w, block_h):
    """Block-grid shape for an image: (blocks_x, blocks_y, n_blocks)."""
    bx = -(-width // block_w)
    by = -(-height // block_h)
    return bx, by, bx * by


def adaptive_block_sums(
    scene: CompiledScene, cam: api.Camera, key, width: int, height: int,
    block_ids: torch.Tensor, samp0: torch.Tensor, spp: int, windows: int,
    depth: int, t_min: float = 1e-3, t_max: float = 1e4, sky=None, gates=None,
    nee_lights=None, qmc: bool = False, rr: int = 0, rng_mode: str = "threefry",
):
    """The plain version of the CUDA adaptive kernel.

    Block ``block_ids[i]`` is rendered over ``windows`` windows of ``spp``
    samples from its cursor ``samp0[i]``. Returns ``(sums [windows, n_sel,
    BLOCK_H, BLOCK_W, 3] f32, segs [n_sel, BLOCK_H, BLOCK_W] f32)``: the
    sentinel id (``n_blocks``) and pixels past the image's edge hold zeros.
    Each pixel's sums are ``integrator.pixel_sums``', as the uniform
    renderer's are, behind the kernel's ``gates`` when they are given, with
    the estimator's modes (``nee_lights``, ``qmc``, ``rr``) and the
    sample stream (``rng_mode``, ``integrator.check_rng_mode``).
    """
    integrator.check_rng_mode(rng_mode)
    dev = scene.device
    ids = block_ids.to(device=dev, dtype=torch.int64)
    s0 = samp0.to(device=dev, dtype=torch.int64)
    blocks_x, _, n_blocks = block_geometry(width, height, BLOCK_W, BLOCK_H)
    n_sel, lanes = ids.shape[0], BLOCK_H * BLOCK_W
    local = torch.arange(lanes, dtype=torch.int64, device=dev)[None, :]
    ix = (ids % blocks_x)[:, None] * BLOCK_W + local % BLOCK_W
    iy = (ids // blocks_x)[:, None] * BLOCK_H + local // BLOCK_W
    live = (ids < n_blocks)[:, None] & (ix < width) & (iy < height)
    at = live.reshape(-1).nonzero().squeeze(1)
    ix, iy = ix.reshape(-1)[at], iy.reshape(-1)[at]
    start = s0[:, None].expand(n_sel, lanes).reshape(-1)[at]

    sums = torch.zeros((windows, n_sel * lanes, 3), dtype=torch.float32, device=dev)
    segs = torch.zeros((n_sel * lanes,), dtype=torch.int32, device=dev)
    if at.numel():
        ray_gen = integrator.ray_generator(cam, width, height, scene.cam)
        for f in range(windows):
            acc, sg = integrator.pixel_sums(
                scene, ray_gen, ix, iy, start + f * spp, spp, key, width,
                depth, t_min, t_max, sky=sky,
                lens_draws=not cam.reference_mode, sample_batch=spp,
                gates=gates, nee_lights=nee_lights, qmc=qmc, rr=rr, rng_mode=rng_mode,
            )
            sums[f, at] = acc.stacked(-1)
            segs[at] += sg
    return (sums.view(windows, n_sel, BLOCK_H, BLOCK_W, 3),
            segs.to(torch.float32).view(n_sel, BLOCK_H, BLOCK_W))


def make_adaptive_oracle(
    cam,
    width: int,
    height: int,
    n_sel: int,
    max_samples: int,
    ray_depth: int,
    t_min: float = 1e-3,
    t_max: float = 1e4,
    sky=None,
    nee_lights=None,
    material_set=None,
    texture_set=None,
    qmc: bool = False,
    rr: int = 0,
    windows: int = 1,
    rng_mode: str = "threefry",
):
    """Plain adaptive block renderer (the oracle; the CPU path).

    Returns ``render(scene, key, block_ids, samp0) -> (block_sums [n_sel,
    BLOCK_H, BLOCK_W, 3] f32, segments f64 scalar)``: for each selected
    block, the SUM of radiance over per-pixel sample indices ``[samp0[i],
    samp0[i] + max_samples)``. ``block_ids`` may hold the sentinel
    ``blocks_x * blocks_y`` (renders nothing). ``windows = F > 1`` renders
    F consecutive max_samples-sample windows per block and returns
    ``[F, n_sel, BLOCK_H, BLOCK_W, 3]``. ``rng_mode`` selects the sample
    stream, as for ``integrator.make_block_renderer``.
    """
    # The oracle renders whatever id list it is handed; emission and the
    # texture rows are read off the scene.
    del n_sel, material_set, texture_set
    integrator.check_rng_mode(rng_mode)
    spp, windows = int(max_samples), int(windows)

    def render(scene: CompiledScene, key, block_ids, samp0):
        sums, segs = adaptive_block_sums(
            scene, cam, key, width, height, block_ids, samp0, spp, windows,
            ray_depth, t_min, t_max, sky, nee_lights=nee_lights, qmc=qmc, rr=rr,
            rng_mode=rng_mode,
        )
        return (sums if windows > 1 else sums[0]), segs.sum(dtype=torch.float64)

    return render


# --- statistics -------------------------------------------------------------


def _update_stats(fbB, s1, s2, n_b, r_b, cursor, idx, sums, k):
    """Fold one round's block sums into the running state.

    fbB  [n_blocks+1, bh, bw, 3]  per-pixel running mean
    s1/s2 [n_blocks+1, bh, bw]    sums of per-round mean luminance (and sq)
    n_b/r_b [n_blocks+1] i32      per-block sample / round counts
    cursor [n_blocks+1] i64       per-block sample-index cursors (u32 values)
    idx  [n_sel] i64              selected rows (sentinels land in the spare
                                  last row, once however often they repeat)
    sums [n_sel, bh, bw, 3]       radiance sums of this round
    k    int                      samples per pixel this round

    Bitwise JAX's ``_update_stats`` (``render/adaptive.py:194-233``) as XLA
    compiles it on the CPU: the scatter sums one block (or zeros) into each
    row, ``fbB*n + scattered`` and ``s2 + lum*lum`` are fused
    multiply-adds, and the channel mean is a sum times the f32 1/3.
    """
    nb1 = fbB.shape[0]
    sel = torch.zeros(nb1, dtype=torch.bool, device=fbB.device)
    sel[idx] = True
    scattered = torch.zeros_like(fbB).index_add_(0, idx, sums)
    n_old = n_b.to(torch.float32)[:, None, None, None]
    kf = float(k)
    fbB = torch.where(
        sel[:, None, None, None], fma_f32(fbB, n_old, scattered) / (n_old + kf), fbB,
    )
    lum = (scattered[..., 0] + scattered[..., 1] + scattered[..., 2]) * (1.0 / 3.0) / kf
    s1 = s1 + lum
    s2 = fma_f32(lum, lum, s2)
    seli = sel.to(torch.int32)
    return fbB, s1, s2, n_b + k * seli, r_b + seli, cursor + k * seli.to(torch.int64)


def _block_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over the last two axes of ``[n, 32, 64]``, in the order XLA's
    CPU backend sums them: each 32x32 window row-major, then the windows."""
    n, bh, bw = v.shape
    parts = v.reshape(n, bh, bw // _REDUCE_WINDOW, _REDUCE_WINDOW)
    parts = parts.permute(0, 2, 1, 3).reshape(n, bw // _REDUCE_WINDOW, -1)
    acc = parts[..., 0].clone()
    for j in range(1, parts.shape[-1]):
        acc = acc + parts[..., j]
    total = acc[:, 0]
    for w in range(1, acc.shape[1]):
        total = total + acc[:, w]
    return total * (1.0 / (bh * bw))


def _block_scores(s1, s2, r_b):
    """Expected per-pixel MSE reduction of re-rendering each block.

    Blocks with r < 2 rounds score +inf (must bootstrap); the spare
    sentinel row is excluded by the caller. Bitwise JAX's
    ``_block_scores`` (``render/adaptive.py:236-249``) on the CPU.
    """
    if tuple(s1.shape[1:]) != (BLOCK_H, BLOCK_W):
        raise ValueError(f"blocks are {BLOCK_H}x{BLOCK_W}, got {tuple(s1.shape[1:])}")
    r = r_b.to(torch.float32)[:, None, None]
    var_m = (s2 - s1 * s1 / torch.clamp(r, min=1.0)) / torch.clamp(r - 1.0, min=1.0)
    var_m = torch.clamp(var_m, min=0.0)  # cancellation can go tiny-negative
    rr = r[:, 0, 0]
    score = _block_mean(var_m) / (torch.clamp(rr, min=1.0) * (rr + 1.0))
    return torch.where(r_b < 2, torch.inf, score)


def select_blocks(scores: torch.Tensor, n_sel: int) -> torch.Tensor:
    """The ``n_sel`` highest scores' indices, highest first and the lowest
    index first among equals: ``lax.top_k``'s order."""
    return torch.sort(scores, descending=True, stable=True).indices[:n_sel]


def pick_blocks(s1, s2, r_b, n_sel: int, n_live: int, base: int, sentinel: int):
    """A round's picks from a state's rows: the candidates are rows ``0 ..
    nb1 - 2`` (block ids ``base ..``, the first ``n_live`` alive; dead ids
    score -inf), the top ``n_sel`` by ``select_blocks``. Returns ``(rows,
    render ids)``, a dead id's row the spare ``nb1 - 1`` and its render id
    ``sentinel``. The plain version of ``kernels.adaptive.select``."""
    n_cand = s1.shape[0] - 1
    scores = _block_scores(s1, s2, r_b)[:n_cand]
    alive = torch.arange(n_cand, device=scores.device) < n_live
    top = select_blocks(torch.where(alive, scores, -torch.inf), n_sel)
    return torch.where(alive[top], top, n_cand), torch.where(alive[top], base + top, sentinel)


def state_from_numpy(arrays, device="cpu"):
    """The port's adaptive state from the JAX session's six state arrays
    (fbB, s1, s2, n_b, r_b, cursor; ``render/adaptive.py:389-396``) or a
    checkpoint's ``state0..5``."""
    fbB, s1, s2, n_b, r_b, cursor = (np.asarray(a) for a in arrays)
    return (
        torch.from_numpy(fbB.astype(np.float32)).to(device),
        torch.from_numpy(s1.astype(np.float32)).to(device),
        torch.from_numpy(s2.astype(np.float32)).to(device),
        torch.from_numpy(n_b.astype(np.int32)).to(device),
        torch.from_numpy(r_b.astype(np.int32)).to(device),
        torch.from_numpy(cursor.astype(np.int64)).to(device),
    )


class AdaptiveSession:
    """Adaptive-budget render session.

    A step renders ``n_sel`` chosen blocks of ``samples_per_frame`` samples
    in each of ``windows`` windows; ``run_budget(total)`` spends a total
    per-image sample budget (in units of uniform frames) and returns the
    framebuffer. Sessions checkpoint and resume exactly. Backends ``auto``
    and ``cuda`` run the CUDA adaptive kernel (and raise without a GPU),
    ``torch`` the plain oracle on the CPU; ``cpu`` raises. ``shard="tiles"``
    splits the block grid into stripes over ``mesh`` (default
    ``sharding.default_mesh``; module docstring).

    ``renderer_factory(**kw)``, where given, builds the block renderer from
    the keywords the backend's own factory receives (``cam``, ``width``,
    ``height``, ``n_sel``, ``max_samples``, ``ray_depth``, ``windows``,
    ``t_min``, ``t_max``, ``material_set``, ``sky``, ``nee_lights``,
    ``texture_set``, ``qmc``, ``rr``). ``interpret`` runs the kernel's plain
    version (``kernels.trace.trace_adaptive_plain``, the kernel's gates
    included) on the session's device in its place: the counterpart of the
    JAX session's Pallas interpret mode. The parameters are the JAX
    session's, in its order.
    """

    def __init__(
        self,
        world: api.World,
        config: RenderConfig = RenderConfig(),
        n_sel: int = 0,
        renderer_factory=None,
        interpret: bool = False,
        mesh=None,
    ):
        if config.shard not in ("none", "tiles"):
            raise ValueError(
                "adaptive sampling shards over image tiles only: the "
                "sample/hybrid modes would split each block's sample "
                "window across devices, which the per-block cursors do "
                "not describe; use shard='none' or shard='tiles'"
            )
        self.world = world
        self.config = config
        self.camera = world.camera  # the view rendered, as RenderSession.camera
        self.width, self.height = config.resolve_size()
        self.backend_resolved = resolve_backend(config)
        if self.backend_resolved == "cpu":
            raise ValueError(
                "adaptive sampling runs on the cuda and torch backends (the "
                "native cpu renderer has no block renderer); use backend "
                "'auto', 'cuda' or 'torch'"
            )
        self.device = torch.device(
            "cuda" if self.backend_resolved == "cuda" else "cpu"
        )
        self.block_w, self.block_h = BLOCK_W, BLOCK_H
        self.blocks_x, self.blocks_y, self.n_blocks = block_geometry(
            self.width, self.height, self.block_w, self.block_h
        )
        self.sentinel = self.n_blocks  # one-past-grid block id: renders nothing
        self.mesh = None
        if config.shard == "tiles":
            self.mesh = mesh if mesh is not None else sharding.default_mesh(
                device_type=self.device.type)
        self.ndev = self.mesh.shape["tiles"] if self.mesh is not None else 1
        if n_sel <= 0:
            n_sel = max(1, self.n_blocks // 4)
        n_sel = min(n_sel, self.n_blocks)
        # Stripe d: block ids [d*local_nb, (d+1)*local_nb) within the grid,
        # n_sel_local of them a round; sel_real counts the real (not dead)
        # blocks an auto round selects.
        self.local_nb = -(-self.n_blocks // self.ndev)
        self.n_sel_local = min(-(-n_sel // self.ndev), self.local_nb)
        self.n_sel = self.n_sel_local * self.ndev
        self.sel_real = sum(
            min(self.n_sel_local, max(0, min(self.local_nb, self.n_blocks - d * self.local_nb)))
            for d in range(self.ndev)
        )

        self.scene = session_scene(world, self.backend_resolved, self.width, self.height)
        self.key = crng.key_from_seed(config.seed)

        self.windows = config.resolve_adaptive_windows(self.backend_resolved)
        if renderer_factory is None:
            if interpret or self.backend_resolved == "cuda":
                from myraytracer_tpu_torch.kernels import trace as ktrace

                renderer_factory = (ktrace.make_adaptive_plain_renderer if interpret
                                    else ktrace.make_adaptive_renderer)
            else:
                renderer_factory = make_adaptive_oracle
        self._make_render = lambda: renderer_factory(
            cam=world.camera, width=self.width, height=self.height,
            n_sel=self.n_sel_local, max_samples=config.samples_per_frame,
            ray_depth=config.ray_depth, windows=self.windows,
            t_min=config.t_min, t_max=config.t_max,
            material_set=world.material_set or None, sky=world.ambient,
            nee_lights=extract_lights(world) if config.nee else None,
            texture_set=world.texture_set or None, qmc=config.qmc,
            rr=config.rr,
        )
        self._render = self._make_render()

        nb1 = self.local_nb + 1  # spare row absorbs sentinel scatters
        bshape = (nb1, self.block_h, self.block_w)
        zeros = (
            np.zeros(bshape + (3,), np.float32),  # fbB: pixel mean
            np.zeros(bshape, np.float32),  # s1: sum of round means
            np.zeros(bshape, np.float32),  # s2: sum of sq round means
            np.zeros((nb1,), np.int32),  # n_b: per-block samples
            np.zeros((nb1,), np.int32),  # r_b: per-block rounds
            np.zeros((nb1,), np.int64),  # cursor: sample start
        )
        if self.ndev == 1:
            self._state = state_from_numpy(zeros, self.device)
        else:
            # One state a stripe, on its entry's device; None where another
            # process owns the stripe.
            self._state = [
                state_from_numpy(zeros, self.mesh.device_of(d)) if d in self.mesh.local
                else None for d in range(self.ndev)
            ]
            self._renders = {}  # one renderer a device, each with its tables
            self._place = sharding.Placement()
        self.rounds = 0  # sub-rounds since the last set_camera
        # Sub-rounds since construction: the per-block cursors keep
        # advancing across set_camera, so the headroom guard counts these
        # (the JAX session checks against ``rounds``, which set_camera
        # resets, and undercounts).
        self.sub_rounds = 0
        self.samples_spent = 0  # total per-pixel samples x pixels rendered
        self._bootstrapped = False
        self._segs_pending = []
        self._segs_total = 0.0

    # -- rounds ---------------------------------------------------------------

    def _fold(self, state, render, scene, lidx, render_ids):
        """Render ``render_ids`` (sentinel allowed) and fold the F window
        sums into the statistics rows ``lidx`` of ``state`` in sample
        order: bitwise what F separate rounds produce. A CUDA state folds
        in one launch."""
        samp0 = state[5][lidx]  # a sentinel reads the spare row's
        sums, segs = render(scene, self.key, render_ids, samp0)
        if self.windows == 1:
            sums = sums[None]
        k = self.config.samples_per_frame
        if state[0].device.type == "cpu":
            for sums_w in sums:
                state = _update_stats(*state, lidx, sums_w, k)
        else:
            state = kadaptive.fold(*state, lidx, sums, k)
        if profiling.debug_nans():
            profiling.check_finite(state[0], f"adaptive round {self.rounds + self.windows}")
        self._segs_pending.append(segs.to(self.device))
        return state

    def fold_round(self, lidx: torch.Tensor, render_ids: torch.Tensor) -> None:
        """Render ``render_ids`` and fold them into rows ``lidx`` (one
        device)."""
        self._state = self._fold(self._state, self._render, self.scene, lidx, render_ids)

    def _fold_stripe(self, d: int, lidx: torch.Tensor, render_ids: torch.Tensor) -> None:
        """Stripe ``d``'s part of a round, on its entry's device: one
        launch."""
        dev = self.mesh.device_of(d)
        with sharding.on_device(dev):
            if dev not in self._renders:
                self._renders[dev] = self._make_render()
            self._state[d] = self._fold(self._state[d], self._renders[dev],
                                        self._place(self.scene, dev), lidx.to(dev),
                                        render_ids.to(dev))

    def round_ids(self, ids: torch.Tensor) -> None:
        """One call = F sub-rounds of the given block ids: ``[n_sel]``, or
        ``[ndev, n_sel_local]`` global ids on a sharded session, where each
        stripe renders the ids it owns and the sentinel for the rest."""
        if self.ndev == 1:
            ids = ids.to(device=self.device, dtype=torch.int64)
            self.fold_round(torch.clamp(ids, max=self.n_blocks), ids)
            return
        ids = torch.as_tensor(ids, dtype=torch.int64).reshape(self.ndev, self.n_sel_local)
        for d in self.mesh.local:
            base = d * self.local_nb
            gid = ids[d]
            owned = (gid >= base) & (gid < min(base + self.local_nb, self.n_blocks))
            self._fold_stripe(d, torch.where(owned, gid - base, self.local_nb),
                              torch.where(owned, gid, self.n_blocks))

    def _pick(self, state, base: int, n_sel: int):
        """Score the candidate rows of ``state`` (the block ids ``base ..``;
        ids past the grid are dead) and pick the top ``n_sel``: ``(rows,
        render ids)``, a dead id on the spare row and the sentinel. A CUDA
        state picks in one launch, a CPU state by the plain functions."""
        _, s1, s2, _, r_b, _ = state
        n_live = min(self.local_nb, max(0, self.n_blocks - base))
        pick = pick_blocks if s1.device.type == "cpu" else kadaptive.select
        return pick(s1, s2, r_b, n_sel, n_live, base, self.n_blocks)

    def round_auto(self) -> None:
        """One adaptive round: score, select the top n_sel (in each stripe,
        its top n_sel_local), render, fold."""
        if self.ndev == 1:
            self.fold_round(*self._pick(self._state, 0, self.n_sel))
            return
        for d in self.mesh.local:
            with sharding.on_device(self.mesh.device_of(d)):
                picks = self._pick(self._state[d], d * self.local_nb, self.n_sel_local)
            self._fold_stripe(d, *picks)

    def set_camera(self, cam: api.Camera) -> None:
        """Move the runtime camera and restart the adaptive schedule: the
        statistics are zeroed and the bootstrap re-armed, while the
        per-block cursors (and ``sub_rounds``) keep counting, so no draw is
        reused across views."""
        if cam.reference_mode or self.world.camera.reference_mode:
            raise ValueError(
                "the reference-mode camera is fixed by contract; "
                "use a general (lookfrom/lookat) camera scene to move"
            )
        self.scene = self.scene._replace(cam=torch.from_numpy(
            pack_camera(cam, self.width, self.height)
        ).to(self.device))
        self.camera = cam

        def restart(state):
            if state is None:
                return None
            fbB, s1, s2, n_b, r_b, cursor = state
            return (torch.zeros_like(fbB), torch.zeros_like(s1), torch.zeros_like(s2),
                    torch.zeros_like(n_b), torch.zeros_like(r_b), cursor)

        self._state = (restart(self._state) if self.ndev == 1
                       else [restart(st) for st in self._state])
        self.rounds = 0
        self.samples_spent = 0
        self._bootstrapped = False

    def _check_cursor_headroom(self) -> None:
        # Worst case, one block absorbed every sub-round since construction
        # plus the next call's F windows.
        worst = (self.sub_rounds + self.windows) * self.config.samples_per_frame
        cap = crng.M32 - (crng.QMC_SCRAMBLE_SLOTS if self.config.qmc else 0)
        if worst * crng.DRAWS_PER_SAMPLE > cap:
            raise RuntimeError(
                "per-pixel sample cursor could overflow the uint32 "
                "draw-index space: the RNG stream would alias"
            )

    def _count_call(self, n_real: int) -> None:
        self.rounds += self.windows
        self.sub_rounds += self.windows
        self.samples_spent += (
            n_real * self.block_h * self.block_w
            * self.config.samples_per_frame * self.windows
        )

    def bootstrap(self, covers: int = 2) -> None:
        """Render every block until it has >= ``covers`` statistics rounds
        (variance needs r >= 2); one call contributes F windows. Call c
        renders chunk c of every stripe; ids past a stripe's real blocks
        schedule the sentinel."""
        chunks = -(-self.local_nb // self.n_sel_local)
        for _ in range(-(-covers // self.windows)):
            for c in range(chunks):
                ids = np.empty((self.ndev, self.n_sel_local), np.int64)
                for d in range(self.ndev):
                    stripe_end = min((d + 1) * self.local_nb, self.n_blocks)
                    cand = (d * self.local_nb + c * self.n_sel_local
                            + np.arange(self.n_sel_local, dtype=np.int64))
                    cand[cand >= stripe_end] = self.sentinel
                    ids[d] = cand
                n_real = int((ids != self.sentinel).sum())
                if n_real == 0:
                    continue
                self._check_cursor_headroom()
                self.round_ids(torch.from_numpy(ids if self.ndev > 1 else ids[0]))
                self._count_call(n_real)
        self._bootstrapped = True

    def step(self) -> None:
        """One adaptive round (the bootstrap first, on a fresh session)."""
        if not self._bootstrapped:
            self.bootstrap()
            return
        self._check_cursor_headroom()
        self.round_auto()
        self._count_call(self.sel_real)

    def round_cost(self) -> int:
        """Samples (per-pixel samples x pixels) one auto round spends."""
        return (self.sel_real * self.block_h * self.block_w
                * self.config.samples_per_frame * self.windows)

    def run_budget(self, uniform_frames: int) -> torch.Tensor:
        """Spend the sample budget of ``uniform_frames`` uniform frames
        (bootstrap included), then return the framebuffer."""
        budget = (
            int(uniform_frames) * self.config.samples_per_frame
            * self.width * self.height
        )
        while self.samples_spent + self.round_cost() <= budget:
            self.step()
        return self.framebuffer

    # -- checkpoint / resume --------------------------------------------------

    def _meta(self) -> dict:
        return {
            "version": CHECKPOINT_VERSION,
            "adaptive": True,
            "width": self.width,
            "height": self.height,
            "samples_per_frame": self.config.samples_per_frame,
            "ray_depth": self.config.ray_depth,
            "seed": self.config.seed,
            "t_min": self.config.t_min,
            "t_max": self.config.t_max,
            "nee": self.config.nee,
            "nee_estimator": "mis" if self.config.nee else None,
            "qmc": self.config.qmc,
            "rr": self.config.rr,
            "scene": scene_fingerprint(self.scene),
            "backend": self.backend_resolved,
            "n_sel": self.n_sel,
            "windows": self.windows,
            "block_w": self.block_w,
            "block_h": self.block_h,
            "shard": self.config.shard,
            "ndev": self.ndev,
        }

    def _stacked(self, i: int, fetch: bool = True) -> torch.Tensor:
        """State array ``i`` as the JAX session holds it: ``[ndev, local_nb
        + 1, ...]`` for a sharded session, on the session's device.
        ``fetch`` gathers other processes' stripes (a collective); without
        it their rows are zeros."""
        if self.ndev == 1:
            return self._state[i]
        mine = next(st for st in self._state if st is not None)[i]
        local = torch.stack([
            st[i].to(self.device) if st is not None
            else torch.zeros(mine.shape, dtype=mine.dtype, device=self.device)
            for st in self._state])
        if not fetch or self.mesh.proc is None:
            return local
        rows = sharding.Rows(self.mesh, tuple((d, d + 1) for d in range(self.ndev)))
        return torch.from_numpy(sharding.fetch_array(local, rows)).to(self.device)

    def _unstripe(self, a: torch.Tensor) -> torch.Tensor:
        """``[ndev, local_nb + 1, ...]`` → ``[n_blocks, ...]`` in block-id
        order (each stripe's spare row dropped)."""
        if self.ndev == 1:
            return a[: self.n_blocks]
        return a[:, : self.local_nb].reshape((-1,) + tuple(a.shape[2:]))[: self.n_blocks]

    def save_checkpoint(self, path) -> None:
        """Save the adaptive state (per-block statistics and cursors) to an
        npz in the JAX package's format (version 3, the same meta keys).

        ``path=None`` joins the state's gather without writing a file: under
        several processes the stripes are gathered with collectives every
        rank must join, while one rank owns the file."""
        arrays = {f"state{i}": self._stacked(i).cpu().numpy() for i in range(6)}
        arrays["state5"] = arrays["state5"].astype(np.uint32)
        arrays.update(
            rounds=np.int64(self.rounds),
            sub_rounds=np.int64(self.sub_rounds),
            samples_spent=np.int64(self.samples_spent),
            segments_traced=np.float64(self.segments_traced),
            meta=json.dumps({**self._meta(), **(
                {"view": camera_view(self.camera)} if self.scene.cam is not None else {})}),
        )
        if self.scene.cam is not None:
            # The runtime camera: the accumulated state describes its view.
            arrays["camera"] = self.scene.cam.cpu().numpy()
        if path is not None:
            np.savez(pathlib.Path(path), **arrays)

    def load_checkpoint(self, path) -> None:
        with np.load(pathlib.Path(path), allow_pickle=False) as data:
            meta = json.loads(str(data["meta"]))
            if meta.get("version") != CHECKPOINT_VERSION:
                raise ValueError(
                    f"checkpoint version {meta.get('version')} unsupported"
                )
            if not meta.get("adaptive"):
                raise ValueError(
                    "not an adaptive checkpoint (uniform sessions resume via "
                    "RenderSession.load_checkpoint)"
                )
            defaults = {"shard": "none", "ndev": 1}
            for k, v in self._meta().items():
                if k not in ("version", "adaptive") and meta.get(k, defaults.get(k)) != v:
                    raise ValueError(f"checkpoint {k}={meta.get(k)!r} != session {v!r}")
            arrays = [data[f"state{i}"] for i in range(6)]
            if self.ndev == 1:
                self._state = state_from_numpy(arrays, self.device)
            else:
                self._state = [
                    state_from_numpy([a[d] for a in arrays], self.mesh.device_of(d))
                    if d in self.mesh.local else None for d in range(self.ndev)
                ]
            self.rounds = int(data["rounds"])
            self.sub_rounds = int(data["sub_rounds"]) if "sub_rounds" in data else self.rounds
            self.samples_spent = int(data["samples_spent"])
            self._segs_total = float(data["segments_traced"])
            self._segs_pending = []
            if "camera" in data:
                self.scene = self.scene._replace(
                    cam=torch.from_numpy(data["camera"]).to(self.device)
                )
                self.camera = (camera_from_view(meta["view"]) if "view" in meta
                               else self.world.camera)
            # Resume skips the bootstrap iff the saved run completed it.
            r_b = torch.from_numpy(data["state4"])
            self._bootstrapped = bool((self._unstripe(r_b) >= 2).all())

    # -- outputs --------------------------------------------------------------

    @property
    def bootstrapped(self) -> bool:
        """True once every block has >= 2 statistics rounds."""
        return self._bootstrapped

    def _image(self, fbB: torch.Tensor) -> torch.Tensor:
        fb = self._unstripe(fbB).reshape(
            self.blocks_y, self.blocks_x, self.block_h, self.block_w, 3
        )
        fb = fb.permute(0, 2, 1, 3, 4).reshape(
            self.blocks_y * self.block_h, self.blocks_x * self.block_w, 3
        )
        return fb[: self.height, : self.width]

    @property
    def framebuffer(self) -> torch.Tensor:
        """Current per-pixel mean image [H, W, 3]; under several processes
        only this rank's stripes (``fetch_framebuffer`` gathers them)."""
        return self._image(self._stacked(0, fetch=False))

    def fetch_framebuffer(self) -> torch.Tensor:
        """The whole image [H, W, 3] on the session's device (a gather every
        rank joins under several processes)."""
        return self._image(self._stacked(0))

    @property
    def spp_map(self) -> np.ndarray:
        """Per-pixel accumulated sample count [H, W] (a host read; a gather
        every rank joins under several processes)."""
        n = self._unstripe(self._stacked(3)).cpu().numpy()
        m = np.repeat(
            np.repeat(n.reshape(self.blocks_y, self.blocks_x), self.block_h, axis=0),
            self.block_w, axis=1,
        )
        return m[: self.height, : self.width]

    @property
    def segments_traced(self) -> float:
        """Total ray segments traced (waits for pending device work); under
        several processes every rank's (an ``all_reduce`` every rank
        joins)."""
        pending, self._segs_pending = self._segs_pending, []
        self._segs_total += sharding.total_segments(pending, self.mesh)
        return self._segs_total
