"""Frozen copy of ``myraytracer_tpu_torch/render/hit.py`` at commit 32ae5bc, for
the benchmark's reference; imports made local. Edits: the sweep's window in the float type of ``vec.computing_in``.

Batched ray-primitive closest hit.

Port of ``myraytracer_tpu.render.hit``. The reference's per-thread linear
scan with a shrinking ``t_sup`` window (``shader.wgsl:314-329``) becomes a
min-reduction over the primitive axis, vectorized over all ray lanes, in
chunks of primitives so the ``[chunk, rays]`` intermediates stay bounded at
full image size.

Semantics kept from the reference and the JAX package:

* half-b quadratic with ``a = 1`` (ray directions are normalized);
* nearer root first, the farther root only when the nearer one is outside
  the window;
* strict ``t < t_best``: on equal t the lowest index wins, and spheres are
  swept before triangles, so a sphere wins an equal-t tie with a triangle;
* outward normal ``(at - center) * (1 / radius)`` with the signed radius,
  front-face test ``dot(normal, dir) <= 0`` and the back-face flip;
* triangles (the JAX package's extension of the reference): two-sided
  Möller-Trumbore, with the geometric normal ``e1 x e2`` normalized by
  ``rsqrt`` under the same front-face convention.

Gated sweep: ``closest_hit`` with ``gates`` is the plain version of the
CUDA kernel's sweep (``csrc/trace.cu``), which takes the JAX kernel's
gates (``myraytracer_tpu/kernels/trace.py:990-1296``): the ``LEADERS``
largest spheres with no gate, then ``CULL_CHUNK``-sphere chunks, each
entered by a lane only if its ray meets the chunk's eps-padded box before
the lane's running closest hit, and from ``SUPER_MIN`` chunks on an outer
box over every ``SUPER`` chunks tested first with the ``t_best`` from
before the group; then the triangles, in chunks behind their own boxes,
against the merged ``t_best``. A lane merges a chunk's candidates only if
it entered the chunk, so the result is the kernel's lane by lane, even
where a gate is not conservative (a grazing hit that rounding puts
outside its box). Without ``gates`` the sweep is ungated: the JAX jnp
integrator's semantics. On a textured scene the record carries the
winner's texture rows, a sphere's or, where a triangle wins, the
triangle's (JAX ``hit.py:335-394``).

Every sweep runs from a per-lane starting ``t_best``: ``t_max`` for the
path's rays, the light distance for NEE's shadow rays (``closest_t``, the
JAX kernel's ``run_hit(t_init=limit)``), so a shadow ray's gates close on
the light distance as the kernel's do. ``count_tests`` counts the
ray-primitive tests a sweep makes, for the kernel's bound.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional, Tuple

import torch

from .vec import V3, float_dtype
from .compile import LEADERS, CompiledScene, CompiledTriangles

TRI_DET_EPS = 1e-9
# The slab test's box padding and the floor of |direction| it inverts
# (JAX kernels/trace.py:992-996).
SLAB_EPS = 1e-4
DIR_TINY = 1e-30


class SweepGates(NamedTuple):
    """What the gated sweep reads: the JAX kernel's gate decisions and
    its box tables (``[6, n]`` f32: lo xyz then hi xyz), built by
    ``kernels.trace.gate_tables``."""

    sph_cull: bool  # spheres after the LEADERS swept behind chunk gates
    chunk: int  # CULL_CHUNK
    aabb: torch.Tensor  # [6, n_chunks] sphere chunk boxes
    saabb: Optional[torch.Tensor]  # [6, n_super] outer boxes, or None
    tri_cull: bool  # triangles swept behind chunk gates
    tri_chunk: int  # resolved TRI_CHUNK
    traabb: torch.Tensor  # [6, tn_chunks]
    tsaabb: Optional[torch.Tensor]  # [6, tn_super], or None
    super_w: int  # SUPER: chunks under one outer box
    # KernelConfig.SQRT_RSQRT: the spheres' root as disc * rsqrt(disc). The
    # config's other sweep forms compute the same winners, so the plain
    # version has no counterpart of them.
    sqrt_rsqrt: bool = False


class Hit(NamedTuple):
    """Per-lane closest-hit record (analog of shader.wgsl:134-140)."""

    t: torch.Tensor  # f32; == t_max where there is no hit
    idx: torch.Tensor  # int64 sphere or triangle index (0 when no hit; see mask)
    mask: torch.Tensor  # bool, True = hit something
    point: V3
    normal: V3  # flipped to oppose the ray (shader.wgsl:305-307)
    front_face: torch.Tensor  # bool
    mat_ty: torch.Tensor  # i32
    albedo: V3
    fuzz: torch.Tensor
    ior: torch.Tensor
    # The winner's texture rows (render/textures.py); None when the scene
    # is untextured.
    tex_ty: Optional[torch.Tensor] = None  # i32
    albedo2: Optional[V3] = None
    tex_scale: Optional[torch.Tensor] = None


def _chunk_size(n_prims: int, n_lanes: int) -> int:
    """Primitives per chunk, bounding each [chunk, lanes] temporary to ~16M
    f32 elements (64 MB), as the JAX package does."""
    budget = 16 << 20
    c = max(8, min(n_prims, budget // max(1, n_lanes)))
    return max(8, (c // 8) * 8)


def _sphere_t(o: V3, d: V3, scene: CompiledScene, sl: slice, t_minf, big,
              rsqrt: bool = False):
    """Candidate t of spheres ``sl`` against every lane, [k, lanes];
    ``big`` (= t_max) where a sphere is missed. ``rsqrt``: the root as
    ``disc * rsqrt(disc)`` (``KernelConfig.SQRT_RSQRT``; the JAX kernel's
    ``trace.py:848-852``), the ``disc >= 0`` term kept: ulps apart, and
    an exact tangent misses."""
    ocx = o.x[None, :] - scene.center.x[sl, None]
    ocy = o.y[None, :] - scene.center.y[sl, None]
    ocz = o.z[None, :] - scene.center.z[sl, None]
    b = ocx * d.x[None, :] + ocy * d.y[None, :] + ocz * d.z[None, :]
    c = ocx * ocx + ocy * ocy + ocz * ocz - scene.radius_sq[sl, None]
    disc = b * b - c
    sq = disc * torch.rsqrt(disc) if rsqrt else torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = -b - sq
    t2 = -b + sq
    t1_ok = (t1 >= t_minf) & (t1 < big)
    t_cand = torch.where(t1_ok, t1, t2)
    valid = (disc >= 0.0) & (t_cand >= t_minf) & (t_cand < big)
    return torch.where(valid, t_cand, big)


def _mt(o: V3, d: V3, v0: V3, e1: V3, e2: V3, t_minf, big):
    """Möller-Trumbore candidate t (two-sided; JAX ``hit.py:_mt_candidate``)
    of rays ``o + t d`` against triangles ``v0, e1, e2``, all broadcast
    together; ``big`` where a triangle is missed."""
    px = d.y * e2.z - d.z * e2.y
    py = d.z * e2.x - d.x * e2.z
    pz = d.x * e2.y - d.y * e2.x
    det = e1.x * px + e1.y * py + e1.z * pz
    small = det.abs() < TRI_DET_EPS
    inv_det = torch.reciprocal(torch.where(small, 1.0, det))
    tvx = o.x - v0.x
    tvy = o.y - v0.y
    tvz = o.z - v0.z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1.z - tvz * e1.y
    qy = tvz * e1.x - tvx * e1.z
    qz = tvx * e1.y - tvy * e1.x
    v = (d.x * qx + d.y * qy + d.z * qz) * inv_det
    t_cand = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det
    valid = (
        ~small & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t_cand >= t_minf) & (t_cand < big)
    )
    return torch.where(valid, t_cand, big)


def _triangle_t(o: V3, d: V3, tris: CompiledTriangles, sl: slice, t_minf, big):
    """Candidate t of triangles ``sl`` against every lane, [k, lanes]."""
    col = lambda a: V3(a.x[sl, None], a.y[sl, None], a.z[sl, None])  # noqa: E731
    row = lambda a: V3(a.x[None, :], a.y[None, :], a.z[None, :])  # noqa: E731
    return _mt(row(o), row(d), col(tris.v0), col(tris.e1), col(tris.e2), t_minf, big)


def _first_min(t_cand: torch.Tensor, rows: torch.Tensor):
    """(smallest t, the lowest row holding it) over dim -2 of ``t_cand``:
    a first-index-wins min, with no reliance on argmin's tie order.
    ``rows`` holds the row indices, broadcastable against ``t_cand``."""
    t_min = torch.amin(t_cand, dim=-2)
    i_min = torch.where(t_cand == t_min.unsqueeze(-2), rows, torch.iinfo(torch.int64).max)
    return t_min, i_min.amin(dim=-2)


# (lane, primitive) tests made while ``count_tests`` is open in this context.
_TESTS: contextvars.ContextVar = contextvars.ContextVar("sweep_tests", default=None)


@contextlib.contextmanager
def count_tests():
    """Count the ray-primitive tests the sweeps make inside the block.

    Yields a dict whose ``sphere`` and ``triangle`` entries hold, when the
    block ends, the (lane, primitive) pairs tested: every primitive of an
    ungated table, the leaders, and the chunks whose gates a lane entered;
    and whose ``checker``, ``marble`` and ``image`` entries hold the texture
    evaluations of each kind (``render/textures.py``). That is the CUDA
    kernel's per-thread work, which ``chip_smoke.py`` turns into the
    kernel's bound.
    """
    counts = {"sphere": 0, "triangle": 0, "checker": 0, "marble": 0, "image": 0}
    token = _TESTS.set(counts)
    try:
        yield counts
    finally:
        _TESTS.reset(token)
        for k, v in counts.items():
            counts[k] = int(v)


def counting() -> bool:
    """Whether a ``count_tests`` block is open in this context."""
    return _TESTS.get() is not None


def count_work(kind: str, n) -> None:
    """Add ``n`` to the ``kind`` entry of an open ``count_tests`` block."""
    counts = _TESTS.get()
    if counts is not None:
        counts[kind] = counts[kind] + n


def _sweep(cand, n: int, chunk: int, t_best, i_best):
    """Merge ``cand(slice)`` candidates of primitives [0, n) into the
    running (t_best, i_best), ``chunk`` primitives at a time, strict <."""
    dev = t_best.device
    for base in range(0, n, chunk):
        sl = slice(base, min(n, base + chunk))
        t_chunk, i_chunk = _first_min(
            cand(sl), torch.arange(base, sl.stop, device=dev)[:, None])
        better = t_chunk < t_best
        t_best = torch.where(better, t_chunk, t_best)
        i_best = torch.where(better, i_chunk, i_best)
    return t_best, i_best


def _window(o: V3, t_min: float, t_max: float, t_init=None):
    """``(t_min, t_max)`` as f32 scalars on the lanes' device, and the
    running ``(t_best, i_best)`` of no hit yet: ``t_init`` (t_max when None)
    and 0 per lane."""
    n_lanes, dev = o.x.shape[0], o.x.device
    f32 = float_dtype()
    if t_init is None:
        t_init = torch.full((n_lanes,), t_max, dtype=f32, device=dev)
    return (torch.tensor(t_min, dtype=f32, device=dev),
            torch.tensor(t_max, dtype=f32, device=dev),
            t_init,
            torch.zeros((n_lanes,), dtype=torch.int64, device=dev))


def _sphere_candidates(
    o: V3, d: V3, scene: CompiledScene, t_min: float, t_max: float, t_init=None,
    rsqrt: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_best, i_best) over all spheres from the running ``t_init``;
    t_best == t_init (t_max) on a miss."""
    t_minf, big, t_best, i_best = _window(o, t_min, t_max, t_init)
    n = scene.padded_size
    count_work("sphere", n * t_best.shape[0])
    return _sweep(lambda sl: _sphere_t(o, d, scene, sl, t_minf, big, rsqrt),
                  n, _chunk_size(n, t_best.shape[0]), t_best, i_best)


def _triangle_candidates(
    o: V3, d: V3, tris: CompiledTriangles, t_min: float, t_max: float, t_init=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_best, i_best) over all triangles from the running ``t_init``;
    t_best == t_init (t_max) on a miss."""
    t_minf, big, t_best, i_best = _window(o, t_min, t_max, t_init)
    n = tris.padded_size
    count_work("triangle", n * t_best.shape[0])
    # Möller-Trumbore holds about twice the temporaries: half the chunk.
    return _sweep(lambda sl: _triangle_t(o, d, tris, sl, t_minf, big),
                  n, _chunk_size(n, 2 * t_best.shape[0]), t_best, i_best)


def _triangle_bvh_candidates(
    o: V3, d: V3, tris: CompiledTriangles, t_min: float, t_max: float, t_init=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_best, i_best) over the triangles through their flat BVH
    (``tris.bvh``), from the running ``t_init``: the JAX package's stackless
    skip-link traversal (``hit.py:_triangle_bvh_candidates``), one cursor a
    lane. At node ``i`` a lane whose ray meets the box before its running
    t_best descends to ``i + 1``, or tests a leaf's ``count`` triangles,
    and continues at ``skip[i]``; a miss jumps to ``skip[i]``; a lane is
    done when its cursor reaches M. Each step runs on the lanes still
    walking, which leaves every lane's arithmetic as JAX's."""
    t_minf, big, t_best, i_best = _window(o, t_min, t_max, t_init)
    bvh = tris.bvh
    m = bvh.count.shape[0]
    iv = _inv_dir(d)
    sub = lambda v, ix: V3(v.x[ix], v.y[ix], v.z[ix])  # noqa: E731
    lanes = torch.arange(t_best.shape[0], device=t_best.device)
    node = torch.zeros_like(lanes)
    ol, dl, ivl, tb, ib = o, d, iv, t_best.clone(), i_best.clone()
    t_best, i_best = t_best.clone(), i_best.clone()
    mn, mx = torch.minimum, torch.maximum
    while lanes.numel():
        g = lambda a: a[node]  # noqa: E731
        first, count, skip = g(bvh.first).long(), g(bvh.count).long(), g(bvh.skip).long()
        tx0 = (g(bvh.lo.x) - ol.x) * ivl.x
        tx1 = (g(bvh.hi.x) - ol.x) * ivl.x
        ty0 = (g(bvh.lo.y) - ol.y) * ivl.y
        ty1 = (g(bvh.hi.y) - ol.y) * ivl.y
        tz0 = (g(bvh.lo.z) - ol.z) * ivl.z
        tz1 = (g(bvh.hi.z) - ol.z) * ivl.z
        tn = mx(mx(mn(tx0, tx1), mn(ty0, ty1)), mx(mn(tz0, tz1), t_minf))
        tf = mn(mn(mx(tx0, tx1), mx(ty0, ty1)), mn(mx(tz0, tz1), tb))
        enter = tn <= tf
        is_leaf = count > 0
        test_leaf = enter & is_leaf
        if test_leaf.any():
            for k in range(int(count[test_leaf].max())):
                live = test_leaf & (k < count)
                count_work("triangle", live.sum() if counting() else 0)
                pidx = torch.where(live, first + k, 0)
                t_cand = _mt(ol, dl, sub(tris.v0, pidx), sub(tris.e1, pidx),
                             sub(tris.e2, pidx), t_minf, big)
                t_cand = torch.where(live, t_cand, big)
                better = t_cand < tb
                tb = torch.where(better, t_cand, tb)
                ib = torch.where(better, pidx, ib)
        node = torch.where(enter & ~is_leaf, node + 1, skip)
        walking = node < m
        if not bool(walking.all()):
            done = ~walking
            t_best[lanes[done]] = tb[done]
            i_best[lanes[done]] = ib[done]
            lanes, node, tb, ib = lanes[walking], node[walking], tb[walking], ib[walking]
            ol, dl, ivl = sub(ol, walking), sub(dl, walking), sub(ivl, walking)
    return t_best, i_best


# --- the gated sweep --------------------------------------------------------


def _inv_dir(d: V3) -> V3:
    """1 / d per component, with |d| < DIR_TINY replaced by +DIR_TINY."""
    inv = lambda a: torch.reciprocal(torch.where(a.abs() < DIR_TINY, DIR_TINY, a))  # noqa: E731
    return V3(inv(d.x), inv(d.y), inv(d.z))


def _slab(box: torch.Tensor, o: V3, iv: V3, t_minf):
    """Every lane's slab test against every box of ``box`` ([6, nb]):
    ``(tn, ok)``, both [nb, lanes]. The JAX kernel's test (trace.py:998-1015)
    enters box c iff ``tn <= min(tf, t_best)``, with ``t_best`` the lane's
    running closest hit; with no NaN that is ``ok & (tn <= t_best)``, where
    ``ok`` is ``tn <= tf`` -- so the t_best-free part is computed once."""
    lo = lambda k, oc, ic: ((box[k][:, None] - SLAB_EPS) - oc[None, :]) * ic[None, :]  # noqa: E731
    hi = lambda k, oc, ic: ((box[k][:, None] + SLAB_EPS) - oc[None, :]) * ic[None, :]  # noqa: E731
    tx0, tx1 = lo(0, o.x, iv.x), hi(3, o.x, iv.x)
    ty0, ty1 = lo(1, o.y, iv.y), hi(4, o.y, iv.y)
    tz0, tz1 = lo(2, o.z, iv.z), hi(5, o.z, iv.z)
    mn, mx = torch.minimum, torch.maximum
    tn = mx(mx(mn(tx0, tx1), mn(ty0, ty1)), mx(mn(tz0, tz1), t_minf))
    tf = mn(mn(mx(tx0, tx1), mx(ty0, ty1)), mx(tz0, tz1))
    return tn, tn <= tf


def _chunk_minima(cand, lo: int, n: int, width: int, n_chunks: int, n_lanes: int, dev):
    """Each chunk's first-index minimum, ``(t, i)`` [n_chunks, lanes]: chunk
    c holds primitives ``[lo + c*width, lo + (c+1)*width)``; those at or
    past ``n`` (table padding) are misses."""
    per = max(1, (16 << 20) // max(1, width * n_lanes))  # chunks per batch
    ts, idx = [], []
    for c0 in range(0, n_chunks, per):
        c1 = min(n_chunks, c0 + per)
        a, b = lo + c0 * width, lo + c1 * width
        t = cand(slice(a, min(b, n)))
        if t.shape[0] < b - a:
            t = torch.cat([t, t.new_full((b - a - t.shape[0], n_lanes), float("inf"))])
        rows = torch.arange(a, b, device=dev).view(c1 - c0, width, 1)
        tc, ic = _first_min(t.view(c1 - c0, width, n_lanes), rows)
        ts.append(tc)
        idx.append(ic)
    return torch.cat(ts), torch.cat(idx)


def _gated_merge(t_best, i_best, won, t_c, i_c, tn_c, ok_c, tn_s, ok_s, super_w,
                 kind, width):
    """Merge chunk minima into the running hit, chunk by chunk, each behind
    its gate (and its outer gate, when ``tn_s`` is given). ``won`` marks
    the lanes any chunk improved; the lanes entering a chunk count
    ``width`` tests of ``kind`` each."""
    n_chunks = t_c.shape[0]

    def merge(c, t_best, i_best, won, outer):
        enter = ok_c[c] & (tn_c[c] <= t_best)
        if outer is not None:
            enter = enter & outer
        if counting():  # no reduction unless counting
            count_work(kind, enter.sum() * width)
        better = enter & (t_c[c] < t_best)
        return (torch.where(better, t_c[c], t_best),
                torch.where(better, i_c[c], i_best), won | better)

    if tn_s is None:
        for c in range(n_chunks):
            t_best, i_best, won = merge(c, t_best, i_best, won, None)
        return t_best, i_best, won
    for sc in range(tn_s.shape[0]):
        enter_s = ok_s[sc] & (tn_s[sc] <= t_best)  # t_best before the group
        for c in range(sc * super_w, min((sc + 1) * super_w, n_chunks)):
            t_best, i_best, won = merge(c, t_best, i_best, won, enter_s)
    return t_best, i_best, won


def _gated_candidates(cand, n, lo, width, box, sbox, super_w, o, iv, t_minf,
                      t_best, i_best, kind):
    """The gated part of one table: chunks of ``width`` from ``lo``, behind
    ``box`` (and ``sbox`` outer boxes), merged into (t_best, i_best).
    Returns (t_best, i_best, won)."""
    n_lanes, dev = t_best.shape[0], t_best.device
    n_chunks = box.shape[1]
    won = torch.zeros_like(t_best, dtype=torch.bool)
    if n_chunks == 0:
        return t_best, i_best, won
    t_c, i_c = _chunk_minima(cand, lo, n, width, n_chunks, n_lanes, dev)
    tn_c, ok_c = _slab(box, o, iv, t_minf)
    tn_s = ok_s = None
    if sbox is not None:
        tn_s, ok_s = _slab(sbox, o, iv, t_minf)
    return _gated_merge(t_best, i_best, won, t_c, i_c, tn_c, ok_c, tn_s, ok_s, super_w,
                        kind, width)


def _sphere_candidates_gated(o: V3, d: V3, scene: CompiledScene, gates: SweepGates,
                             t_min: float, t_max: float, t_init=None):
    """(t_best, i_best) over all spheres from the running ``t_init``,
    leaders first and then chunk by chunk behind the gates; equal to the
    CUDA kernel's gated sweep."""
    t_minf, big, t_best, i_best = _window(o, t_min, t_max, t_init)
    cand = lambda sl: _sphere_t(o, d, scene, sl, t_minf, big, gates.sqrt_rsqrt)  # noqa: E731
    count_work("sphere", LEADERS * t_best.shape[0])
    t_best, i_best = _sweep(cand, LEADERS, LEADERS, t_best, i_best)
    t_best, i_best, _ = _gated_candidates(
        cand, scene.padded_size, LEADERS, gates.chunk, gates.aabb,
        gates.saabb, gates.super_w, o, _inv_dir(d), t_minf, t_best, i_best, "sphere")
    return t_best, i_best


def _triangle_candidates_gated(o: V3, d: V3, tris: CompiledTriangles, gates: SweepGates,
                               t_sphere: torch.Tensor, t_min: float, t_max: float):
    """The triangles chunk by chunk behind their gates, after the spheres:
    the running t_best starts at the spheres' ``t_sphere``. Returns (t,
    i_best, tri_wins): ``tri_wins`` marks the lanes a triangle improved."""
    t_minf, big, _, i_best = _window(o, t_min, t_max)
    cand = lambda sl: _triangle_t(o, d, tris, sl, t_minf, big)  # noqa: E731
    return _gated_candidates(
        cand, tris.padded_size, 0, gates.tri_chunk, gates.traabb, gates.tsaabb,
        gates.super_w, o, _inv_dir(d), t_minf, t_sphere, i_best, "triangle")


def _closest(o: V3, d: V3, scene: CompiledScene, t_min: float, t_max: float,
             gates: Optional[SweepGates], t_init):
    """The sweep: (t_best, sphere index, triangle index, lanes a triangle
    won, or None without triangles), from the running ``t_init``."""
    if gates is not None and gates.sph_cull:
        ts, is_ = _sphere_candidates_gated(o, d, scene, gates, t_min, t_max, t_init)
    else:
        ts, is_ = _sphere_candidates(o, d, scene, t_min, t_max, t_init,
                                     gates is not None and gates.sqrt_rsqrt)
    if not scene.has_triangles:
        return ts, is_, None, None
    if gates is not None and gates.tri_cull:
        tt, it, tri_wins = _triangle_candidates_gated(
            o, d, scene.tris, gates, ts, t_min, t_max)
    elif gates is None and scene.tris.bvh is not None:
        tt, it = _triangle_bvh_candidates(o, d, scene.tris, t_min, t_max, t_init)
        tri_wins = tt < ts
    else:
        tt, it = _triangle_candidates(o, d, scene.tris, t_min, t_max, t_init)
        tri_wins = tt < ts  # spheres first: an equal-t triangle loses
    return torch.where(tri_wins, tt, ts), is_, it, tri_wins


def closest_t(o: V3, d: V3, scene: CompiledScene, t_min: float, t_max: float,
              t_init: torch.Tensor, gates: Optional[SweepGates] = None) -> torch.Tensor:
    """The sweep's t_best from a per-lane starting ``t_init`` (the shadow
    ray's, started at its light distance): below ``t_init`` iff some
    primitive is hit in ``[t_min, t_init)``. Gated like the kernel's sweep,
    which skips a chunk whose box the ray enters only after the lane's
    running t_best."""
    return _closest(o, d, scene, t_min, t_max, gates, t_init)[0]


def closest_hit(o: V3, d: V3, scene: CompiledScene, t_min: float, t_max: float,
                gates: Optional[SweepGates] = None) -> Hit:
    """Closest hit for normalized ray directions ``d`` over 1-D lanes;
    behind the kernel's gates when ``gates`` is given."""
    t_best, is_, it, tri_wins = _closest(o, d, scene, t_min, t_max, gates, None)
    mask = t_best < t_max
    point = o + d * t_best

    # One denormalized fetch of the winner's record.
    take = lambda a: a[is_]  # noqa: E731
    center = V3(take(scene.center.x), take(scene.center.y), take(scene.center.z))
    normal = (point - center) * torch.reciprocal(take(scene.radius))
    mat_ty = take(scene.mat_ty)
    albedo = V3(take(scene.albedo.x), take(scene.albedo.y), take(scene.albedo.z))
    fuzz, ior, idx = take(scene.fuzz), take(scene.ior), is_
    textured = scene.tex_ty is not None
    tex_ty = albedo2 = tex_scale = None
    if textured:
        tex_ty, tex_scale = take(scene.tex_ty), take(scene.tex_scale)
        albedo2 = V3(take(scene.albedo2.x), take(scene.albedo2.y), take(scene.albedo2.z))
    if tri_wins is not None:
        tr = scene.tris
        tk = lambda a: a[it]  # noqa: E731
        e1 = V3(tk(tr.e1.x), tk(tr.e1.y), tk(tr.e1.z))
        e2 = V3(tk(tr.e2.x), tk(tr.e2.y), tk(tr.e2.z))
        gn = e1.cross(e2)
        # Guarded: lanes that hit no triangle gather an arbitrary row.
        t_normal = gn * torch.rsqrt(torch.clamp_min(gn.length_sq(), 1e-30))
        normal = V3.where(tri_wins, t_normal, normal)
        mat_ty = torch.where(tri_wins, tk(tr.mat_ty), mat_ty)
        albedo = V3.where(tri_wins, V3(tk(tr.albedo.x), tk(tr.albedo.y),
                                       tk(tr.albedo.z)), albedo)
        fuzz = torch.where(tri_wins, tk(tr.fuzz), fuzz)
        ior = torch.where(tri_wins, tk(tr.ior), ior)
        idx = torch.where(tri_wins, it, is_)
        if textured:
            tex_ty = torch.where(tri_wins, tk(tr.tex_ty), tex_ty)
            albedo2 = V3.where(tri_wins, V3(tk(tr.albedo2.x), tk(tr.albedo2.y),
                                            tk(tr.albedo2.z)), albedo2)
            tex_scale = torch.where(tri_wins, tk(tr.tex_scale), tex_scale)
    front = normal.dot(d) <= 0.0  # shader.wgsl:303
    normal = V3.where(front, normal, -normal)
    return Hit(
        t=t_best,
        idx=idx,
        mask=mask,
        point=point,
        normal=normal,
        front_face=front,
        mat_ty=mat_ty,
        albedo=albedo,
        fuzz=fuzz,
        ior=ior,
        tex_ty=tex_ty,
        albedo2=albedo2,
        tex_scale=tex_scale,
    )
