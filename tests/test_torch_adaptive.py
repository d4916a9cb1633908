"""Adaptive sampling in the PyTorch port against the JAX package.

The statistics (``_update_stats``, ``_block_scores``) and the selection are
held bitwise to JAX's on the same numpy inputs: they reproduce the
arithmetic XLA's CPU backend compiles (fused multiply-adds, its reduction
order) and ``lax.top_k``'s tie order. Rendered sums agree with the JAX
oracle at the port's small-shape tolerance (tests/test_torch_trace.py:
rtol 1e-4, atol 1e-5, segments within 1%), and whole sessions follow the
same schedule. On the card the CUDA adaptive kernel is held to the plain
version here (tests/test_torch_gpu.py, chip_smoke.py).
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.config import RenderConfig as JConfig
from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu.kernels import trace as jtrace
from myraytracer_tpu.render import adaptive as jadaptive
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu.scene.compile import compile_scene as jcompile
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.kernels import trace as ktrace
from myraytracer_tpu_torch.render import adaptive
from myraytracer_tpu_torch.render.session import RenderSession
from myraytracer_tpu_torch.scene import presets as tpresets
from myraytracer_tpu_torch.scene.compile import compile_scene as tcompile

BW, BH = adaptive.BLOCK_W, adaptive.BLOCK_H
KW = dict(width=128, height=64, samples_per_frame=2, ray_depth=4, seed=3)


def assert_close(got, want):
    """The port's small-shape tolerance, on every pixel."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def jax_session(name, n_sel, **kw):
    cfg = JConfig(**{**KW, "backend": "jnp", **kw})
    return jadaptive.AdaptiveSession(jpresets.get_scene(name), cfg, n_sel=n_sel)


def port_session(name, n_sel, **kw):
    cfg = RenderConfig(**{**KW, "backend": "torch", **kw})
    return adaptive.AdaptiveSession(tpresets.get_scene(name), cfg, n_sel=n_sel)


def test_block_geometry_matches_jax():
    assert BW == jtrace.DEFAULT_CONFIG.BLOCK_W
    assert BH == jtrace.DEFAULT_TILE_ROWS * jtrace.LANES // jtrace.DEFAULT_CONFIG.BLOCK_W
    assert (ktrace.BLOCK_W, ktrace.BLOCK_H) == (BW, BH)
    for w, h in ((1200, 800), (160, 96), (100, 24), (64, 32), (1, 1)):
        assert adaptive.block_geometry(w, h, BW, BH) == jadaptive.block_geometry(w, h, BW, BH)
    j, t = jax_session("reference", 0, width=200, height=100), port_session(
        "reference", 0, width=200, height=100)
    assert (t.blocks_x, t.blocks_y, t.n_blocks, t.n_sel, t.block_w, t.block_h) == (
        j.blocks_x, j.blocks_y, j.n_blocks, j.n_sel, j.block_w, j.block_h)


def _random_state(seed, nb1=9, n_sel=4):
    rs = np.random.RandomState(seed)
    state = (
        rs.random_sample((nb1, BH, BW, 3)).astype(np.float32),
        (rs.random_sample((nb1, BH, BW)) * 3).astype(np.float32),
        (rs.random_sample((nb1, BH, BW)) * 5).astype(np.float32),
        rs.randint(0, 50, nb1).astype(np.int32),
        rs.randint(0, 6, nb1).astype(np.int32),
        rs.randint(0, 1000, nb1).astype(np.uint32),
    )
    sums = (rs.random_sample((n_sel, BH, BW, 3)) * 4).astype(np.float32)
    return state, sums


@pytest.mark.parametrize("seed,idx,k", [
    (0, [3, 0, 8, 8], 3),  # repeated sentinels (row 8 = the spare row)
    (1, [8, 5, 1, 7], 2),  # one sentinel
    (2, [6, 2, 4, 0], 8),  # none
])
def test_update_stats_bitwise_equal_to_jax(seed, idx, k):
    state, sums = _random_state(seed)
    idx = np.asarray(idx, np.int32)
    sums[idx == 8] = 0.0  # sentinel blocks render zeros
    want = jadaptive._update_stats(*state, idx, sums, np.int32(k))
    got = adaptive._update_stats(
        *adaptive.state_from_numpy(state), torch.from_numpy(idx.astype(np.int64)),
        torch.from_numpy(sums), k,
    )
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().astype(w.dtype), w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_scores_bitwise_equal_to_jax(seed):
    (_, s1, s2, _, r_b, _), _ = _random_state(seed)
    s1[2], s2[2] = 1.5, 1.5 * 1.5  # a constant block: zero variance
    want = np.asarray(jadaptive._block_scores(s1, s2, r_b))
    got = adaptive._block_scores(torch.from_numpy(s1), torch.from_numpy(s2),
                                 torch.from_numpy(r_b))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scores", [
    [np.inf] * 7,  # bootstrap: all tied at +inf
    [0.0, 2.0, 0.0, 2.0, np.inf, 0.0, np.inf],  # ties at inf, 2 and 0 (constant sky)
    list(np.random.RandomState(0).random_sample(7)),
])
@pytest.mark.parametrize("n_sel", [1, 3, 7])
def test_selection_is_lax_top_k(scores, n_sel):
    s = np.asarray(scores, np.float32)
    _, want = jax.lax.top_k(jnp.asarray(s), n_sel)
    got = adaptive.select_blocks(torch.from_numpy(s), n_sel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("windows", [1, 3])
def test_oracle_matches_jax_oracle(windows):
    """A ragged 2x2 grid (100x40), a sentinel among the ids, distinct
    cursors."""
    w, h, spp, depth = 100, 40, 2, 4
    jworld = jpresets.three_sphere_scene()
    bx, by, nb = jadaptive.block_geometry(w, h, BW, BH)
    assert (bx, by) == (2, 2)
    ids = np.asarray([3, nb, 0, 2], np.uint32)
    samp0 = np.asarray([4, 0, 0, 9], np.uint32)
    jr = jax.jit(jadaptive.make_adaptive_oracle(
        jworld.camera, w, h, 4, spp, depth, block_w=BW, block_h=BH, windows=windows))
    want, wsegs = jr(jcompile(jworld), jrng.key_from_seed(0), ids, samp0)
    world = tpresets.three_sphere_scene()
    tr = adaptive.make_adaptive_oracle(world.camera, w, h, 4, spp, depth, windows=windows)
    got, segs = tr(tcompile(world), trng.key_from_seed(0), torch.from_numpy(ids.astype(np.int64)),
                   torch.from_numpy(samp0.astype(np.int64)))
    assert got.shape == np.asarray(want).shape
    assert_close(got, want)
    assert abs(float(segs) - float(wsegs)) <= 0.01 * float(wsegs)
    sentinel = got[:, 1] if windows > 1 else got[1]
    assert not sentinel.any()


@pytest.mark.parametrize("name", ["reference", "defocus"])
def test_adaptive_block_is_the_uniform_render_of_its_pixels(name):
    """Scheduling independence (tests/test_adaptive.py:77): the sums of a
    block at cursor s0 are bitwise the uniform plain block's sums of its
    pixels over [s0, s0+spp); pixels past the edge hold zeros."""
    w, h, spp, depth, s0 = 100, 40, 3, 4, 5
    world = tpresets.get_scene(name)
    scene = tcompile(world)
    cam = scene.cam
    if not world.camera.reference_mode:
        from myraytracer_tpu_torch.render.camera import pack_camera

        cam = torch.from_numpy(pack_camera(world.camera, w, h))
    key = trng.key_from_seed(2)
    bx, by, nb = adaptive.block_geometry(w, h, BW, BH)
    sums, segs = ktrace.trace_adaptive(scene, cam, key, w, h, torch.arange(nb),
                                       torch.full((nb,), s0), spp, 1, depth, 1e-3, 1e4)
    img, useg = ktrace.trace_spheres(scene, cam, key, w, h, 0, h, s0, spp, depth, 1e-3, 1e4)
    full = sums[0].view(by, bx, BH, BW, 3).permute(0, 2, 1, 3, 4).reshape(by * BH, bx * BW, 3)
    fsegs = segs.view(by, bx, BH, BW).permute(0, 2, 1, 3).reshape(by * BH, bx * BW)
    assert torch.equal(full[:h, :w], img) and torch.equal(fsegs[:h, :w], useg)
    assert not full[h:].any() and not full[:, w:].any() and not fsegs[h:].any()


def test_windowed_rounds_equal_single_rounds():
    """F windows per call fold exactly as F separate rounds
    (tests/test_adaptive.py:166)."""
    a = port_session("three-sphere", 2, seed=5, frame_batch=3)
    b = port_session("three-sphere", 2, seed=5)
    assert (a.windows, b.windows) == (3, 1)
    a.bootstrap(covers=3)
    b.bootstrap(covers=3)
    for sa, sb in zip(a._state, b._state):
        assert torch.equal(sa, sb)
    assert (a.rounds, a.samples_spent) == (b.rounds, b.samples_spent)


def test_state_carried_across_from_jax():
    """Bootstrap a JAX session, carry its state over, run one auto round in
    each: the same blocks are chosen and the framebuffers agree."""
    j = jax_session("three-sphere", 2)
    j.bootstrap()
    t = port_session("three-sphere", 2)
    t._state = adaptive.state_from_numpy([np.asarray(a) for a in j._state])
    t._bootstrapped = True
    _, s1, s2, _, r_b, _ = j._state
    _, want = jax.lax.top_k(jadaptive._block_scores(s1, s2, r_b)[: j.n_blocks], j.n_sel)
    _, ts1, ts2, _, tr_b, _ = t._state
    got = adaptive.select_blocks(adaptive._block_scores(ts1, ts2, tr_b)[: t.n_blocks], t.n_sel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    j.step()
    t.step()
    np.testing.assert_array_equal(t.spp_map, j.spp_map)
    assert_close(t.framebuffer, j.framebuffer)


def test_session_matches_jax_session():
    """n_sel 2 of 4 blocks: the same schedule, equal spp maps and segment
    totals, framebuffers within tolerance."""
    j, t = jax_session("three-sphere", 2), port_session("three-sphere", 2)
    for _ in range(4):  # the bootstrap, then three auto rounds
        j.step()
        t.step()
        np.testing.assert_array_equal(t.spp_map, j.spp_map)
    assert (t.rounds, t.samples_spent) == (j.rounds, j.samples_spent)
    np.testing.assert_array_equal(t._state[5].numpy(), np.asarray(j._state[5]))
    assert_close(t.framebuffer, j.framebuffer)
    assert abs(t.segments_traced - j.segments_traced) <= 0.01 * j.segments_traced


def test_checkpoint_resume_is_exact(tmp_path):
    a = port_session("three-sphere", 2, seed=5)
    a.bootstrap()
    for _ in range(3):
        a.step()
    b = port_session("three-sphere", 2, seed=5)
    b.bootstrap()
    b.step()
    path = tmp_path / "a.npz"
    b.save_checkpoint(path)
    c = port_session("three-sphere", 2, seed=5)
    c.load_checkpoint(path)
    assert c.bootstrapped
    assert (c.rounds, c.sub_rounds, c.samples_spent) == (b.rounds, b.sub_rounds, b.samples_spent)
    for _ in range(2):
        c.step()
    for sa, sc in zip(a._state, c._state):
        assert torch.equal(sa, sc)
    assert torch.equal(a.framebuffer, c.framebuffer)
    assert a.segments_traced == c.segments_traced
    with np.load(path) as z:  # the JAX package's state layout
        assert z["state5"].dtype == np.uint32 and z["state0"].shape == (5, BH, BW, 3)


def test_checkpoint_provenance(tmp_path):
    s = port_session("three-sphere", 2)
    s.bootstrap()
    path = tmp_path / "a.npz"
    s.save_checkpoint(path)
    for other, key in (
        (port_session("three-sphere", 1), "n_sel"),
        (port_session("three-sphere", 2, frame_batch=2), "windows"),
        (port_session("reference", 2), "scene"),
        (port_session("three-sphere", 2, seed=4), "seed"),
    ):
        with pytest.raises(ValueError, match=key):
            other.load_checkpoint(path)
    with np.load(path) as z:
        arrays = dict(z)
    arrays["meta"] = str(arrays["meta"]).replace('"backend": "torch"', '"backend": "cuda"')
    np.savez(tmp_path / "cuda.npz", **arrays)
    with pytest.raises(ValueError, match="backend"):
        port_session("three-sphere", 2).load_checkpoint(tmp_path / "cuda.npz")

    # A uniform session refuses the adaptive npz and points at the adaptive
    # session; the adaptive session refuses a uniform npz.
    world = tpresets.three_sphere_scene()
    cfg = RenderConfig(backend="torch", **KW)
    with pytest.raises(ValueError, match="AdaptiveSession.load_checkpoint"):
        RenderSession(world, cfg).load_checkpoint(path)
    u = RenderSession(world, cfg)
    u.step()
    u.save_checkpoint(tmp_path / "u.npz")
    with pytest.raises(ValueError, match="adaptive"):
        s.load_checkpoint(tmp_path / "u.npz")


def test_cursor_headroom_counts_rounds_before_set_camera(tmp_path):
    """The JAX session's ``set_camera`` resets ``rounds``, against which it
    checks the cursor headroom, while the per-block cursors keep advancing
    (myraytracer_tpu/render/adaptive.py:544). The port bounds the cursors
    by the sub-rounds since construction, which ``set_camera`` keeps."""
    s = port_session("defocus", 1, width=64, height=32)
    s.bootstrap()
    s.step()
    before = s.sub_rounds
    cursor_max = int(s._state[5].max())
    s.set_camera(tpresets.final_scene().camera)
    assert s.rounds == 0 and s.sub_rounds == before
    k = s.config.samples_per_frame
    # JAX's bound after the move, rounds * k = 0, is below the cursors;
    # the port's bound is not.
    assert s.rounds * k < cursor_max <= s.sub_rounds * k
    s.save_checkpoint(tmp_path / "c.npz")
    r = port_session("defocus", 1, width=64, height=32)
    r.load_checkpoint(tmp_path / "c.npz")
    assert r.sub_rounds == before
    # At the edge of the draw-index space the guard refuses the next round
    # even though ``rounds`` was reset.
    s.sub_rounds = trng.M32 // trng.DRAWS_PER_SAMPLE // k
    with pytest.raises(RuntimeError, match="overflow"):
        s.step()


def test_session_backends_and_unsupported_options():
    if torch.cuda.is_available():
        assert port_session("reference", 1, backend="auto").backend_resolved == "cuda"
    else:
        for backend in ("auto", "cuda"):
            with pytest.raises(RuntimeError, match="CUDA GPU"):
                port_session("reference", 1, backend=backend)
    # Tile stripes are ported: on the default mesh (the CPU, one stripe) a
    # shard="tiles" session renders; samples and hybrid are refused.
    s = port_session("reference", 1, shard="tiles")
    s.step()
    assert s.ndev == 1 and s.bootstrapped and np.isfinite(s.framebuffer.numpy()).all()
    for mode in ("samples", "hybrid"):
        with pytest.raises(ValueError, match="tiles"):
            port_session("reference", 1, shard=mode)
    # The estimator's modes are ported: sessions build with them.
    for kw in (dict(nee=True), dict(qmc=True), dict(rr=2)):
        assert port_session("reference", 1, **kw).backend_resolved == "torch"
    # So are textures: a textured world's session renders.
    s = adaptive.AdaptiveSession(tpresets.get_scene("texture"), RenderConfig(
        backend="torch", **KW))
    s.step()
    assert torch.isfinite(s.framebuffer).all() and s.framebuffer.max() > 0
    cam = tpresets.reference_scene().camera
    assert callable(ktrace.make_adaptive_renderer(cam, 64, 32, 1, 1, trng.MAX_DEPTH + 1))
    assert callable(ktrace.make_adaptive_renderer(cam, 64, 32, 1, 1, 4, texture_set=(1, 3)))


def test_run_budget_spends_within_the_budget():
    """The bootstrap covers every block twice, then the budget skews toward
    the noisy blocks and is never overspent."""
    s = port_session("three-sphere", 1)
    fb = s.run_budget(6)
    spp = KW["samples_per_frame"]
    smap = s.spp_map
    assert fb.shape == (KW["height"], KW["width"], 3) and torch.isfinite(fb).all()
    assert smap.min() >= 2 * spp and smap.max() > smap.min()
    budget = 6 * spp * KW["width"] * KW["height"]
    assert s.samples_spent <= budget < s.samples_spent + s.round_cost()


def _run_session(s, steps=3):
    for _ in range(steps):  # the bootstrap, then auto rounds
        s.step()
    return s


def test_session_uses_a_custom_renderer_factory():
    """``renderer_factory(**kw)`` receives the keywords the port's own
    factory does, and its renderer renders every round: here the oracle
    with each call counted, bitwise the session without it."""
    calls, seen = [], []

    def factory(**kw):
        seen.append(sorted(kw))
        render = adaptive.make_adaptive_oracle(**kw)

        def counted(*args):
            calls.append(1)
            return render(*args)

        return counted

    cfg = RenderConfig(**{**KW, "backend": "torch"})
    world = tpresets.get_scene("three-sphere")
    s = _run_session(adaptive.AdaptiveSession(world, cfg, 2, factory))
    assert seen == [sorted(["cam", "width", "height", "n_sel", "max_samples", "ray_depth",
                            "windows", "t_min", "t_max", "material_set", "sky",
                            "nee_lights", "texture_set", "qmc", "rr"])]
    assert len(calls) == s.sub_rounds // s.windows > 0
    plain = _run_session(port_session("three-sphere", 2))
    assert torch.equal(s.framebuffer, plain.framebuffer)
    np.testing.assert_array_equal(s.spp_map, plain.spp_map)


def test_session_interpret_is_the_plain_torch_backend():
    """``interpret=True`` runs the kernel's plain version on the session's
    device: on the CPU bitwise the ``backend="torch"`` session, the kernel's
    gates included (final's sweep is culled), with a mesh by name."""
    world = tpresets.get_scene("final")
    cfg = RenderConfig(**{**KW, "backend": "torch", "ray_depth": 3})
    a = _run_session(adaptive.AdaptiveSession(world, cfg, 2, None, True))
    b = _run_session(adaptive.AdaptiveSession(world, cfg, n_sel=2, mesh=None))
    assert a._render.__qualname__.startswith("_adaptive_renderer")
    for sa, sb in zip(a._state, b._state):
        assert torch.equal(sa, sb)
    assert a.segments_traced == b.segments_traced
