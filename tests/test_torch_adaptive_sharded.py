"""Adaptive sampling over tile stripes in the port (``render/adaptive.py``
with ``shard="tiles"``) against its unsharded session and the JAX
package's sharded session (tests/test_adaptive_sharded.py's cases).

The port's meshes are ``cpu`` entries on the plain oracle; the JAX side
runs on the virtual CPU devices of ``tests/conftest.py``.

* The stripe geometry (``local_nb``, ``n_sel_local``, ``n_sel``,
  ``sel_real``) is JAX's, dead padding ids included.
* A sharded bootstrap, and a forced schedule after it, are bitwise the
  unsharded session: a block renders the same wherever it is owned.
* An auto round stays inside each stripe and takes the stripe's top score;
  from the same state as a JAX sharded session it picks the same blocks.
* Checkpoints resume exactly and refuse another mesh.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import jax
import numpy as np
import pytest
import torch

from myraytracer_tpu.config import RenderConfig as JConfig
from myraytracer_tpu.parallel import sharding as jsh
from myraytracer_tpu.render import adaptive as jadaptive
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.parallel import sharding as sh
from myraytracer_tpu_torch.render import adaptive
from myraytracer_tpu_torch.render.adaptive import AdaptiveSession
from myraytracer_tpu_torch.scene import presets

W, H, SPP, DEPTH = 256, 128, 2, 4  # a 4x4 grid of 64x32 blocks


def _cfg(**kw):
    base = dict(width=W, height=H, samples_per_frame=SPP, ray_depth=DEPTH, backend="torch",
                seed=5, frame_batch=1)
    base.update(kw)
    return RenderConfig(**base)


def cpu_mesh(n):
    return sh.default_mesh(["cpu"] * n)


def sharded(world, n=8, n_sel=8, **kw):
    return AdaptiveSession(world, _cfg(shard="tiles", **kw), n_sel=n_sel, mesh=cpu_mesh(n))


@pytest.fixture(scope="module")
def world():
    return presets.three_sphere_scene()


@pytest.fixture(scope="module")
def pair(world):
    """(unsharded, sharded over 8 stripes) sessions after the same bootstrap."""
    a = AdaptiveSession(world, _cfg(), n_sel=8)
    b = sharded(world)
    a.bootstrap()
    b.bootstrap()
    return a, b


@pytest.mark.parametrize("w, h, n_sel, ndev", [
    (256, 128, 8, 8), (160, 96, 0, 8), (200, 100, 5, 4), (256, 128, 3, 2), (64, 32, 0, 8),
])
def test_stripe_geometry_matches_jax(w, h, n_sel, ndev):
    jcfg = JConfig(width=w, height=h, samples_per_frame=SPP, ray_depth=DEPTH, backend="jnp",
                   shard="tiles", frame_batch=1)
    j = jadaptive.AdaptiveSession(jpresets.three_sphere_scene(), jcfg, n_sel=n_sel,
                                  mesh=jsh.default_mesh(jax.devices()[:ndev]))
    t = AdaptiveSession(presets.three_sphere_scene(), _cfg(width=w, height=h, shard="tiles"),
                        n_sel=n_sel, mesh=cpu_mesh(ndev))
    fields = ("ndev", "n_blocks", "local_nb", "n_sel_local", "n_sel", "sel_real")
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    assert [tuple(a.shape) for a in (t._stacked(i) for i in range(6))] == [
        tuple(a.shape) for a in j._state]


def test_sharded_bootstrap_is_the_unsharded_one_bitwise(pair):
    a, b = pair
    assert (b.ndev, b.local_nb, b.n_sel_local, b.n_sel, b.sel_real) == (8, 2, 1, 8, 8)
    assert torch.equal(a.framebuffer, b.framebuffer)
    np.testing.assert_array_equal(a.spp_map, b.spp_map)
    assert a.samples_spent == b.samples_spent
    assert a.segments_traced == b.segments_traced


def test_dead_stripes_bootstrap_bitwise(world):
    """160x96 is a 3x3 grid: over 8 stripes of 2 ids, stripe 4 holds one
    real block and stripes 5-7 only dead ids (scheduled as the sentinel)."""
    a = AdaptiveSession(world, _cfg(width=160, height=96), n_sel=2)
    b = sharded(world, width=160, height=96, n_sel=2)
    a.bootstrap()
    b.bootstrap()
    assert b.sel_real == 5
    assert torch.equal(a.framebuffer, b.framebuffer)
    np.testing.assert_array_equal(a.spp_map, b.spp_map)
    assert a.segments_traced == b.segments_traced
    r_b = b._stacked(4)[:, : b.local_nb]
    assert (r_b[5:] == 0).all() and (r_b.reshape(-1)[: b.n_blocks] >= 2).all()


def test_forced_schedule_bitwise(world):
    """Blocks 1 and 9 rendered one more round: by their owning stripes (0
    owns {0, 1}, 4 owns {8, 9}) and by the unsharded session, bitwise."""
    a = AdaptiveSession(world, _cfg(), n_sel=2)
    b = sharded(world)
    a.bootstrap()
    b.bootstrap()
    a.round_ids(torch.tensor([1, 9]))
    ids = torch.full((b.ndev, b.n_sel_local), b.sentinel)
    ids[0, 0], ids[4, 0] = 1, 9
    b.round_ids(ids)
    assert torch.equal(a.framebuffer, b.framebuffer)
    nb_a = a._state[3][: a.n_blocks]
    nb_b = b._stacked(3)[:, : b.local_nb].reshape(-1)[: b.n_blocks]
    assert torch.equal(nb_a, nb_b)
    assert nb_a[1] == nb_a[9] == 3 * SPP and nb_a[0] == 2 * SPP


def test_auto_round_respects_stripe_ownership(world):
    b = sharded(world)
    b.bootstrap()
    r_before = b._stacked(4)[:, : b.local_nb].clone()
    spent = b.samples_spent
    b.step()
    gained = b._stacked(4)[:, : b.local_nb] - r_before
    assert torch.equal(gained.sum(dim=1), torch.full((b.ndev,), b.n_sel_local))
    assert (gained >= 0).all()
    assert b.samples_spent - spent == b.sel_real * b.block_h * b.block_w * SPP * b.windows
    assert b.round_cost() == b.sel_real * b.block_h * b.block_w * SPP * b.windows


def test_sharded_selects_stripe_top_score(world):
    """In every stripe the block that gained a round is its top scorer
    (recomputed in float64; skipped where the top two are within noise)."""
    b = sharded(world)
    b.bootstrap()
    s1, s2, r_b = (b._stacked(i).double().numpy() for i in (1, 2, 4))
    r_before = b._stacked(4)[:, : b.local_nb].clone()
    b.step()
    gained = (b._stacked(4)[:, : b.local_nb] - r_before).numpy()
    checked = 0
    for d in range(b.ndev):
        r = r_b[d, : b.local_nb, None, None]
        var = np.maximum((s2[d, : b.local_nb] - s1[d, : b.local_nb] ** 2 / r)
                         / np.maximum(r - 1.0, 1.0), 0.0)
        score = var.mean(axis=(1, 2)) / (r[:, 0, 0] * (r[:, 0, 0] + 1.0))
        order = np.argsort(-score, kind="stable")
        if not np.isclose(score[order[0]], score[order[1]], rtol=1e-4, atol=1e-12):
            assert gained[d, order[0]] == 1, (d, score, gained[d])
            checked += 1
    assert checked > 0


def test_state_from_a_jax_sharded_session_selects_the_same_blocks(world):
    """A JAX session on 4 devices bootstraps; its [4, ...] state carried
    into the port's 4-stripe session, one auto round each picks the same
    blocks (equal spp maps and cursors), with framebuffers within the
    port's small-shape tolerance."""
    jcfg = JConfig(width=W, height=H, samples_per_frame=SPP, ray_depth=DEPTH, backend="jnp",
                   shard="tiles", frame_batch=1, seed=5)
    j = jadaptive.AdaptiveSession(jpresets.three_sphere_scene(), jcfg, n_sel=8,
                                  mesh=jsh.default_mesh(jax.devices()[:4]))
    j.bootstrap()
    t = sharded(world, n=4)
    assert (t.local_nb, t.n_sel_local) == (4, 2)
    arrays = [np.asarray(a) for a in j._state]
    t._state = [adaptive.state_from_numpy([a[d] for a in arrays]) for d in range(4)]
    t._bootstrapped = True
    j.step()
    t.step()
    np.testing.assert_array_equal(t.spp_map, j.spp_map)
    np.testing.assert_array_equal(t._stacked(5).numpy(), np.asarray(j._state[5]))
    np.testing.assert_allclose(t.framebuffer.numpy(), np.asarray(j.framebuffer),
                               rtol=1e-4, atol=1e-5)


def test_sharded_checkpoint_resume_exact(world, tmp_path):
    a = sharded(world)
    a.bootstrap()
    for _ in range(3):
        a.step()
    b = sharded(world)
    b.bootstrap()
    b.step()
    path = tmp_path / "s.npz"
    b.save_checkpoint(path)
    with np.load(path) as z:  # the JAX sharded layout: [ndev, local_nb + 1, ...]
        assert z["state0"].shape == (8, 3, b.block_h, b.block_w, 3)
        assert z["state5"].shape == (8, 3) and z["state5"].dtype == np.uint32
    c = sharded(world)
    c.load_checkpoint(path)
    assert c.bootstrapped
    for _ in range(2):
        c.step()
    for i in range(6):
        assert torch.equal(a._stacked(i), c._stacked(i))
    assert torch.equal(a.framebuffer, c.framebuffer)
    assert a.segments_traced == c.segments_traced


def test_sharded_checkpoint_refuses_another_mesh(world, tmp_path):
    a = sharded(world)
    a.bootstrap()
    path = tmp_path / "s.npz"
    a.save_checkpoint(path)
    with pytest.raises(ValueError, match="ndev"):
        sharded(world, n=4).load_checkpoint(path)
    with pytest.raises(ValueError, match="shard"):
        AdaptiveSession(world, _cfg(), n_sel=8).load_checkpoint(path)


def test_refuses_sample_and_hybrid_shards(world):
    for mode in ("samples", "hybrid"):
        with pytest.raises(ValueError, match="tiles"):
            AdaptiveSession(world, _cfg(shard=mode))
