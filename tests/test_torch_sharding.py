"""Multi-device rendering in the port (``parallel/sharding.py``) against its
own unsharded render and against the JAX package's sharded renderers.

The port's meshes here are 8 x ``cpu`` entries on the plain integrator (a
device may repeat: each entry is a shard rendered in turn); the JAX side
runs jitted on the 8 virtual CPU devices of ``tests/conftest.py``.

* Tile sharding is bitwise the port's unsharded render (K frames in one
  call included), with equal segment counts: no row past the image is
  traced. The JAX package traces ``ceil(H/8)*8`` rows and crops them, so
  its count is larger (recorded below; ROADMAP §3).
* Sample and hybrid sums differ from the unsharded render by f32
  reduction order: rtol 1e-5, atol 1e-6 (tests/test_sharding.py).
* Against JAX every mode meets ``test_torch_trace.assert_render_close``,
  the bar the port's unsharded render meets against jitted JAX (XLA
  contracts multiply-adds into FMAs; ROADMAP §3).
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import jax
import numpy as np
import pytest
import torch

from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu.parallel import sharding as jsh
from myraytracer_tpu.render.integrator import make_renderer as make_jnp
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu.scene.compile import compile_scene as jcompile
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.parallel import sharding as sh
from myraytracer_tpu_torch.render import dispatch, integrator
from myraytracer_tpu_torch.scene import presets as tpresets
from myraytracer_tpu_torch.scene.compile import compile_scene as tcompile
from test_torch_trace import assert_render_close

W, H, SPP, DEPTH = 16, 12, 4, 4  # 8 stripes of 2 rows: the last two are empty
CPU8 = ["cpu"] * 8
MAKERS = {"tiles": sh.make_tile_sharded_renderer, "samples": sh.make_sample_sharded_renderer,
          "hybrid": sh.make_hybrid_sharded_renderer}
JMAKERS = {"tiles": jsh.make_tile_sharded_renderer, "samples": jsh.make_sample_sharded_renderer,
           "hybrid": jsh.make_hybrid_sharded_renderer}


def mesh_of(mode, devices=CPU8):
    if mode == "hybrid":
        return sh.hybrid_mesh(devices)
    return sh.default_mesh(devices, axis=mode)


def port_render(mode, spp=SPP, frames=1, name="reference", **kw):
    world = tpresets.get_scene(name)
    if mode == "none":
        r = integrator.make_renderer(world.camera, W, H, spp, DEPTH, frames=frames,
                                     sky=world.ambient, **kw)
    else:
        r = MAKERS[mode](world.camera, W, H, spp, DEPTH, mesh=mesh_of(mode), frames=frames,
                         block_factory="torch", sky=world.ambient, **kw)
    img, segs = r(tcompile(world), trng.key_from_seed(0), 0)
    return img.numpy(), float(segs)


def jax_render(mode, spp=SPP):
    world = jpresets.get_scene("reference")
    if mode == "none":
        r = make_jnp(world.camera, W, H, spp, DEPTH, sample_batch=spp)
    else:
        r = JMAKERS[mode](world.camera, W, H, spp, DEPTH, sample_batch=spp)
    img, segs = r(jcompile(world), jrng.key_from_seed(0), 0)
    return np.asarray(img), float(segs)


@pytest.mark.parametrize("frames", [1, 2])
def test_tile_sharded_is_the_unsharded_render_bitwise(frames):
    got, segs = port_render("tiles", frames=frames)
    want, want_segs = port_render("none", frames=frames)
    assert got.shape == ((H, W, 3) if frames == 1 else (frames, 3, H, W))
    np.testing.assert_array_equal(got, want)
    assert segs == want_segs


@pytest.mark.parametrize("mode", ["samples", "hybrid"])
@pytest.mark.parametrize("spp", [SPP, 5])
def test_sample_and_hybrid_within_reduction_order(mode, spp):
    """spp 5 over 8 sample windows (or 2 of the hybrid mesh): the windows
    past the fifth sample are empty and skipped."""
    got, segs = port_render(mode, spp=spp)
    want, want_segs = port_render("none", spp=spp)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert segs == want_segs


def test_tile_segments_trace_no_padded_rows():
    """The divergence from JAX (ROADMAP §3): JAX's tile-sharded count
    includes the 4 padded rows its 8 stripes of ceil(12/8) = 2 rows trace
    past the image; the port's equals the unsharded count."""
    _, port_tiles = port_render("tiles")
    _, port_none = port_render("none")
    _, jax_tiles = jax_render("tiles")
    _, jax_none = jax_render("none")
    assert port_tiles == port_none
    assert jax_tiles > jax_none


@pytest.mark.parametrize("mode", ["tiles", "samples", "hybrid"])
def test_every_mode_matches_jax_sharded(mode):
    """The port's sharded render against JAX's on its 8 CPU devices. The
    tile mode's segments are held to JAX's unsharded count (JAX's own
    includes padded rows, test above)."""
    got, segs = port_render(mode)
    want, want_segs = jax_render(mode)
    if mode == "tiles":
        _, want_segs = jax_render("none")
    assert_render_close(got, want, segs, want_segs)


def test_sharded_light_scene_is_the_unsharded_render():
    """An emissive scene with a constant background: the sky reaches every
    stripe's block."""
    got, _ = port_render("tiles", name="light")
    want, _ = port_render("none", name="light")
    assert got.max() > 0.5
    np.testing.assert_array_equal(got, want)


def test_mesh_shapes_match_jax():
    devs = jax.devices()
    assert len(devs) == 8
    for kw in ({}, {"samples": 4}, {"samples": 1}):
        assert sh.hybrid_mesh(CPU8, **kw).shape == jsh.hybrid_mesh(**kw).shape
    assert sh.hybrid_mesh(CPU8[:3]).shape == jsh.hybrid_mesh(devs[:3]).shape == {
        "tiles": 3, "samples": 1}
    for n, samples in ((8, 3), (8, 0)):
        with pytest.raises(ValueError):
            jsh.hybrid_mesh(devs[:n], samples=samples)
        with pytest.raises(ValueError):
            sh.hybrid_mesh(CPU8[:n], samples=samples)
    assert sh.default_mesh(CPU8).shape == jsh.default_mesh().shape == {"tiles": 8}
    assert sh.default_mesh(CPU8, axis="samples").shape == {"samples": 8}
    # The default device lists: the CPU for torch; every card for cuda.
    assert list(sh.default_mesh(device_type="cpu").devices) == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            sh.default_mesh(device_type="cuda")
    m = sh.hybrid_mesh(CPU8)
    assert m.local == tuple(range(8)) and m.proc is None and m.owner(7) == 0


@pytest.mark.parametrize("spec", ["", "10.0.0.1:8476", "10.0.0.1:8476,16,3", "a,b",
                                  "h:1,2", "h:1,x,0"])
def test_parse_multihost_spec_matches_jax(spec):
    try:
        want = jsh.parse_multihost_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            sh.parse_multihost_spec(spec)
        return
    assert sh.parse_multihost_spec(spec) == want


def test_process_group_arguments_and_local_layout():
    env = {}
    assert sh.process_group_args({}, env) == {"init_method": "env://"}
    spec = sh.parse_multihost_spec("127.0.0.1:5000,2,1")
    assert sh.process_group_args(spec, env) == {
        "init_method": "tcp://127.0.0.1:5000", "world_size": 2, "rank": 1}
    assert sh.process_group_args(sh.parse_multihost_spec("h:1"), {"WORLD_SIZE": "4", "RANK": "3"}
                                 ) == {"init_method": "tcp://h:1", "world_size": 4, "rank": 3}
    # Every rank on this host for a loopback coordinator; torchrun's
    # variables win; one rank a host otherwise.
    assert sh.local_layout(spec, env) == (1, 2)
    assert sh.local_layout(sh.parse_multihost_spec("localhost:5000,4,3"), env) == (3, 4)
    assert sh.local_layout(sh.parse_multihost_spec("10.0.0.1:5000,16,3"), env) == (0, 1)
    assert sh.local_layout(spec, {"LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "4"}) == (2, 4)
    assert sh.local_layout({}, {"MASTER_ADDR": "127.0.0.1", "RANK": "1", "WORLD_SIZE": "2"}
                           ) == (1, 2)
    assert sh.local_layout({}, {"MASTER_ADDR": "10.0.0.1", "RANK": "1", "WORLD_SIZE": "2"}
                           ) == (0, 1)


@pytest.mark.parametrize("device_type, ranks, cards, want", [
    ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"), ("cuda", 2, 4, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cuda", 8, 4, "gloo"), ("cpu", 1, 0, "gloo"),
    ("cpu", 2, 8, "gloo"),
])
def test_collective_backend_rule(device_type, ranks, cards, want):
    """NCCL only when every rank on the host has a card of its own (it
    refuses two ranks on one card); gloo for shared cards and the CPU."""
    assert sh.collective_backend(device_type, ranks, cards) == want


def test_sample_and_hybrid_refuse_frames():
    world = tpresets.get_scene("reference")
    for mode in ("samples", "hybrid"):
        with pytest.raises(ValueError, match="tiles"):
            MAKERS[mode](world.camera, W, H, SPP, DEPTH, mesh=mesh_of(mode), frames=2,
                         block_factory="torch")
        with pytest.raises(ValueError, match="frame_batch > 1 requires shard"):
            dispatch.make_session(world, RenderConfig(
                width=W, height=H, samples_per_frame=SPP, ray_depth=DEPTH, backend="torch",
                shard=mode, frame_batch=2))
    with pytest.raises(ValueError, match="unknown shard mode"):
        sh.shard_renderer_factory(None, "rows")
    with pytest.raises(ValueError, match="shard"):
        dispatch.renderer_factory("cpu", tpresets.get_scene("final"), RenderConfig(
            width=W, height=H, backend="cpu", shard="tiles"))


@pytest.fixture
def eight_stripes(monkeypatch):
    """The sessions' default mesh as 8 CPU entries (the CLI's is one CPU)."""
    orig = sh.default_mesh
    monkeypatch.setattr(sh, "default_mesh",
                        lambda devices=None, axis="tiles", device_type=None: orig(CPU8, axis))


@pytest.mark.parametrize("mode", ["tiles", "samples"])
def test_sharded_session_checkpoint_resume_bitwise(eight_stripes, tmp_path, mode):
    """A sharded session resumed from a checkpoint continues bitwise; tile
    sharding is bitwise the unsharded session at K = 2 frames a step."""
    world = tpresets.get_scene("three-sphere")
    cfg = RenderConfig(width=W, height=H, samples_per_frame=2, ray_depth=DEPTH,
                       backend="torch", shard=mode,
                       frame_batch=2 if mode == "tiles" else 1)
    a = dispatch.make_session(world, cfg)
    assert a.ndev == 8
    a.run(6)
    b = dispatch.make_session(world, cfg)
    b.run(2)
    path = tmp_path / "s.npz"
    b.save_checkpoint(path)
    c = dispatch.make_session(world, cfg)
    c.load_checkpoint(path)
    c.run(4)
    assert torch.equal(a.framebuffer, c.framebuffer)
    assert (a.frame_count, a.sample_cursor, a.segments_traced) == (
        c.frame_count, c.sample_cursor, c.segments_traced)
    if mode == "tiles":
        u = dispatch.make_session(world, cfg.replace(shard="none"))
        u.run(6)
        assert torch.equal(a.framebuffer, u.framebuffer)
        assert a.segments_traced == u.segments_traced
        with pytest.raises(ValueError, match="shard"):
            u.load_checkpoint(path)


def test_fetch_array_gathers_rows_through_gloo():
    """The multi-process gather on a one-rank gloo group: each entry's rows
    come back in place; numpy and whole tensors pass through."""
    import socket

    import torch.distributed as dist

    x = torch.arange(12 * 3, dtype=torch.float32).reshape(12, 3)
    assert sh.fetch_array(x.numpy()) is not None
    np.testing.assert_array_equal(sh.fetch_array(x), x.numpy())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        proc = sh.Process(0, 1, "gloo", torch.device("cpu"))
        mesh = sh.Mesh(CPU8, ("tiles",), proc=proc)
        rows = sh.Rows(mesh, sh.row_bounds(12, 8))
        np.testing.assert_array_equal(sh.fetch_array(x, rows), x.numpy())
        got = sh.all_reduce_sum(torch.tensor(2.5, dtype=torch.float64), mesh)
        assert float(got) == 2.5
        assert sh.total_segments([torch.tensor(1.0, dtype=torch.float64)] * 3, mesh) == 3.0
    finally:
        dist.destroy_process_group()


def test_row_bounds_and_sample_windows():
    assert sh.row_bounds(12, 8) == ((0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12),
                                    (12, 12), (12, 12))
    assert sh.row_bounds(800, 4) == ((0, 200), (200, 400), (400, 600), (600, 800))
    assert sh.sample_windows(5, 8) == ((0, 1), (1, 1), (2, 1), (3, 1), (4, 1), (5, 0),
                                       (6, 0), (7, 0))
    assert sh.sample_windows(5, 2) == ((0, 3), (3, 2))
