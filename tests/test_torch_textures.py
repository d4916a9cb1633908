"""Textures in the PyTorch port: checker, marble and the image lookup.

The CUDA kernel is held bitwise to the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``). Here, on the CPU, the
plain version is held against the JAX package:

* the texture functions (``render/textures.py``) on seeded points and
  normals: checker and marble are exact integer and f32 arithmetic, bitwise
  JAX run op by op (``jax.disable_jit()``); jitted, XLA contracts the
  noise's lerps into FMAs, so marble is held to an absolute 2^-15 there.
  The sphere UV takes ``atan2`` and ``acos``, whose CPU libms differ by an
  ulp now and then; a texel index can flip at a texel edge, so the image
  lookup is held to a measured fraction of lanes bitwise (the rest must
  fetch a neighbouring texel);
* the compiled texture rows and bitmap, the kernel's texture tables (the
  JAX prefetch rows decoded) and the checkpoint fingerprint, bit for bit;
* renders of the plain integrator against the JAX jnp integrator: eagerly,
  every pixel within rtol 1e-4, atol 1e-5 and the same segment count;
  jitted, under ``test_torch_trace.assert_render_close``'s statistical bar.
  Measured on this CPU, pixels within tolerance eager at 24x16 (bit for
  bit) / jitted at 16x8, segments equal in every case: texture 1.0
  (0.984) / 0.984; earth 1.0 (0.987) / 1.0; the textured mesh, gated or
  not, 1.0 (0.979) / 1.0; textured metal 1.0 (0.987) / 1.0; the lit
  textured world with NEE 1.0 (0.964) / 1.0; the marbled field, gated,
  1.0 (0.977) / 0.953.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu.core.vec import V3 as JV3
from myraytracer_tpu.kernels.trace import KernelConfig as JKernelConfig
from myraytracer_tpu.kernels.trace import _scene_to_prefetch, _tex_ids
from myraytracer_tpu.render import lights as jlights
from myraytracer_tpu.render import textures as jtex
from myraytracer_tpu.render.integrator import make_renderer as make_jnp
from myraytracer_tpu.render.session import scene_fingerprint as jfingerprint
from myraytracer_tpu.scene import api as japi
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu.scene.compile import compile_scene as jcompile
from myraytracer_tpu_torch import cli
from myraytracer_tpu_torch.config import KernelConfig, RenderConfig
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.core.vec import V3
from myraytracer_tpu_torch.kernels import trace as ktrace
from myraytracer_tpu_torch.render import integrator, lights
from myraytracer_tpu_torch.render import textures
from myraytracer_tpu_torch.render.adaptive import AdaptiveSession
from myraytracer_tpu_torch.render.session import (
    RenderSession, scene_fingerprint, wants_spatial_sort,
)
from myraytracer_tpu_torch.scene import api as tapi
from myraytracer_tpu_torch.scene import presets as tpresets
from myraytracer_tpu_torch.scene.compile import SCENE_LEAVES, compile_scene, leaf

from test_torch_trace import assert_render_close
from textured_worlds import WORLDS

KEY = trng.key_from_seed(0)
GATED_TRIS = KernelConfig(UNROLL_MAX=0, TRI_CHUNK=4)


def worlds(name):
    """(port world, JAX world) of one entry of ``textured_worlds.WORLDS``."""
    return WORLDS[name](tapi, tpresets), WORLDS[name](japi, jpresets)


# -- the texture functions ---------------------------------------------------

N = 1 << 16


def _seeded(seed, lo=-40.0, hi=40.0):
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(lo, hi, N).astype(np.float32) for _ in range(3)]
    nrm = rng.normal(size=(3, N)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0)
    return rng, pts, list(nrm)


def _t(arrs):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs))


def _j(arrs):
    return JV3(*(jnp.asarray(a) for a in arrs))


def _np(v):
    return np.stack([np.asarray(c) for c in v])


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_checker_and_marble_match_jax(jit):
    """Bitwise JAX run op by op; jitted, the checker still bitwise and
    marble within 2^-15 (XLA fuses the noise's lerps into FMAs)."""
    rng, pts, _ = _seeded(1)
    scale = rng.uniform(0.5, 10.0, N).astype(np.float32)
    even = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(3)]
    odd = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(3)]
    s = torch.from_numpy(scale)
    got_c = _np(textures.checker_albedo(_t(even), _t(odd), s, _t(pts)))
    got_m = _np(textures.marble_albedo(_t(even), s, _t(pts)))
    ctx = contextlib.nullcontext() if jit else jax.disable_jit()
    checker = jax.jit(jtex.checker_albedo) if jit else jtex.checker_albedo
    marble = jax.jit(jtex.marble_albedo) if jit else jtex.marble_albedo
    with ctx:
        want_c = _np(checker(_j(even), _j(odd), jnp.asarray(scale), _j(pts)))
        want_m = _np(marble(_j(even), jnp.asarray(scale), _j(pts)))
    np.testing.assert_array_equal(got_c, want_c)
    assert (got_c == np.stack(odd)).any() and (got_c == np.stack(even)).any()
    if jit:
        # An ulp of turbulence moves the band argument (below 512 here) by
        # at most one of its ulps, 2^-15: the band by 2^-15 and the factor
        # by 2^-16 (measured: at most 2^-16 = 1.53e-5; 5.7% of these
        # elements are off by more than rtol 1e-5, atol 1e-6).
        np.testing.assert_allclose(got_m, want_m, rtol=0, atol=2.0 ** -15)
    else:
        np.testing.assert_array_equal(got_m, want_m)


def test_sphere_uv_and_image_albedo_match_jax_eager():
    """``u`` and ``v`` within rtol 2^-22, atol 1e-7 of JAX's (its
    ``atan2``/``acos`` and torch's CPU ones round differently: measured, u
    bitwise on 93% of lanes, v on 85%, v at most 3 ulp off, u 163 ulp where
    it is near 0); the texel is JAX's on at least 99.9% of lanes
    (measured: all 65,536), and elsewhere a texel of the map (an index
    flipped at a texel edge)."""
    rng, _, nrm = _seeded(2)
    scale = rng.uniform(0.5, 4.0, N).astype(np.float32)
    image = np.ascontiguousarray(tpresets._earth_bitmap())
    u, v = textures.sphere_uv(_t(nrm))
    got = _np(textures.image_albedo(torch.from_numpy(image), torch.from_numpy(scale), _t(nrm)))
    with jax.disable_jit():
        ju, jv = jtex.sphere_uv(_j(nrm))
        want = _np(jtex.image_albedo(jnp.asarray(image), jnp.asarray(scale), _j(nrm)))
    for a, b in ((u.numpy(), np.asarray(ju)), (v.numpy(), np.asarray(jv))):
        np.testing.assert_allclose(a, b, rtol=2 * 2.0 ** -23, atol=1e-7)
    same = (got == want).all(0)
    assert same.mean() >= 0.999, same.mean()
    texels = image.reshape(-1, 3)
    for lane in np.nonzero(~same)[0]:  # a texel of the map, near JAX's
        k = np.nonzero((texels == got[:, lane]).all(1))[0]
        assert k.size


def test_effective_albedo_matches_jax_eager():
    """The dispatch over mixed texture types on seeded lanes: bitwise JAX
    run op by op on solid, checker and marble lanes, and on image lanes
    wherever the texel index agrees (see the test above)."""
    rng, pts, nrm = _seeded(3)
    tex_ty = rng.integers(0, 4, N).astype(np.int32)
    scale = rng.uniform(0.5, 8.0, N).astype(np.float32)
    alb = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(3)]
    alb2 = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(3)]
    image = np.ascontiguousarray(tpresets._earth_bitmap())
    got = _np(textures.effective_albedo(
        _t(alb), torch.from_numpy(tex_ty), _t(alb2), torch.from_numpy(scale), _t(pts),
        image=torch.from_numpy(image), outward=_t(nrm)))
    with jax.disable_jit():
        want = _np(jtex.effective_albedo(
            _j(alb), jnp.asarray(tex_ty), _j(alb2), jnp.asarray(scale), _j(pts),
            image=jnp.asarray(image), outward=_j(nrm)))
    exact = tex_ty != tapi.TEXTURE_IMAGE
    np.testing.assert_array_equal(got[:, exact], want[:, exact])
    assert (got == want).all(0)[~exact].mean() >= 0.999
    # Without a bitmap, image lanes keep their albedo rows, as in JAX.
    nobmp = _np(textures.effective_albedo(
        _t(alb), torch.from_numpy(tex_ty), _t(alb2), torch.from_numpy(scale), _t(pts)))
    image_lanes = tex_ty == tapi.TEXTURE_IMAGE
    np.testing.assert_array_equal(nobmp[:, image_lanes], np.stack(alb)[:, image_lanes])
    np.testing.assert_array_equal(nobmp[:, exact], got[:, exact])


# -- compiled rows, kernel tables, fingerprints --------------------------------


def _leaves(scene, to_np):
    return {name: to_np(leaf(scene, name)) for name in SCENE_LEAVES
            if leaf(scene, name) is not None}


@pytest.mark.parametrize("name", ["texture", "earth", "textured-mesh", "seventy",
                                  "textured-field"])
def test_compiled_texture_rows_are_jax(name):
    world, jworld = worlds(name)
    sort = wants_spatial_sort(world)
    jscene = jcompile(jworld, spatial_sort=sort)
    scene = compile_scene(world, spatial_sort=sort)
    want = _leaves(jscene, np.asarray)
    got = _leaves(scene, lambda t: t.numpy())
    assert got.keys() == want.keys()
    assert "tex_ty" in got and ("tex_image" in got) == (name == "earth")
    assert ("tris.tex_ty" in got) == (name == "textured-mesh")
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert scene_fingerprint(scene) == jfingerprint(jscene)
    if name == "seventy":  # the sort carried each sphere's scale with it
        order = np.argsort(got["center.x"][:70])
        np.testing.assert_array_equal(got["tex_scale"][:70][order], np.arange(70) + 1.0)


@pytest.mark.parametrize("name", ["three-sphere", "mesh", "cornell"])
def test_untextured_scenes_have_no_texture_rows(name):
    world = tpresets.get_scene(name)
    scene = compile_scene(world, spatial_sort=wants_spatial_sort(world))
    assert scene.tex_ty is None and scene.albedo2 is None and scene.tex_scale is None
    assert scene.tex_image is None
    if scene.has_triangles:
        assert scene.tris.tex_ty is None and scene.tris.albedo2 is None
    tables = ktrace.gate_tables(scene)
    assert not tables.textured and tables.tex is None and tables.image is None


def _decoded(rows, tids):
    """The JAX prefetch's texture rows (albedo2 r with the type's low bit
    in its sign, g, b, scale with its high bit) as the port's [5, n]
    table (``_tex_ids`` order)."""
    rows = np.asarray(rows)
    bit = lambda a: (a.view(np.uint32) >> 31).astype(np.int64)  # noqa: E731
    idx = bit(rows[0]) + 2 * bit(rows[3])
    ty = np.asarray(tids, np.float32)[idx]
    return np.stack([np.abs(rows[0]), rows[1], rows[2], np.abs(rows[3]), ty])


@pytest.mark.parametrize("cfg", [{}, dict(UNROLL_MAX=0, TRI_CHUNK=4)], ids=["default", "gated"])
@pytest.mark.parametrize("name", ["texture", "earth", "textured-mesh", "textured-field"])
def test_kernel_texture_tables_are_the_jax_prefetch_rows(name, cfg):
    """``gate_tables``' texture tables hold what the JAX kernel's
    ``_scene_to_prefetch`` rows 9-12 and ``_tri_prefetch`` rows 14-17
    decode to, pads included."""
    world, jworld = worlds(name)
    sort = wants_spatial_sort(world)
    jscene = jcompile(jworld, spatial_sort=sort)
    ts = tuple(jworld.texture_set)
    f32, _, _, trf, _, _ = _scene_to_prefetch(
        jscene, tuple(sorted(jworld.material_set)), JKernelConfig(**cfg), ts)
    tables = ktrace.gate_tables(compile_scene(world, spatial_sort=sort), KernelConfig(**cfg))
    assert tables.textured and ktrace.extras_needed(tables, 8)
    np.testing.assert_array_equal(tables.tex.numpy(), _decoded(np.asarray(f32)[9:13], _tex_ids(ts)))
    if world.meshes:
        np.testing.assert_array_equal(tables.tri_tex.numpy(),
                                      _decoded(np.asarray(trf)[14:18], _tex_ids(ts)))
    else:
        assert tables.tri_tex is None
    if name == "earth":
        np.testing.assert_array_equal(tables.image.numpy(), np.asarray(jscene.tex_image))
        assert tables.image.is_contiguous()


def test_image_texture_on_a_mesh_raises():
    from myraytracer_tpu_torch.scene import meshgen

    img = tpresets.earth_scene().spheres[1].material
    v, f = meshgen.quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    with pytest.raises(ValueError, match="sphere UVs only"):
        compile_scene(tapi.World(spheres=[], meshes=[tapi.Mesh(v, f, img)]))
    two = [tapi.Sphere((0, 0, 0), 1.0, img),
           tapi.Sphere((3, 0, 0), 1.0, tapi.Lambertian(tapi.ImageTexture(
               tpresets._earth_bitmap() * 0.5)))]
    with pytest.raises(ValueError, match="one ImageTexture"):
        compile_scene(tapi.World(spheres=two))


# -- renders against the JAX jnp integrator ------------------------------------


def render_pair(name, w, h, spp, depth, eager=False, nee=False, cfg=None):
    """(port image, port segments, JAX image, JAX segments) of one world,
    from key 0 and sample 0; the port's sweep gated by ``cfg`` (ungated
    when None)."""
    world, jworld = worlds(name)
    sort = wants_spatial_sort(world)
    jr = make_jnp(jworld.camera, w, h, spp, depth, sample_batch=spp, sky=jworld.ambient,
                  nee_lights=jlights.extract_lights(jworld) if nee else None)
    jscene = jcompile(jworld, spatial_sort=sort)
    with jax.disable_jit() if eager else contextlib.nullcontext():
        want, jsegs = jr(jscene, jrng.key_from_seed(0), 0)
    scene = compile_scene(world, spatial_sort=sort)
    gates = None if cfg is None else ktrace.gate_tables(scene, cfg).gates
    block = integrator.make_block_renderer(
        world.camera, w, h, h, spp, depth, sample_batch=spp, sky=world.ambient, gates=gates,
        nee_lights=lights.extract_lights(world) if nee else None,
        texture_set=world.texture_set)
    got, segs = integrator.frame_renderer(block, spp)(scene, KEY, 0)
    return got.numpy(), float(segs), np.asarray(want), float(jsegs)


# (world, nee, gates): the textured cases of the issue's list.
RENDERS = [
    ("texture", False, None),
    ("earth", False, None),
    ("textured-mesh", False, None),
    ("textured-mesh", False, GATED_TRIS),
    ("textured-metal", False, None),
    ("lit-textured", True, None),
    ("textured-field", False, KernelConfig()),
]
RENDER_IDS = [f"{n}" + ("-nee" if e else "") + ("-gated" if c else "") for n, e, c in RENDERS]


@pytest.mark.parametrize("name,nee,cfg", RENDERS, ids=RENDER_IDS)
def test_plain_matches_unfused_jax_integrator(name, nee, cfg):
    """Eagerly, the same paths: every pixel within rtol 1e-4, atol 1e-5 and
    equal segment counts."""
    got, segs, want, jsegs = render_pair(name, 24, 16, 2, 8, eager=True, nee=nee, cfg=cfg)
    assert got.max() > 0.05
    assert np.isclose(got, want, rtol=1e-4, atol=1e-5).all()
    assert segs == jsegs


@pytest.mark.parametrize("name,nee,cfg", RENDERS, ids=RENDER_IDS)
def test_plain_matches_jax_integrator(name, nee, cfg):
    """Jitted: XLA's FMAs flip a rare path, so the statistical bar of
    ``assert_render_close``, its pixel fraction 0.96 as the final golden's.
    On the marble-heavy field the paths are the same (equal segments) but
    marble's fused lerps move its band by up to 2^-16, past the pixels'
    atol of 1e-5 on dark albedos: its bar is 0.95 (measured 0.953 at 16x8,
    0.959 at 32x16; the untextured field reads 0.977 and 0.986)."""
    got, segs, want, jsegs = render_pair(name, 16, 8, 2, 8, nee=nee, cfg=cfg)
    assert_render_close(got, want, segs, jsegs,
                        pixel_frac=0.95 if name == "textured-field" else 0.96)
    if name == "textured-field":
        assert segs == jsegs


def test_texture_changes_only_the_albedo():
    """A checker whose two colors are equal renders bitwise the solid
    scene: textures consume no draws and move no path."""
    A = tapi
    solid = A.World([A.Sphere((0, -100.5, -1), 100, A.Lambertian((0.5, 0.5, 0.5))),
                     A.Sphere((0, 0, -1), 0.5, A.Metal((0.6, 0.6, 0.6), fuzz=0.2))])
    same = A.World([A.Sphere((0, -100.5, -1), 100, A.Lambertian(A.Checker(
                        (0.5, 0.5, 0.5), (0.5, 0.5, 0.5), scale=3.0))),
                    A.Sphere((0, 0, -1), 0.5, A.Metal(A.Checker(
                        (0.6, 0.6, 0.6), (0.6, 0.6, 0.6)), fuzz=0.2))])
    r = integrator.make_renderer(solid.camera, 16, 8, 2, 6)
    a, sa = r(compile_scene(solid), KEY, 0)
    b, sb = r(compile_scene(same), KEY, 0)
    assert torch.equal(a, b) and float(sa) == float(sb)


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    """For CPU tensors the kernel's renderers compute the plain version's
    frame and adaptive blocks, textures included."""
    world = tpresets.earth_scene()
    scene = compile_scene(world)
    args = (world.camera, 16, 8, 2, 4)
    a, sa = ktrace.make_renderer(*args, texture_set=world.texture_set)(scene, KEY, 3)
    b, sb = integrator.make_renderer(*args, texture_set=world.texture_set)(scene, KEY, 3)
    assert torch.equal(a, b) and float(sa) == float(sb)
    ar = ktrace.make_adaptive_renderer(world.camera, 64, 32, 1, 2, 4,
                                       texture_set=world.texture_set)
    sums, _ = ar(scene, KEY, torch.tensor([0]), torch.tensor([3]))
    img, _ = integrator.make_block_renderer(world.camera, 64, 32, 32, 2, 4)(scene, KEY, 0, 3, 2)
    assert torch.equal(sums[0], img)


# -- sessions and the CLI -------------------------------------------------------


def test_textured_session_checkpoint_refuses_another_texture(tmp_path):
    """A resume continues the stream; a world whose texture differs is
    refused through the fingerprint."""
    cfg = RenderConfig(width=16, height=8, samples_per_frame=2, ray_depth=4, backend="torch")
    s = RenderSession(tpresets.earth_scene(), cfg)
    s.step()
    s.save_checkpoint(tmp_path / "e.npz")
    same = RenderSession(tpresets.earth_scene(), cfg)
    same.load_checkpoint(tmp_path / "e.npz")
    assert torch.equal(same.step(), RenderSession(tpresets.earth_scene(), cfg).run(2))
    w = tpresets.earth_scene()
    other = tapi.World([w.spheres[0], tapi.Sphere(w.spheres[1].center, w.spheres[1].radius,
                                                  tapi.Lambertian(tapi.ImageTexture(
                                                      tpresets._earth_bitmap() * 0.5)))],
                       camera=w.camera)
    with pytest.raises(ValueError, match="fingerprint"):
        RenderSession(other, cfg).load_checkpoint(tmp_path / "e.npz")


@pytest.mark.parametrize("scene", ["texture", "earth"])
def test_cli_textured_scenes_end_to_end(tmp_path, scene):
    """``cli.main`` on the torch backend: uniform with a resume bitwise the
    continued session, then ``--adaptive``."""
    from myraytracer_tpu_torch.output.image import read_png

    base = ["--backend", "torch", "--scene", scene, "--width", "64", "--height", "32",
            "--samples-per-frame", "1", "--ray-depth", "4"]
    ck, ck2 = tmp_path / "u.npz", tmp_path / "u2.npz"
    assert cli.main(base + ["--frames", "2", "--checkpoint", str(ck),
                            "--out", str(tmp_path / "u.png")]) == 0
    img = read_png(tmp_path / "u.png")
    assert img.shape == (32, 64, 3) and img.std() > 5
    assert cli.main(base + ["--frames", "1", "--resume", str(ck), "--checkpoint", str(ck2),
                            "--out", str(tmp_path / "u2.png")]) == 0
    cfg = RenderConfig(width=64, height=32, samples_per_frame=1, ray_depth=4, backend="torch")
    cont = RenderSession(tpresets.get_scene(scene), cfg)
    cont.load_checkpoint(ck)
    with np.load(ck2) as z:
        np.testing.assert_array_equal(z["framebuffer"], cont.step().numpy())
    ack = tmp_path / "a.npz"
    assert cli.main(base + ["--adaptive", "1", "--frames", "3", "--checkpoint", str(ack),
                            "--out", str(tmp_path / "a.png")]) == 0
    with np.load(ack) as z:
        meta = json.loads(str(z["meta"]))
    s = AdaptiveSession(tpresets.get_scene(scene), cfg.replace(frame_batch=meta["windows"]),
                        n_sel=meta["n_sel"])
    s.load_checkpoint(ack)
    assert s.bootstrapped and torch.isfinite(s.framebuffer).all() and s.framebuffer.max() > 0
