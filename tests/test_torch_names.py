"""The public names the port shares with the JAX package: ``render``, the keyed
samplers ``unit_sphere`` and ``unit_ball``, ``make_denoiser`` and ``V3``'s
``const``, ``from_stacked`` and ``length``, each against its JAX namesake.

The samplers' draws are bitwise JAX's (the same threefry words from the
same slots, ``unit_ball`` taking ``draw_id`` and ``draw_id + 1``); their
``cos``/``sin``/``exp2``/``log2`` differ from XLA's by an ulp on the CPU, so
the vectors are held to the samplers' tolerance of
``tests/test_torch_camera_materials.py`` (rtol 1e-5, atol 1e-6), and
bitwise to the port's own transform of JAX's draws.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.config import RenderConfig as JConfig
from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu.core.vec import V3 as JV3
from myraytracer_tpu.render import session as jsession
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.core.vec import V3
from myraytracer_tpu_torch.render import denoise, session
from myraytracer_tpu_torch.scene import presets
from test_torch_trace import assert_render_close

SCATTER = dict(rtol=1e-5, atol=1e-6)


def _draw_inputs(seed):
    rs = np.random.RandomState(seed)
    lanes = rs.randint(0, 2**32, size=2048, dtype=np.uint64).astype(np.uint32)
    draws = rs.randint(0, 2**32, size=2048, dtype=np.uint64).astype(np.uint32)
    draws[:3] = [0, 0xFFFFFFFF, 0xFFFFFFFE]  # the last slot wraps to 0 in unit_ball
    return int(rs.randint(0, 2**62)), lanes, draws


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["unit_sphere", "unit_ball"])
def test_keyed_samplers_match_jax(name, seed):
    key_seed, lanes, draws = _draw_inputs(seed)
    jkey, tkey = jrng.key_from_seed(key_seed), trng.key_from_seed(key_seed)
    jl, jd = jnp.asarray(lanes), jnp.asarray(draws)
    tl, td = (torch.from_numpy(a.astype(np.int64)) for a in (lanes, draws))
    got = getattr(trng, name)(tkey, tl, td)
    want = getattr(jrng, name)(jkey, jl, jd)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SCATTER)
    # JAX's draws from the same slots, through the port's transform: bitwise.
    u = [torch.from_numpy(np.array(x)) for x in jrng.uniform2(jkey, jl, jd)]
    if name == "unit_sphere":
        same = trng.unit_sphere_from_uniforms(*u)
        np.testing.assert_array_equal(got.z.numpy(), np.asarray(want.z))  # 1 - 2u
    else:
        u3 = torch.from_numpy(np.array(jrng.uniform2(jkey, jl, jd + jnp.uint32(1))[0]))
        same = trng.unit_ball_from_uniforms(*u, u3)
    for a, b in zip(got, same):
        assert torch.equal(a, b)


def test_v3_const_from_stacked_and_length():
    rs = np.random.RandomState(5)
    for dim, shape in ((0, (3, 4, 5)), (1, (4, 3, 5)), (-1, (4, 5, 3))):
        a = rs.standard_normal(shape).astype(np.float32)
        t = V3.from_stacked(torch.from_numpy(a), dim)
        j = JV3.from_stacked(jnp.asarray(a), dim)
        for x, y in zip(t, j):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        np.testing.assert_array_equal(t.length().numpy(), np.asarray(j.length()))
        assert torch.equal(t.stacked(dim), torch.from_numpy(a))
    c, jc = V3.const(0.5, -1.25, 3.1), JV3.const(0.5, -1.25, 3.1)
    for x, y in zip(c, jc):
        assert x.shape == () and x.dtype == torch.float32
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert V3.const(1, 2, 3, dtype=torch.float64).x.dtype == torch.float64
    assert float(V3.const(3.0, 4.0, 0.0).length()) == 5.0


def test_make_denoiser_is_a_denoiser_with_the_settings():
    world = presets.get_scene("three-sphere")
    kw = dict(iterations=3, sigma_color=2.0, sigma_normal=0.5, sigma_depth=0.1, auto=True)
    d = denoise.make_denoiser(world, 16, 8, device="cpu", **kw)
    want = denoise.Denoiser(world, 16, 8, device="cpu", **kw)
    assert type(d) is denoise.Denoiser
    assert (d.world, d.width, d.height, d.iterations, d.sigmas, d.auto, d.device) == (
        want.world, want.width, want.height, want.iterations, want.sigmas, want.auto,
        want.device)
    fb = torch.rand((8, 16, 3), generator=torch.Generator().manual_seed(0))
    assert torch.equal(d(fb, spp=1), want(fb, spp=1))
    with pytest.raises(TypeError):
        denoise.make_denoiser(world, 16, 8)  # the device is the caller's to name


@pytest.mark.parametrize("name,frac", [("three-sphere", 0.98), ("final", 0.96)])
def test_render_matches_jax(name, frac):
    cfg = dict(width=16, height=8, samples_per_frame=2, ray_depth=4)
    got = session.render(presets.get_scene(name), RenderConfig(**cfg, backend="torch"),
                         frames=2)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    want = jsession.render(jpresets.get_scene(name), JConfig(**cfg, backend="jnp"), frames=2)
    # render returns no segment count (tests/test_torch_trace.py holds them).
    assert_render_close(got, want, 1.0, 1.0, pixel_frac=frac)


def test_render_is_bitwise_unfused_jax():
    """Run op by op, XLA fuses no multiply-add, and the render is JAX's bit
    for bit (the blend's fused form is ``session.fma_f32``'s)."""
    cfg = dict(width=16, height=8, samples_per_frame=1, ray_depth=3)
    got = session.render(presets.get_scene("three-sphere"), RenderConfig(**cfg, backend="torch"))
    with jax.disable_jit():
        want = jsession.render(jpresets.get_scene("three-sphere"), JConfig(**cfg, backend="jnp"))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_render_takes_a_renderer_factory():
    from myraytracer_tpu_torch.render import integrator

    cfg = RenderConfig(width=16, height=8, ray_depth=3, backend="torch")
    world = presets.get_scene("defocus")
    assert np.array_equal(session.render(world, cfg, 2, integrator.make_renderer),
                          session.render(world, cfg, 2))
