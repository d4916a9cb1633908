"""The PyTorch port's camera, samplers and materials against the JAX package.

Inputs are seeded numpy arrays handed to both. The tolerances cover what
the two CPU back ends round differently: XLA contracts ``a*b + c`` into
FMAs, and the libms of ``cos``/``sin``/``exp2``/``log2`` differ by a few
ulp (rtol 1e-6 for rays, 1e-5 for scatter).
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu.core.vec import V3 as JV3
from myraytracer_tpu.render import camera as jcam
from myraytracer_tpu.render import materials as jmat
from myraytracer_tpu.render.hit import Hit as JHit
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.core.vec import V3 as TV3
from myraytracer_tpu_torch.render import camera as tcam
from myraytracer_tpu_torch.render import materials as tmat
from myraytracer_tpu_torch.render.hit import Hit as THit
from myraytracer_tpu_torch.scene import presets as tpresets

N = 8192
W, H = 64, 32
RAYS = dict(rtol=1e-6, atol=1e-6)
SCATTER = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    ix = rs.randint(0, W, N).astype(np.int32)
    iy = rs.randint(0, H, N).astype(np.int32)
    u = rs.random_sample((4, N)).astype(np.float32)
    return ix, iy, u


def _close_v3(t, j, tol):
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def test_reference_rays():
    ix, iy, u = _inputs(0)
    jo, jd = jcam.reference_rays(W, H, jnp.asarray(ix), jnp.asarray(iy),
                                 *(jnp.asarray(c) for c in u))
    to, td = tcam.reference_rays(W, H, torch.from_numpy(ix), torch.from_numpy(iy),
                                 *(torch.from_numpy(c) for c in u))
    _close_v3(to, jo, RAYS)
    _close_v3(td, jd, RAYS)


@pytest.mark.parametrize("name", ["defocus", "final"])
def test_general_and_packed_rays(name):
    ix, iy, u = _inputs(1)
    jworld, tworld = jpresets.get_scene(name), tpresets.get_scene(name)
    jargs = (jnp.asarray(ix), jnp.asarray(iy), *(jnp.asarray(c) for c in u))
    targs = (torch.from_numpy(ix), torch.from_numpy(iy), *(torch.from_numpy(c) for c in u))
    jgen = jcam.make_ray_generator(jworld.camera, W, H)
    tgen = tcam.make_ray_generator(tworld.camera, W, H)
    jo, jd = jgen(*jargs)
    to, td = tgen(*targs)
    _close_v3(to, jo, RAYS)
    _close_v3(td, jd, RAYS)
    packed = tcam.pack_camera(tworld.camera, W, H)
    po, pd = tcam.rays_from_packed(torch.from_numpy(packed), W, H, *targs)
    jpo, jpd = jcam.rays_from_packed(jnp.asarray(packed), W, H, *jargs)
    _close_v3(po, jpo, RAYS)
    _close_v3(pd, jpd, RAYS)
    # The packed camera is the closure camera, bit for bit.
    for a, b in zip((*po, *pd), (*to, *td)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("name", ["defocus", "final"])
def test_pack_camera_bitwise(name):
    jw, tw = jpresets.get_scene(name), tpresets.get_scene(name)
    for w, h in ((W, H), (1200, 800), (17, 5)):
        np.testing.assert_array_equal(
            tcam.pack_camera(tw.camera, w, h), jcam.pack_camera(jw.camera, w, h)
        )
    with pytest.raises(ValueError):
        tcam.pack_camera(tpresets.reference_scene().camera, W, H)


def test_samplers():
    _, _, u = _inputs(2)
    js = jrng.unit_sphere_from_uniforms(jnp.asarray(u[0]), jnp.asarray(u[1]))
    ts = trng.unit_sphere_from_uniforms(torch.from_numpy(u[0]), torch.from_numpy(u[1]))
    _close_v3(ts, js, SCATTER)
    jb = jrng.unit_ball_from_uniforms(*(jnp.asarray(c) for c in u[:3]))
    tb = trng.unit_ball_from_uniforms(*(torch.from_numpy(c) for c in u[:3]))
    _close_v3(tb, jb, SCATTER)
    jd = jrng.unit_disk_from_uniforms(jnp.asarray(u[2]), jnp.asarray(u[3]))
    td = trng.unit_disk_from_uniforms(torch.from_numpy(u[2]), torch.from_numpy(u[3]))
    _close_v3(td, jd, SCATTER)


def _unit(rs, n):
    v = rs.standard_normal((3, n)).astype(np.float32)
    return v / np.linalg.norm(v, axis=0, keepdims=True).astype(np.float32)


def test_scatter_all_materials():
    rs = np.random.RandomState(3)
    d = _unit(rs, N)
    n = _unit(rs, N)
    front = rs.random_sample(N) < 0.5
    fields = dict(
        mat_ty=rs.randint(1, 4, N).astype(np.int32),
        albedo=rs.random_sample((3, N)).astype(np.float32),
        fuzz=(rs.random_sample(N) * 0.5).astype(np.float32),
        ior=np.where(rs.random_sample(N) < 0.5, 1.5, 1.33).astype(np.float32),
    )
    sphere_s = _unit(rs, N)
    ball_s = (_unit(rs, N) * rs.random_sample(N).astype(np.float32))
    u_reflect = rs.random_sample(N).astype(np.float32)

    j3 = lambda a: JV3(*(jnp.asarray(c) for c in a))  # noqa: E731
    t3 = lambda a: TV3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))  # noqa: E731
    zeros = np.zeros(N, np.float32)
    jhit = JHit(
        t=jnp.asarray(zeros), idx=jnp.zeros(N, jnp.int32), mask=jnp.ones(N, bool),
        point=j3(np.zeros((3, N), np.float32)), normal=j3(n),
        front_face=jnp.asarray(front), mat_ty=jnp.asarray(fields["mat_ty"]),
        albedo=j3(fields["albedo"]), fuzz=jnp.asarray(fields["fuzz"]),
        ior=jnp.asarray(fields["ior"]),
    )
    thit = THit(
        t=torch.from_numpy(zeros), idx=torch.zeros(N, dtype=torch.int64),
        mask=torch.ones(N, dtype=torch.bool), point=t3(np.zeros((3, N), np.float32)),
        normal=t3(n), front_face=torch.from_numpy(front),
        mat_ty=torch.from_numpy(fields["mat_ty"]), albedo=t3(fields["albedo"]),
        fuzz=torch.from_numpy(fields["fuzz"]), ior=torch.from_numpy(fields["ior"]),
    )
    js = jmat.scatter(j3(d), jhit, j3(sphere_s), j3(ball_s), jnp.asarray(u_reflect))
    ts = tmat.scatter(t3(d), thit, t3(sphere_s), t3(ball_s), torch.from_numpy(u_reflect))
    np.testing.assert_array_equal(ts.ok.numpy(), np.asarray(js.ok))
    _close_v3(ts.direction, js.direction, SCATTER)
    _close_v3(ts.attenuation, js.attenuation, SCATTER)
    for ty in (1, 2, 3):  # every family really occurs, and metal absorbs some
        assert (fields["mat_ty"] == ty).sum() > N // 4
    assert not np.asarray(js.ok).all()


def test_pow5_is_the_integer_pow_products():
    x = np.random.RandomState(4).random_sample(N).astype(np.float32)
    want = np.asarray(jnp.asarray(x) ** 5)
    got = tmat.pow5(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_color_sky():
    y = np.random.RandomState(5).uniform(-1, 1, N).astype(np.float32)
    _close_v3(tmat.color_sky(torch.from_numpy(y)), jmat.color_sky(jnp.asarray(y)), SCATTER)
