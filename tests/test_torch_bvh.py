"""The triangle BVH traversal of the PyTorch port's plain integrator.

Past 512 triangles a ``torch`` session's scene carries the flat skip-link
BVH (``scene/compile.py``), as the JAX jnp session's does, and
``render.hit.closest_hit`` walks it one cursor a lane. Here, on the CPU:

* the traversal is bitwise JAX's ``_triangle_bvh_candidates`` run op by op
  (``jax.disable_jit()``) on mesh:3 (1,614 triangles): the rays of a 16x8
  image and of three bounces after them, t and triangle index;
* a ``torch`` session on mesh:3 agrees with the JAX jnp session (jitted, so
  with XLA's FMA contraction) under ``test_torch_trace.assert_render_close``'s
  bar: rtol 1e-4, atol 1e-5 on >= 98% of pixels, mean within 1e-4
  relative, segments within 1%;
* only the ``torch`` backend gets a BVH, and only past 512 triangles.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myraytracer_tpu.config import RenderConfig as JRenderConfig
from myraytracer_tpu.core.vec import V3 as JV3
from myraytracer_tpu.render import hit as jhit
from myraytracer_tpu.render.session import RenderSession as JRenderSession
from myraytracer_tpu.render.session import scene_fingerprint as jfingerprint
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu.scene.compile import compile_scene as jcompile
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core.vec import V3
from myraytracer_tpu_torch.kernels.trace import gate_tables
from myraytracer_tpu_torch.render import hit
from myraytracer_tpu_torch.render.camera import make_ray_generator
from myraytracer_tpu_torch.render.session import RenderSession, wants_triangle_bvh
from myraytracer_tpu_torch.scene import presets
from myraytracer_tpu_torch.scene.compile import compile_scene

from test_torch_trace import assert_render_close

T_MIN, T_MAX = 1e-3, 1e4


def _bounce_rays(scene, world, w, h, bounces):
    """The camera rays of a ``w`` x ``h`` image (pixel centers) and, for
    ``bounces`` more steps, the mirror reflections of the rays that hit:
    [n] f32 origin and direction components, every step's rays in turn."""
    gen = make_ray_generator(world.camera, w, h)
    jj, ii = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    half = torch.full((h * w,), 0.5)
    o, d = gen(ii.reshape(-1), jj.reshape(-1), half, half, half, half)
    os_, ds = [], []
    for _ in range(bounces + 1):
        os_.append(o)
        ds.append(d)
        hit_ = hit.closest_hit(o, d, scene, T_MIN, T_MAX)
        keep = hit_.mask
        n = V3(*(c[keep] for c in hit_.normal))
        dk = V3(*(c[keep] for c in d))
        r = dk - n * (2.0 * dk.dot(n))
        o = V3(*(c[keep] for c in hit_.point))
        d = r * torch.rsqrt(r.length_sq())
    cat = lambda vs: V3(*(torch.cat([getattr(v, c) for v in vs]) for c in "xyz"))  # noqa: E731
    return cat(os_), cat(ds)


def test_bvh_traversal_is_jax_op_by_op():
    world, jworld = presets.get_scene("mesh:3"), jpresets.get_scene("mesh:3")
    scene = compile_scene(world, spatial_sort=True, triangle_bvh=True)
    jscene = jcompile(jworld, spatial_sort=True, triangle_bvh=True)
    o, d = _bounce_rays(scene, world, 16, 8, 3)
    t, i = hit._triangle_bvh_candidates(o, d, scene.tris, T_MIN, T_MAX)
    to_j = lambda v: JV3(*(jnp.asarray(c.numpy()) for c in v))  # noqa: E731
    with jax.disable_jit():
        jt, ji = jhit._triangle_bvh_candidates(to_j(o), to_j(d), jscene.tris, T_MIN, T_MAX)
    assert o.x.shape[0] > 16 * 8 and bool((t < T_MAX).any())
    assert np.array_equal(t.numpy(), np.asarray(jt))
    assert np.array_equal(i.numpy(), np.asarray(ji).astype(np.int64))


def test_torch_session_on_a_bvh_mesh_matches_the_jax_jnp_session():
    kw = dict(width=16, height=8, samples_per_frame=2, ray_depth=4)
    session = RenderSession(presets.get_scene("mesh:3"), RenderConfig(backend="torch", **kw))
    jsession = JRenderSession(jpresets.get_scene("mesh:3"), JRenderConfig(**kw))
    assert session.scene.tris.bvh is not None and jsession.scene.tris.bvh is not None
    assert session.scene_fingerprint == jfingerprint(jsession.scene)
    got, want = session.step(), jsession.step()
    assert_render_close(got.numpy(), np.asarray(want), session.segments_traced,
                        jsession.segments_traced)


@pytest.mark.parametrize("name,backend,want", [
    ("mesh:3", "torch", True), ("mesh:2", "torch", False),
    ("mesh:3", "cuda", False), ("mesh:3", "cpu", False),
])
def test_only_the_torch_backend_gets_a_bvh(name, backend, want):
    assert wants_triangle_bvh(presets.get_scene(name), backend) is want


def test_closest_hit_takes_the_bvh_only_without_gates():
    """The kernel's plain version sweeps behind its gates even on a scene
    that carries a BVH; without gates the BVH answers, with the same t as
    the ungated sweep wherever the ray hits."""
    world = presets.get_scene("mesh:3")
    scene = compile_scene(world, spatial_sort=True, triangle_bvh=True)
    flat = scene._replace(tris=scene.tris._replace(bvh=None))
    o, d = _bounce_rays(flat, world, 16, 8, 1)
    a = hit.closest_hit(o, d, scene, T_MIN, T_MAX)
    b = hit.closest_hit(o, d, flat, T_MIN, T_MAX)
    assert torch.equal(a.mask, b.mask) and torch.equal(a.t, b.t)
    gates = gate_tables(flat).gates
    a = hit.closest_hit(o, d, scene, T_MIN, T_MAX, gates)
    b = hit.closest_hit(o, d, flat, T_MIN, T_MAX, gates)
    for x, y in zip(a, b):
        if x is not None:
            assert all(torch.equal(u, v) for u, v in zip(x, y)) if isinstance(x, V3) \
                else torch.equal(x, y)
