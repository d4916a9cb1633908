"""The gated closest-hit sweep and triangle meshes in the PyTorch port.

The CUDA kernel takes the JAX kernel's gates (chunk and superchunk boxes
over the sphere and triangle tables, ``myraytracer_tpu/kernels/trace.py``)
and is held on the card to its plain version, which models the gates lane
by lane (``render/hit.py``). Here, on the CPU:

* ``kernels.trace.gate_tables`` equals the JAX package's
  ``_scene_to_prefetch`` boxes bit for bit (its ``aabb``, ``saabb``,
  ``traabb``, ``tsaabb``, dummies included);
* the plain gated sweep equals the plain ungated sweep bit for bit, in
  images and segments, on the final scene and on a mesh with two-level
  gates forced; on a dense random field the gates' eps padding is
  expected to hold as well, and the test states its bar;
* the plain mesh renders agree with the JAX jnp integrator (no BVH) under
  the bar of ``test_torch_trace.assert_render_close`` (FMA contraction in
  XLA's CPU backend; rtol 1e-4, atol 1e-5 on >= 98% of pixels, mean within
  1e-4 relative, segments within 1%), and with the op-by-op (unfused) JAX
  integrator with equal segment counts.

The JAX kernel's own culled parity tests run it in interpret mode and are
in the slow tier (``tests/test_pallas.py``); these use its tables and its
plain integrator instead.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import numpy as np
import pytest
import torch

from myraytracer_tpu.core import rng as jrng
from myraytracer_tpu.kernels.trace import KernelConfig as JKernelConfig
from myraytracer_tpu.kernels.trace import _scene_to_prefetch
from myraytracer_tpu.kernels.trace import resolve_tri_chunk as jresolve_tri_chunk
from myraytracer_tpu.render.integrator import make_renderer as make_jnp
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu.scene.compile import compile_scene as jcompile
from myraytracer_tpu_torch.config import KernelConfig, resolve_tri_chunk
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.kernels import trace as ktrace
from myraytracer_tpu_torch.render import integrator
from myraytracer_tpu_torch.render.camera import pack_camera
from myraytracer_tpu_torch.render.session import wants_spatial_sort
from myraytracer_tpu_torch.scene import api, presets
from myraytracer_tpu_torch.scene.compile import compile_scene

from test_torch_trace import assert_render_close

# No gates anywhere: spheres unculled, and UNROLL_MAX past any table (the
# JAX kernel's own switch for triangles).
UNCULLED = KernelConfig(FORCE_CULL=False, UNROLL_MAX=1 << 30)
TWO_LEVEL = KernelConfig(SUPER=2, SUPER_MIN=2)


def _compiled(name):
    world = presets.get_scene(name)
    return world, compile_scene(world, spatial_sort=wants_spatial_sort(world))


def _plain(world, scene, w, h, spp, depth, cfg, key=0, sample_start=0):
    cam = None
    if not world.camera.reference_mode:
        cam = torch.from_numpy(pack_camera(world.camera, w, h))
    return ktrace.trace_spheres_plain(
        scene, cam, trng.key_from_seed(key), w, h, 0, h, sample_start, spp, depth,
        1e-3, 1e4, world.ambient, tables=ktrace.gate_tables(scene, cfg),
    )


def test_plain_sample_batch_is_bitwise_one_sample_at_a_time():
    """The plain gated sweep traced a pixel's samples at once gives the
    bits of one sample at a time, over two frames in one call, on a mesh
    over a ground sphere (the check of the OBJ world at the main path's
    shapes batches them)."""
    mesh = presets.mesh_scene(subdivisions=1)
    world = api.World(spheres=[api.Sphere((0.0, -1000.0, 0.0), 1000.0,
                                          api.Lambertian((0.6, 0.6, 0.6)))],
                      meshes=mesh.meshes, camera=mesh.camera)
    scene = compile_scene(world, spatial_sort=True)
    w, h, spp, depth = 24, 40, 4, 8
    cam = torch.from_numpy(pack_camera(world.camera, w, h))
    args = (scene, cam, trng.key_from_seed(3), w, h, 17, 3, 5, spp, depth, 1e-3, 1e4,
            world.ambient)
    tables = ktrace.gate_tables(scene, TWO_LEVEL)
    one = ktrace.trace_spheres_plain(*args, frames=2, tables=tables)
    batched = ktrace.trace_spheres_plain(*args, frames=2, tables=tables, sample_batch=spp)
    assert one[0].shape == (2, 3, 3, w)
    assert torch.equal(one[0], batched[0]) and torch.equal(one[1], batched[1])


@pytest.mark.parametrize("cfg", [{}, dict(SUPER=2, SUPER_MIN=2)], ids=["default", "two-level"])
@pytest.mark.parametrize("name", ["final", "spheres:4", "spheres:20", "mesh", "mesh:1"])
def test_gate_tables_bitwise_equal_to_jax(name, cfg):
    jworld = jpresets.get_scene(name)
    spatial_sort = len(jworld.spheres) > 64 or jworld.triangle_count > 64
    jscene = jcompile(jworld, spatial_sort=spatial_sort)
    _, aabb, saabb, _, traabb, tsaabb = _scene_to_prefetch(
        jscene, tuple(sorted(jworld.material_set)), JKernelConfig(**cfg))
    _, scene = _compiled(name)
    got = ktrace.gate_tables(scene, KernelConfig(**cfg))
    for label, want, have in (("aabb", aabb, got.aabb), ("saabb", saabb, got.saabb),
                              ("traabb", traabb, got.traabb), ("tsaabb", tsaabb, got.tsaabb)):
        assert have.dtype == torch.float32, label
        np.testing.assert_array_equal(have.numpy(), np.asarray(want), err_msg=label)


@pytest.mark.parametrize("name,n_spheres,n_chunks,n_super,n_tris,tn_chunks,tn_super", [
    ("final", 488, 10, 0, 0, 0, 0),
    ("spheres:20", 1640, 34, 5, 0, 0, 0),
    ("mesh", 8, 0, 0, 448, 7, 0),
    ("mesh:5", 8, 0, 0, 25616, 1601, 201),
    ("three-sphere", 8, 0, 0, 0, 0, 0),
])
def test_sweep_layout(name, n_spheres, n_chunks, n_super, n_tris, tn_chunks, tn_super):
    """Padded widths, chunk and super counts the kernel is launched with,
    and the gate decisions of the JAX kernel."""
    _, scene = _compiled(name)
    t = ktrace.gate_tables(scene)
    sweep = dict(zip(ktrace.SWEEP_FIELDS, t.sweep))
    assert (sweep["n_spheres"], sweep["n_chunks"], sweep["n_super"]) == (
        n_spheres, n_chunks, n_super)
    assert (sweep["n_tris"], sweep["tn_chunks"], sweep["tn_super"]) == (
        n_tris, tn_chunks, tn_super)
    assert t.table.shape == (ktrace.TABLE_ROWS, n_spheres)
    assert sweep["sph_cull"] == int(n_spheres > 64) and sweep["tri_cull"] == int(n_tris > 64)
    assert t.boxes.numel() == 6 * (n_chunks + n_super + tn_chunks + tn_super) + 1
    # Pads sit at PAD_CENTER, outside every box; the real spheres keep
    # their rows.
    pads = t.table[0] > 1e29
    assert int((~pads).sum()) == len(presets.get_scene(name).spheres)


def test_gate_decisions():
    cfg = KernelConfig()
    assert not cfg.cull_spheres(56) and cfg.cull_spheres(104)
    assert not KernelConfig(FORCE_CULL=False).cull_spheres(488)
    assert KernelConfig(FORCE_CULL=True, CULL_MIN=1000).cull_spheres(488)
    assert not KernelConfig(FORCE_CULL=True).cull_spheres(56)  # within UNROLL_MAX
    assert cfg.cull_triangles(448) and not cfg.cull_triangles(64)
    assert KernelConfig(FORCE_CULL=False).cull_triangles(448)  # FORCE_CULL is spheres'
    for n in (0, 8, 768, 776, 8192, 8200, 25616):
        for tc in (0, 24):
            assert resolve_tri_chunk(KernelConfig(TRI_CHUNK=tc), n) == jresolve_tri_chunk(
                JKernelConfig(TRI_CHUNK=tc), n)


@pytest.mark.parametrize("name,w,h,spp,depth,cfg", [
    ("final", 48, 32, 2, 8, KernelConfig()),
    ("final", 48, 32, 1, 8, TWO_LEVEL),
    ("mesh", 48, 32, 2, 8, KernelConfig()),
    ("mesh:1", 48, 32, 2, 8, TWO_LEVEL),
])
def test_plain_gated_sweep_is_the_ungated_sweep(name, w, h, spp, depth, cfg):
    world, scene = _compiled(name)
    tables = ktrace.gate_tables(scene, cfg)
    assert tables.gates.sph_cull or tables.gates.tri_cull
    if cfg is TWO_LEVEL:
        assert tables.gates.saabb is not None or tables.gates.tsaabb is not None
    img, segs = _plain(world, scene, w, h, spp, depth, cfg)
    want, wsegs = _plain(world, scene, w, h, spp, depth, UNCULLED)
    assert torch.equal(img, want) and torch.equal(segs, wsegs)
    # The ungated plain sweep is the plain integrator's.
    ref, rsegs = integrator.make_block_renderer(
        world.camera, w, h, h, spp, depth, sky=world.ambient)(scene, trng.key_from_seed(0),
                                                              0, 0, spp)
    assert torch.equal(want, ref) and torch.equal(wsegs, rsegs)


def _dense_world():
    """900 random small spheres over a ground sphere
    (tools/parity_stress.py:41-62, seed 7)."""
    rng = np.random.default_rng(7)
    mats = [
        api.Lambertian(albedo=(0.5, 0.4, 0.3)),
        api.Metal(albedo=(0.9, 0.8, 0.7), fuzz=0.2),
        api.Dielectric(ior=1.5),
    ]
    spheres = [
        api.Sphere(center=tuple(map(float, rng.uniform(-12, 12, 3))),
                   radius=float(rng.uniform(0.1, 0.4)), material=mats[i % 3])
        for i in range(900)
    ]
    spheres.append(api.Sphere(center=(0, -1000.5, 0), radius=1000.0, material=mats[0]))
    return api.World(tuple(spheres), camera=api.Camera.reference())


@pytest.mark.parametrize("cfg", [KernelConfig(), TWO_LEVEL], ids=["default", "two-level"])
def test_dense_field_gated_sweep(cfg):
    """A dense field multiplies near-tangent encounters. A grazing hit that
    rounding places outside its chunk's eps-padded box would be skipped by
    the gate and flip that path. Measured on this seeded world at 64x32,
    spp 2, depth 8: no pixel differs and the segment counts are equal."""
    world = _dense_world()
    scene = compile_scene(world, spatial_sort=True)
    img, segs = _plain(world, scene, 64, 32, 2, 8, cfg)
    want, wsegs = _plain(world, scene, 64, 32, 2, 8, UNCULLED)
    assert torch.equal(img, want) and torch.equal(segs, wsegs)


@pytest.mark.parametrize("name", ["mesh", "mesh:1"])
def test_plain_mesh_matches_jax_integrator(name):
    jworld = jpresets.get_scene(name)
    jscene = jcompile(jworld, spatial_sort=True)
    assert jscene.tris.bvh is None
    want, segs = make_jnp(jworld.camera, 16, 8, 2, 4, sample_batch=2)(
        jscene, jrng.key_from_seed(0), 0)
    world, scene = _compiled(name)
    for cfg in (UNCULLED, KernelConfig()):  # the JAX oracle is ungated
        got, tsegs = _plain(world, scene, 16, 8, 2, 4, cfg)
        assert_render_close(got.numpy() / 2, np.asarray(want), float(tsegs.sum()),
                            float(segs))


def test_plain_mesh_matches_unfused_jax_integrator():
    """Op-by-op JAX (no FMA contraction): the same paths, segment for
    segment, on the 414-triangle mesh scene."""
    import jax

    jworld = jpresets.get_scene("mesh")
    jr = make_jnp(jworld.camera, 32, 16, 2, 8, sample_batch=2)
    with jax.disable_jit():
        want, segs = jr(jcompile(jworld, spatial_sort=True), jrng.key_from_seed(0), 0)
    world, scene = _compiled("mesh")
    got, tsegs = _plain(world, scene, 32, 16, 2, 8, KernelConfig())
    assert_render_close(got.numpy() / 2, np.asarray(want), float(tsegs.sum()), float(segs))
    assert float(tsegs.sum()) == float(segs)


def test_kernel_renderer_on_cpu_is_the_gated_plain_version():
    """For CPU tensors the kernel's frame renderer runs the plain version
    with the scene's gates, built once and reused across frames."""
    world, scene = _compiled("mesh")
    scene = scene._replace(cam=torch.from_numpy(pack_camera(world.camera, 24, 16)))
    render = ktrace.make_renderer(world.camera, 24, 16, 1, 6, sky=world.ambient,
                                  config=TWO_LEVEL)
    key = trng.key_from_seed(2)
    a, sa = render(scene, key, 0)
    b, sb = render(scene._replace(cam=scene.cam.clone()), key, 0)
    assert torch.equal(a, b) and float(sa) == float(sb)
    want, wsegs = _plain(world, scene, 24, 16, 1, 6, TWO_LEVEL, key=2)
    assert torch.equal(a, want) and float(sa) == float(wsegs.sum(dtype=torch.float64))
    tables_of = ktrace._TableCache(TWO_LEVEL)
    assert tables_of(scene) is tables_of(scene._replace(cam=None))


def test_adaptive_oracle_on_a_mesh_is_the_uniform_render():
    """The adaptive plain version with the gates renders a block's pixels as
    the uniform plain version does."""
    world, scene = _compiled("mesh")
    w, h = 64, 32
    cam = torch.from_numpy(pack_camera(world.camera, w, h))
    tables = ktrace.gate_tables(scene)
    key = trng.key_from_seed(3)
    sums, segs = ktrace.trace_adaptive(scene, cam, key, w, h, torch.tensor([0, 1]),
                                       torch.tensor([4, 4]), 2, 1, 6, 1e-3, 1e4,
                                       world.ambient, tables=tables)
    img, isegs = ktrace.trace_spheres(scene, cam, key, w, h, 0, h, 4, 2, 6, 1e-3, 1e4,
                                      world.ambient, tables=tables)
    assert torch.equal(sums[0, 0], img) and not sums[0, 1].any()
    assert torch.equal(segs[0], isegs)


# -- which tables a launch stages in shared memory (kernels.trace.stage_plan) --

H100_SMEM = 232_448  # a block's opt-in shared memory on an H100, bytes
DEFAULT = KernelConfig()


def _table_bytes(n_spheres, n_tris, cfg=DEFAULT):
    """(gate, sphere, triangle) table bytes of a scene of ``n_spheres``
    spheres and ``n_tris`` triangles, as ``gate_tables`` lays them out."""
    chunks = -(-max(0, n_spheres - ktrace.LEADERS) // cfg.CULL_CHUNK)
    slots = ktrace.LEADERS + chunks * cfg.CULL_CHUNK
    boxes = 0
    if cfg.cull_spheres(slots):
        boxes += chunks + (-(-chunks // cfg.SUPER) if chunks >= cfg.SUPER_MIN else 0)
    tri_slots = 0
    if n_tris:
        width = resolve_tri_chunk(cfg, n_tris)
        tchunks = -(-n_tris // width)
        tri_slots = tchunks * width
        if cfg.cull_triangles(tri_slots):
            boxes += tchunks + (-(-tchunks // cfg.SUPER) if tchunks >= cfg.SUPER_MIN else 0)
    return 24 * boxes, 4 * ktrace.TABLE_ROWS * slots, 4 * ktrace.TRI_ROWS * tri_slots


@pytest.mark.parametrize("sizes,limit,want", [
    ((100, 200, 300), 1000, (True, True, True, 600)),     # everything fits
    ((100, 200, 300), 599, (True, True, False, 300)),     # the triangle table does not
    ((100, 200, 300), 299, (True, False, False, 100)),    # nor the sphere table
    ((100, 200, 300), 99, (False, False, False, 0)),      # nothing does
    ((700, 200, 300), 600, (False, True, True, 500)),     # gates past the limit: global
    ((700, 200, 0), 600, (False, True, False, 200)),      # no triangles: nothing to stage
    ((0, 200, 300), 600, (False, True, True, 500)),       # no gates
    ((100, 600, 300), 600, (True, False, True, 400)),     # a later table may still fit
    ((600, 0, 0), 600, (True, False, False, 600)),        # exactly the limit fits
])
def test_stage_plan_stages_in_order_while_the_total_fits(sizes, limit, want):
    plan = ktrace.stage_plan(*sizes, limit)
    assert tuple(plan) == want and plan.smem_bytes <= limit
    staged = [b for b, on in zip(sizes, plan[:3]) if on]
    assert plan.smem_bytes == sum(staged)


@pytest.mark.parametrize("name,n_spheres,n_tris,gate_kb", [
    ("spheres:322", 414_737, 0, 227.9),  # the sphere field whose gates alone pass 227 KB
    ("mesh:7", 1, 409_614, 675.1),
])
def test_gates_past_the_limit_go_to_global_with_the_primitive_tables(name, n_spheres, n_tris,
                                                                      gate_kb):
    gate, sph, tri = _table_bytes(n_spheres, n_tris)
    assert gate / 1024 == pytest.approx(gate_kb, abs=0.1) and gate > H100_SMEM, name
    plan = ktrace.stage_plan(gate, sph, tri, H100_SMEM)
    assert plan.smem_bytes <= H100_SMEM
    if n_tris == 0:  # nothing fits: every table is read from global memory
        assert tuple(plan) == (False, False, False, 0)
    else:  # the one-sphere table (56 slots) still fits; gates and triangles do not
        assert tuple(plan) == (False, True, False, sph)


@pytest.mark.parametrize("name,n_spheres,n_tris,want", [
    ("final", 486, 0, (True, True, False)),
    ("spheres:100", 40_001, 0, (True, False, False)),
    ("mesh:5", 1, 25_614, (True, True, False)),
    ("mesh:3", 1, 1_280 + 2, (True, True, True)),
])
def test_tables_that_fit_are_staged(name, n_spheres, n_tris, want):
    plan = ktrace.stage_plan(*_table_bytes(n_spheres, n_tris), H100_SMEM)
    assert tuple(plan[:3]) == want, name
    assert 0 < plan.smem_bytes <= H100_SMEM


def test_stage_plan_never_passes_any_limit():
    rng = np.random.RandomState(0)
    for _ in range(500):
        sizes = [int(v) for v in rng.randint(0, 400_000, 3)]
        limit = int(rng.randint(0, 300_000))
        plan = ktrace.stage_plan(*sizes, limit)
        assert plan.smem_bytes <= limit
        assert plan.smem_bytes == sum(b for b, on in zip(sizes, plan[:3]) if on)


def test_staging_of_reads_the_scenes_tables_and_the_configs_limit():
    """``_table_bytes`` is the layout ``gate_tables`` builds, and a
    ``SMEM_LIMIT`` forces each route on a small scene."""
    world, scene = _compiled("mesh")
    base = ktrace.gate_tables(scene, TWO_LEVEL)
    sw = dict(zip(ktrace.SWEEP_FIELDS, base.sweep))
    gate = 4 * (base.boxes.numel() - 1)
    sph, tri = 4 * base.table.numel(), 4 * base.tri_table.numel()
    assert gate == 24 * (sw["n_chunks"] + sw["n_super"] + sw["tn_chunks"] + sw["tn_super"]) > 0
    assert base.smem_limit is None
    for limit, want in ((gate + sph + tri, (True, True, True)), (gate + sph, (True, True, False)),
                        (gate, (True, False, False)), (0, (False,) * 3)):
        tables = ktrace.gate_tables(scene, KernelConfig(
            **{**TWO_LEVEL.__dict__, "SMEM_LIMIT": limit}))
        assert tables.smem_limit == limit
        plan = ktrace.staging_of(tables, "cpu")
        assert tuple(plan[:3]) == want and plan.smem_bytes <= limit, limit
        assert torch.equal(tables.boxes, base.boxes)  # the limit changes no table
