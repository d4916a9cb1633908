"""Signature parity: the port takes every public callable of the JAX package
and every parameter of each.

For each module of ``myraytracer_tpu`` (the ``__main__`` modules left out:
importing them runs the CLI) and each public callable defined in it (a
function or a class; its signature, a class's ``__init__``'s or its
fields'), the same name in the port's module of the same path exists and
takes every JAX parameter by name, unless ``NO_COUNTERPART`` names it with
the reason. The port may take more (its own options, ``rng_mode`` in the
integrator, ``config`` in the kernels' factories). Each exclusion is
checked to be still needed, so the table cannot go stale.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import importlib
import inspect
import pkgutil

import pytest

import myraytracer_tpu

# (JAX module, callable) -> why the port has no such callable; (JAX module,
# callable, parameter) -> why the port's counterpart does not take it.
NO_COUNTERPART = {
    ("myraytracer_tpu.kernels.trace", "KernelConfig", "BLOCK_W"):
        "the TPU tile's pixel width; the port's adaptive block is fixed at 64x32 "
        "(render/adaptive.py BLOCK_W, BLOCK_H) and its queue tile is TILE_W",
    ("myraytracer_tpu.kernels.trace", "KernelConfig", "CHUNK_UNROLL_MAX"):
        "how many chunk gates the Pallas trace unrolls in Python before a fori_loop, "
        "a compile-time bound; the CUDA sweep loops over chunks",
    ("myraytracer_tpu.kernels.trace", "KernelConfig", "GATED_FETCH"):
        "per-chunk any() gates on the TPU's vector winner fetch; the port reads the "
        "winner's record once by index (or carries it: MERGED_FETCH)",
    ("myraytracer_tpu.kernels.trace", "KernelConfig", "SPH_VMEM"):
        "the sphere table's SMEM/VMEM placement on the TPU; the port stages tables by "
        "kernels.trace.stage_plan within SMEM_LIMIT",
    ("myraytracer_tpu.kernels.trace", "KernelConfig", "TRI_VMEM"):
        "the triangle table's SMEM/VMEM placement on the TPU; stage_plan as above",
    ("myraytracer_tpu.kernels.trace", "KernelConfig", "UNROLL_TOTAL_MAX"):
        "the primitive count past which Pallas chunk bodies become fori_loops, a "
        "compile-time bound with no CUDA counterpart",
    ("myraytracer_tpu.kernels.trace", "sph_table_rows"):
        "the TPU prefetch table's row count; the port's is kernels.trace.TABLE_ROWS, "
        "textures in a table of their own (TEX_ROWS)",
    ("myraytracer_tpu.kernels.trace", "tri_table_rows"):
        "as sph_table_rows: kernels.trace.TRI_ROWS",
    ("myraytracer_tpu.kernels.trace", "estimated_prefetch_bytes"):
        "the TPU's SMEM prefetch budget; the port's is kernels.trace.stage_plan and "
        "staging_of, against the card's opt-in shared memory",
    ("myraytracer_tpu.kernels.trace", "fits_in_smem"):
        "as estimated_prefetch_bytes: kernels.trace.stage_plan",
    ("myraytracer_tpu.kernels.trace", "make_block_renderer", "interpret"):
        "Pallas interpret mode; a CPU scene runs the plain version "
        "(kernels.trace.trace_spheres_plain), AdaptiveSession(interpret=True) the same",
    ("myraytracer_tpu.kernels.trace", "make_block_renderer", "tile_rows"):
        "the TPU grid's rows a tile; the port's queue tile is KernelConfig.TILE_W",
    ("myraytracer_tpu.kernels.trace", "make_block_renderer", "static_ior"):
        "an XLA trace-time constant for one-IOR scenes; the kernel reads the ior row",
    ("myraytracer_tpu.kernels.trace", "make_renderer", "interpret"):
        "as make_block_renderer's",
    ("myraytracer_tpu.kernels.trace", "make_renderer", "tile_rows"):
        "as make_block_renderer's",
    ("myraytracer_tpu.kernels.trace", "make_renderer", "static_ior"):
        "as make_block_renderer's",
    ("myraytracer_tpu.kernels.trace", "make_adaptive_renderer", "interpret"):
        "as make_block_renderer's",
    ("myraytracer_tpu.kernels.trace", "make_adaptive_renderer", "tile_rows"):
        "as make_block_renderer's; the adaptive block is fixed at 64x32",
    ("myraytracer_tpu.kernels.trace", "make_adaptive_renderer", "static_ior"):
        "as make_block_renderer's",
    ("myraytracer_tpu.native", "build_native"):
        "runs make on native/; the port links its copy of the sources with "
        "kernels.build.build_host at first use",
    ("myraytracer_tpu.native.cpu_backend", "auto_route"):
        "routes backend auto to the CPU on TPU hosts; the port's auto stays on the card "
        "and logs cpu_backend.route_verdict",
    ("myraytracer_tpu.parallel.sharding", "shard_map"):
        "a JAX version shim over jax.shard_map; the port's shards are one launch an "
        "entry of its Mesh",
    ("myraytracer_tpu.render.adaptive", "make_adaptive_oracle", "block_w"):
        "the port's blocks are fixed at BLOCK_W x BLOCK_H = 64x32, the JAX kernel's tile",
    ("myraytracer_tpu.render.adaptive", "make_adaptive_oracle", "block_h"):
        "the port's blocks are fixed at 64x32, as block_w",
    ("myraytracer_tpu.render.adaptive", "make_adaptive_oracle", "static_ior"):
        "an XLA trace-time constant; the plain version reads the ior row",
    ("myraytracer_tpu.render.integrator", "make_block_renderer", "static_ior"):
        "an XLA trace-time constant; the plain version reads the ior row",
    ("myraytracer_tpu.render.integrator", "make_renderer", "static_ior"):
        "as make_block_renderer's",
    ("myraytracer_tpu.render.camera", "rays_from_packed", "cam_ref"):
        "the same first positional parameter, named cam: a tensor, not a Pallas ref",
    ("myraytracer_tpu.render.materials", "scatter", "material_set"):
        "an XLA trace-time filter of the material families; the plain version "
        "evaluates every family",
    ("myraytracer_tpu.render.textures", "effective_albedo", "texture_set"):
        "an XLA trace-time filter of the texture families; every family is evaluated",
    ("myraytracer_tpu.render.textures", "apply_texture", "texture_set"):
        "as effective_albedo's",
    ("myraytracer_tpu.utils.cache", None):
        "JAX's persistent compile cache and exported renderers; the port's builds are "
        "cached by kernels/build.py, keyed by source, flags and compiler",
}


def _jax_modules():
    return sorted(m.name for m in pkgutil.walk_packages(myraytracer_tpu.__path__,
                                                       "myraytracer_tpu.")
                  if not m.name.endswith("__main__"))


def _port_name(name: str) -> str:
    return "myraytracer_tpu_torch" + name[len("myraytracer_tpu"):]


def _params(obj):
    """Parameter names a callable takes by name, and whether it takes any
    keyword (**kw); None where it has no signature."""
    try:
        ps = inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return None
    names = {n for n, p in ps.items() if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}
    return names, any(p.kind == p.VAR_KEYWORD for p in ps.values())


def _gaps(name: str):
    """The JAX module's callables and parameters that the port lacks."""
    jm = importlib.import_module(name)
    try:
        tm = importlib.import_module(_port_name(name))
    except ModuleNotFoundError:
        return [(name, None)]
    out = []
    for attr, obj in sorted(vars(jm).items()):
        if attr.startswith("_") or not callable(obj) or getattr(obj, "__module__", None) != name:
            continue
        if not hasattr(tm, attr):
            out.append((name, attr))
            continue
        want, got = _params(obj), _params(getattr(tm, attr))
        if want is None:
            continue
        if got is None:
            out.append((name, attr, "<signature>"))
            continue
        if not got[1]:
            out.extend((name, attr, p) for p in sorted(want[0] - got[0]))
    return out


@pytest.mark.parametrize("name", _jax_modules())
def test_port_takes_every_public_callable_and_parameter(name):
    missing = [g for g in _gaps(name) if g not in NO_COUNTERPART]
    assert not missing, f"the port lacks {missing} (or NO_COUNTERPART must say why)"


def test_every_exclusion_is_needed_and_has_a_reason():
    gaps = {g for name in _jax_modules() for g in _gaps(name)}
    assert set(NO_COUNTERPART) <= gaps, set(NO_COUNTERPART) - gaps
    assert all(reason.strip() for reason in NO_COUNTERPART.values())


def test_rng_mode_and_adaptive_session_take_the_jax_order():
    """The factories take ``rng_mode`` after ``material_set``, as JAX's do,
    and ``AdaptiveSession`` JAX's parameters in JAX's order."""
    from myraytracer_tpu.kernels import trace as jtrace
    from myraytracer_tpu.render import adaptive as jadaptive
    from myraytracer_tpu_torch.kernels import trace as ttrace
    from myraytracer_tpu_torch.render import adaptive as tadaptive

    for fn in ("make_block_renderer", "make_renderer", "make_adaptive_renderer"):
        j = list(inspect.signature(getattr(jtrace, fn)).parameters)
        t = list(inspect.signature(getattr(ttrace, fn)).parameters)
        assert inspect.signature(getattr(ttrace, fn)).parameters["rng_mode"].default == "threefry"
        assert t.index("rng_mode") == t.index("material_set") + 1
        assert j.index("rng_mode") == j.index("material_set") + 1
    j = list(inspect.signature(jadaptive.AdaptiveSession).parameters)
    t = list(inspect.signature(tadaptive.AdaptiveSession).parameters)
    assert t == j == ["world", "config", "n_sel", "renderer_factory", "interpret", "mesh"]
