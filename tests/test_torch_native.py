"""The PyTorch port's native host layer against the JAX package's.

The port builds its own copy of the C++ sources (``csrc/native``) into
``build/native/``; here, on the CPU, every output of that layer is held to
the JAX package's bit for bit: the BVH builder's arrays (native and the
Python fallback), the OBJ loader's (native and Python, malformed tokens
included), the scene dumps' bytes, the OBJ world (vertices to 0 ulp,
materials, camera), the compiled scene with its triangle BVH (every leaf and
the fingerprint) and the reference pool layout.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import logging
import subprocess

import numpy as np
import pytest

from myraytracer_tpu import native as jnative
from myraytracer_tpu.native import meshdump as jmeshdump
from myraytracer_tpu.render.session import scene_fingerprint as jfingerprint
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu.scene.compile import compile_reference_layout as jreference_layout
from myraytracer_tpu.scene.compile import compile_scene as jcompile
from myraytracer_tpu_torch import native
from myraytracer_tpu_torch.kernels import build as kbuild
from myraytracer_tpu_torch.native import meshdump
from myraytracer_tpu_torch.render.session import scene_fingerprint
from myraytracer_tpu_torch.scene import presets
from myraytracer_tpu_torch.scene.compile import (
    BVH_LEAVES, SCENE_LEAVES, compile_reference_layout, compile_scene, leaf,
)

from test_torch_scene import _describe
from textured_worlds import WORLDS as TEXTURED_WORLDS

OBJ_FILES = {
    # Index forms, a quad (fan) and negative (relative) indices.
    "forms": ("# comment\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
              "f 1 2 3\nf 1/2/3 2//1 4 3\nf -1 -2 -3\n"),
    # A vertex that does not parse, a face index with trailing junk, an
    # index out of range, tabs, a pentagon and a face before any vertex.
    "malformed": ("f 1 2 3\nv 0 0 0\nv 1 0 x\nv\t1 0 0\nv 0 1 0\nv 1 1 1e0\n"
                  "f 1 2 3a\nf\t1 2 9\nf 1 2 3 4 -1\nvt 0 0\nvn 0 0 1\n"),
}


def random_aabbs(n, seed):
    rng = np.random.RandomState(seed)
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    r = rng.uniform(0.1, 0.5, (n, 1)).astype(np.float32)
    return c - r, c + r


def ico_obj(path, subdivisions):
    """An icosphere written as OBJ text, as a user's file would hold it."""
    from myraytracer_tpu_torch.scene import meshgen

    v, f = meshgen.icosphere((0.3, -0.2, 0.1), 1.0, subdivisions)
    with open(path, "w") as fh:
        for x, y, z in v:
            fh.write(f"v {x} {y} {z}\n")
        for a, b, c in f:
            fh.write(f"f {a + 1} {b + 1} {c + 1}\n")
    return path


def test_native_library_builds_into_build_native():
    assert native.native_available(), native.native_error()
    path = native.library_path()
    assert path.parent == kbuild.NATIVE_BUILD_DIR
    assert path.name.startswith("libmrt_native_") and path.suffix == ".so"
    # The port keys its library by hash; the JAX package's file is its own.
    assert path != jnative._LIB_PATH


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 1), (200, 2), (1000, 3)])
@pytest.mark.parametrize("force_python", [False, True])
def test_build_bvh_equals_jax(n, seed, force_python):
    mn, mx = random_aabbs(n, seed)
    got = native.build_bvh(mn, mx, max_leaf=4, force_python=force_python)
    want = jnative.build_bvh(mn, mx, max_leaf=4, force_python=force_python)
    for field in native.FlatBVH._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("name", sorted(OBJ_FILES))
@pytest.mark.parametrize("force_python", [False, True])
def test_load_obj_equals_jax(tmp_path, name, force_python):
    p = tmp_path / f"{name}.obj"
    p.write_text(OBJ_FILES[name])
    v, t = native.load_obj(p, force_python=force_python)
    jv, jt = jnative.load_obj(p, force_python=force_python)
    assert v.dtype == jv.dtype and t.dtype == jt.dtype
    assert np.array_equal(v, jv) and np.array_equal(t, jt)
    # Native and Python agree with each other too.
    pv, pt = native.load_obj(p, force_python=not force_python)
    assert np.array_equal(v, pv) and np.array_equal(t, pt)


@pytest.mark.parametrize("force_python", [False, True])
def test_load_obj_missing_file(force_python):
    with pytest.raises(FileNotFoundError):
        native.load_obj("/nonexistent/file.obj", force_python=force_python)


def test_failed_build_is_not_silent(monkeypatch, caplog):
    """A library that does not build is logged with the compiler's error,
    reported unavailable, and the fallbacks take over."""
    def broken(*args, **kwargs):
        raise RuntimeError("g++ failed (1) building libmrt_native: error: boom")

    monkeypatch.setattr(kbuild, "build_host", broken)
    for name in ("_lib", "_lib_path", "_lib_error"):
        monkeypatch.setattr(native, name, None)
    with caplog.at_level(logging.WARNING, logger="myraytracer_tpu_torch.native"):
        assert not native.native_available()
    assert "boom" in native.native_error()
    assert any("boom" in r.getMessage() for r in caplog.records)
    mn, mx = random_aabbs(50, 0)
    got = native.build_bvh(mn, mx)
    want = jnative.build_bvh(mn, mx, force_python=True)
    assert np.array_equal(got.order, want.order)


def test_compiler_timeout_is_not_silent(tmp_path, monkeypatch, caplog):
    """A compiler that hangs while the build is keyed is logged and
    reported unavailable, as a failed build is, and the OBJ loader falls
    back to the Python parser."""
    def hung(cmd, **kwargs):
        raise subprocess.TimeoutExpired(cmd, kwargs.get("timeout"))

    monkeypatch.setattr(kbuild.subprocess, "run", hung)
    for name in ("_lib", "_lib_path", "_lib_error"):
        monkeypatch.setattr(native, name, None)
    with caplog.at_level(logging.WARNING, logger="myraytracer_tpu_torch.native"):
        assert not native.native_available()
    assert "timed out" in native.native_error()
    assert any("timed out" in r.getMessage() for r in caplog.records)
    p = tmp_path / "forms.obj"
    p.write_text(OBJ_FILES["forms"])
    v, t = native.load_obj(p)
    jv, jt = jnative.load_obj(p, force_python=True)
    assert np.array_equal(v, jv) and np.array_equal(t, jt)


def _mixed(pkg_presets, pkg_api):
    """A mesh over a ground sphere, with a glass sphere beside it."""
    mesh = pkg_presets.mesh_scene(subdivisions=2)
    return pkg_api.World(
        spheres=[pkg_api.Sphere((0.0, -1000.0, 0.0), 1000.0, pkg_api.Lambertian((0.5, 0.5, 0.5))),
                 pkg_api.Sphere((1.1, 0.35, 0.4), 0.35, pkg_api.Dielectric(1.5))],
        meshes=mesh.meshes, camera=mesh.camera)


def _dump_worlds(pkg_presets, pkg_api):
    return {
        "mixed": _mixed(pkg_presets, pkg_api),
        "textured": pkg_presets.get_scene("texture"),
        "textured-mesh": TEXTURED_WORLDS["textured-mesh"](pkg_api, pkg_presets),
        "spheres": pkg_presets.get_scene("spheres:4"),
        "mesh": pkg_presets.get_scene("mesh:1"),
    }


@pytest.mark.parametrize("name", ["mixed", "textured", "textured-mesh", "spheres", "mesh"])
def test_dump_scene_bytes_equal_jax(tmp_path, name):
    from myraytracer_tpu.scene import api as japi
    from myraytracer_tpu_torch.scene import api

    world = _dump_worlds(presets, api)[name]
    jworld = _dump_worlds(jpresets, japi)[name]
    n = meshdump.dump_scene(world, tmp_path / "t.bin")
    jn = jmeshdump.dump_scene(jworld, tmp_path / "j.bin")
    assert n == jn
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    if not world.spheres:
        meshdump.dump_world(world, tmp_path / "tw.bin")
        jmeshdump.dump_world(jworld, tmp_path / "jw.bin")
        assert (tmp_path / "tw.bin").read_bytes() == (tmp_path / "jw.bin").read_bytes()
    if not world.meshes:
        meshdump.dump_spheres(world, tmp_path / "ts.bin")
        jmeshdump.dump_spheres(jworld, tmp_path / "js.bin")
        assert (tmp_path / "ts.bin").read_bytes() == (tmp_path / "js.bin").read_bytes()


@pytest.mark.parametrize("ground_sphere", [False, True])
def test_obj_scene_equals_jax(tmp_path, ground_sphere):
    p = ico_obj(tmp_path / "ico.obj", 2)
    world = presets.obj_scene(p, ground_sphere=ground_sphere)
    jworld = jpresets.obj_scene(p, ground_sphere=ground_sphere)
    assert _describe(world) == _describe(jworld)  # vertices to 0 ulp, materials, camera
    assert bool(world.spheres) == ground_sphere
    assert world.triangle_count == 320 + (0 if ground_sphere else 2)


def test_obj_scene_rejects_an_empty_mesh(tmp_path):
    p = tmp_path / "empty.obj"
    p.write_text("v 0 0 0\n")
    with pytest.raises(ValueError, match="no triangles"):
        presets.obj_scene(p)


@pytest.mark.parametrize("name", ["mesh:3", "obj-ground"])
def test_compiled_triangle_bvh_equals_jax(tmp_path, name):
    """The BVH's leaves, the triangles in its order and the fingerprint."""
    if name == "obj-ground":
        p = ico_obj(tmp_path / "ico.obj", 3)
        world, jworld = (pkg.obj_scene(p, ground_sphere=True) for pkg in (presets, jpresets))
    else:
        world, jworld = presets.get_scene(name), jpresets.get_scene(name)
    scene = compile_scene(world, spatial_sort=True, triangle_bvh=True)
    jscene = jcompile(jworld, spatial_sort=True, triangle_bvh=True)
    assert scene.tris.bvh is not None
    for n in SCENE_LEAVES:
        a, b = leaf(scene, n), leaf(jscene, n)
        assert (a is None) == (b is None), n
        if a is not None:
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b), n
    assert all(leaf(scene, n) is not None for n in BVH_LEAVES)
    assert scene_fingerprint(scene) == jfingerprint(jscene)


@pytest.mark.parametrize("name", ["final", "three-sphere", "texture", "reference"])
def test_compile_reference_layout_equals_jax(name):
    got = compile_reference_layout(presets.get_scene(name))
    want = jreference_layout(jpresets.get_scene(name))
    assert got["world"] == want["world"]
    for k in ("vec4_f32_data", "f32_data", "i32_data"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
