"""The PyTorch port's scene API, presets and compiler against the JAX package.

Presets must build the same World, and ``compile_scene`` the same arrays
bit for bit (the sphere order decides equal-t ties, so the spatially sorted
path must match too).
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import dataclasses

import numpy as np
import pytest
import torch

from myraytracer_tpu.render.camera import pack_camera as jpack_camera
from myraytracer_tpu.render.session import scene_fingerprint as jfingerprint
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu.scene.compile import compile_scene as jcompile
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.render.session import RenderSession
from myraytracer_tpu_torch.render.session import scene_fingerprint as tfingerprint
from myraytracer_tpu_torch.scene import api as tapi
from myraytracer_tpu_torch.scene import presets as tpresets
from myraytracer_tpu_torch.scene.compile import (
    SCENE_LEAVES,
    compile_scene as tcompile,
    leaf,
    scene_from_numpy,
)


def _describe(obj):
    """A package-independent description of a scene value."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, tuple(
            (f.name, _describe(getattr(obj, f.name))) for f in dataclasses.fields(obj)
        ))
    if isinstance(obj, (tuple, list)):
        return tuple(_describe(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.shape, obj.tobytes())
    return obj


def jax_leaves(scene):
    """The JAX CompiledScene's sphere (and triangle) leaves as a dict of
    numpy arrays."""
    out = {name: np.asarray(leaf(scene, name)) for name in SCENE_LEAVES
           if leaf(scene, name) is not None}
    if scene.cam is not None:
        out["cam"] = np.asarray(scene.cam)
    return out


def port_leaves(scene):
    out = {name: leaf(scene, name).numpy() for name in SCENE_LEAVES
           if leaf(scene, name) is not None}
    if scene.cam is not None:
        out["cam"] = scene.cam.numpy()
    return out


@pytest.mark.parametrize("name", sorted(jpresets.SCENES) + ["spheres:3", "mesh:1"])
def test_presets_build_the_same_world(name):
    assert _describe(tpresets.get_scene(name)) == _describe(jpresets.get_scene(name))


@pytest.mark.parametrize("name,spatial_sort", [
    ("reference", False),
    ("lambertian", False),
    ("three-sphere", False),
    ("defocus", False),
    ("final", False),
    ("final", True),
    ("spheres:4", True),
    # Triangles: the kd centroid sort past 64 triangles, and the
    # fingerprint over the triangle leaves.
    ("mesh", False),
    ("mesh", True),
    ("mesh:1", False),
    ("mesh:1", True),
])
def test_compile_scene_bitwise(name, spatial_sort):
    want = jax_leaves(jcompile(jpresets.get_scene(name), spatial_sort=spatial_sort))
    scene = tcompile(tpresets.get_scene(name), spatial_sort=spatial_sort)
    got = port_leaves(scene)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # One world, one checkpoint fingerprint in both packages.
    assert tfingerprint(scene) == jfingerprint(
        jcompile(jpresets.get_scene(name), spatial_sort=spatial_sort)
    )


def test_pads_never_hit():
    scene = tcompile(tpresets.three_sphere_scene())
    assert scene.padded_size == 8
    assert (scene.radius_sq[5:] == -1).all() and (scene.mat_ty[5:] == 0).all()


def test_scene_from_numpy_round_trips_a_jax_scene():
    world = jpresets.defocus_scene()
    jscene = jcompile(world)._replace(cam=jpack_camera(world.camera, 64, 32))
    arrays = jax_leaves(jscene)
    scene = scene_from_numpy(arrays)
    assert scene.mat_ty.dtype == torch.int32 and scene.radius.dtype == torch.float32
    got = port_leaves(scene)
    for k in arrays:
        np.testing.assert_array_equal(got[k], arrays[k], err_msg=k)
    with pytest.raises(KeyError):
        scene_from_numpy({k: v for k, v in arrays.items() if k != "ior"})


@pytest.mark.parametrize("name", ["mesh", "cornell"])
def test_scene_from_numpy_round_trips_a_jax_mesh_scene(name):
    """The triangle leaves carry across too, and lacking one is an error."""
    arrays = jax_leaves(jcompile(jpresets.get_scene(name), spatial_sort=True))
    assert "tris.v0.x" in arrays
    scene = scene_from_numpy(arrays)
    assert scene.has_triangles and scene.tris.mat_ty.dtype == torch.int32
    got = port_leaves(scene)
    assert got.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(got[k], arrays[k], err_msg=k)
    with pytest.raises(KeyError):
        scene_from_numpy({k: v for k, v in arrays.items() if k != "tris.e2.y"})


@pytest.mark.parametrize("name", [
    "mesh",  # triangle meshes compile and render
    "cornell",  # quads with a DiffuseLight: emission renders too
    "texture",  # checker and marble compile and render
    "earth",  # so does an image texture
])
def test_unsupported_worlds_raise(name):
    """Every preset but ``obj`` compiles and renders now."""
    world = tpresets.get_scene(name)
    scene = tcompile(world)
    if world.meshes:
        assert scene.has_triangles and scene.tris.padded_size >= world.triangle_count
    if world.texture_set:
        assert scene.tex_ty is not None
        assert (scene.tex_image is not None) == (name == "earth")
    RenderSession(world, RenderConfig(width=8, height=8, ray_depth=2, backend="torch")).step()


def test_obj_scene_raises(tmp_path):
    """The obj preset loads files now: it raises on a missing file and on
    one without a triangle, as the JAX package's does."""
    with pytest.raises(FileNotFoundError):
        tpresets.obj_scene(tmp_path / "model.obj")
    (tmp_path / "points.obj").write_text("v 0 0 0\nv 1 0 0\n")
    with pytest.raises(ValueError, match="no triangles"):
        tpresets.obj_scene(tmp_path / "points.obj")
    with pytest.raises(ValueError, match="no triangles"):
        jpresets.obj_scene(tmp_path / "points.obj")


def test_api_rejects_negative_albedo():
    with pytest.raises(ValueError):
        tapi.Lambertian((-0.1, 0.2, 0.3))
