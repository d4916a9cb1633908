"""The PyTorch port's native CPU backend (``--backend cpu``) and routing model.

Held to the JAX package's ``--backend cpu`` bit for bit: the same world,
seed, sample start and camera give the same image and segment count, at 1
and at 4 threads, frame after frame, also after an orbit; the CLI's PNG
(``--obj F --ground --backend cpu``) is JAX's CLI's byte for byte. And the
port's own rules: the routing model is continuous in each kind's count (no
step at 64), a ground sphere under a mesh costs about what the mesh does,
``auto`` renders on the card whatever the model predicts (it logs the
verdict), ``--backend cpu`` refuses what it cannot render, and adaptive
sampling refuses the backend.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import logging

import numpy as np
import pytest
import torch

from myraytracer_tpu import cli as jcli
from myraytracer_tpu.config import RenderConfig as JRenderConfig
from myraytracer_tpu.render.dispatch import make_session as jmake_session
from myraytracer_tpu.scene import api as japi
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu_torch import cli
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.native import cpu_backend
from myraytracer_tpu_torch.render import dispatch
from myraytracer_tpu_torch.render.camera import orbit_camera
from myraytracer_tpu_torch.render.dispatch import make_session
from myraytracer_tpu_torch.render.session import RenderSession
from myraytracer_tpu_torch.scene import api, presets

from test_torch_native import _mixed, ico_obj

CFG = dict(width=32, height=24, samples_per_frame=2, ray_depth=4, backend="cpu")


def _worlds(pkg_presets, pkg_api):
    return {"mixed": _mixed(pkg_presets, pkg_api), "texture": pkg_presets.get_scene("texture"),
            "spheres:6": pkg_presets.get_scene("spheres:6")}


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("name", ["mixed", "texture", "spheres:6"])
def test_cpu_backend_is_jax_bit_for_bit(monkeypatch, name, threads):
    monkeypatch.setenv("MYRT_CPU_THREADS", threads)
    session = make_session(_worlds(presets, api)[name], RenderConfig(seed=3, **CFG))
    jsession = jmake_session(_worlds(jpresets, japi)[name], JRenderConfig(seed=3, **CFG))
    assert session.backend_resolved == jsession.backend_resolved == "cpu"
    for frame in range(3):
        if frame == 2:  # an orbit: the packed runtime camera
            cam = orbit_camera(session.world.camera, 0.4, 0.1, 1.1)
            session.set_camera(cam)
            jsession.set_camera(japi.Camera(**{f: getattr(cam, f) for f in (
                "lookfrom", "lookat", "vup", "vfov_degrees", "aperture", "focus_dist")}))
        got, want = session.step(), jsession.step()
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(want)), frame
        assert session.segments_traced == jsession.segments_traced
    assert session.scene_fingerprint == jsession.scene_fingerprint


def test_cli_obj_ground_cpu_png_is_jax_byte_for_byte(tmp_path):
    p = ico_obj(tmp_path / "ico.obj", 2)
    argv = ["--width", "32", "--height", "24", "--samples-per-frame", "2", "--ray-depth", "4",
            "--frames", "2", "--obj", str(p), "--ground", "--backend", "cpu"]
    assert cli.main(argv + ["--out", str(tmp_path / "t.png")]) == 0
    assert jcli.main(argv + ["--out", str(tmp_path / "j.png")]) == 0
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_cli_obj_on_the_torch_backend_and_ground_alone_exits(tmp_path, monkeypatch):
    from myraytracer_tpu_torch.output.image import read_png

    p = ico_obj(tmp_path / "ico.obj", 1)
    out = tmp_path / "o.png"
    for flags in (["--backend", "torch"], ["--ground", "--backend", "torch"]):
        assert cli.main(["--width", "24", "--height", "16", "--ray-depth", "3", "--obj", str(p),
                         *flags, "--out", str(out)]) == 0
        img = read_png(out)
        assert img.shape == (16, 24, 3) and img.mean() > 10
    monkeypatch.setenv("MYRT_BACKEND", "cpu")
    assert cli.main(["--width", "24", "--height", "16", "--ray-depth", "3", "--obj", str(p),
                     "--out", str(out)]) == 0
    with pytest.raises(SystemExit):
        cli.main(["--ground", "--backend", "torch", "--out", str(out)])


def _mesh_plus(n_spheres, n_tris_sub=5):
    mesh = presets.mesh_scene(n_tris_sub)
    field = [api.Sphere((0.0, -1000.0, 0.0), 1000.0, api.Lambertian((0.5, 0.5, 0.5)))]
    field += [api.Sphere((0.1 * i, 0.2, -3.0), 0.05, api.Lambertian((0.5, 0.5, 0.5)))
              for i in range(n_spheres - 1)]
    return api.World(spheres=field, meshes=mesh.meshes, camera=mesh.camera)


def _spheres_plus(n_tris):
    from myraytracer_tpu_torch.scene import meshgen

    field = presets.get_scene("spheres:20")
    v, f = meshgen.icosphere((0.0, 1.0, 0.0), 0.5, 3)
    mesh = api.Mesh(v, f[:n_tris], api.Lambertian((0.3, 0.3, 0.3)))
    return api.World(spheres=field.spheres, meshes=[mesh], camera=field.camera)


@pytest.mark.parametrize("kind", ["spheres", "triangles"])
def test_routing_model_is_continuous_across_64(monkeypatch, kind):
    monkeypatch.setenv("MYRT_CPU_THREADS", "32")
    cfg = RenderConfig()
    world = _mesh_plus if kind == "spheres" else _spheres_plus
    p63, p64 = (cpu_backend.route_prediction(world(n), cfg) for n in (63, 64))
    for a, b in zip(p63, p64):
        assert abs(a - b) <= 0.01 * b, (p63, p64)


def test_one_ground_sphere_costs_about_what_the_mesh_does(monkeypatch):
    monkeypatch.setenv("MYRT_CPU_THREADS", "32")
    cfg = RenderConfig()
    mesh = presets.mesh_scene(6)
    alone = cpu_backend.route_prediction(mesh, cfg)
    mixed = cpu_backend.route_prediction(_mesh_plus(1, 6), cfg)
    for a, b in zip(alone, mixed):
        assert abs(a - b) <= 0.03 * a, (alone, mixed)


def test_auto_never_routes_to_cpu(monkeypatch, caplog):
    """Even on a host whose cores the model says out-render the card, auto
    builds a cuda session and logs the verdict naming --backend cpu."""
    monkeypatch.setenv("MYRT_CPU_THREADS", "4096")
    world = presets.mesh_scene(6)
    cpu, cuda = cpu_backend.route_prediction(world, RenderConfig())
    assert cpu > cuda
    built = {}

    class Recorder:
        def __init__(self, world, config, renderer_factory=None):
            built["backend"], built["factory"] = config.backend, renderer_factory

    monkeypatch.setattr(dispatch.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dispatch, "RenderSession", Recorder)
    with caplog.at_level(logging.INFO, logger="myraytracer_tpu_torch"):
        session = make_session(world, RenderConfig())
    assert built["backend"] == "cuda" and not hasattr(session, "routing_prediction")
    from myraytracer_tpu_torch.kernels.trace import make_renderer

    assert built["factory"] is make_renderer
    assert any("--backend cpu" in r.getMessage() for r in caplog.records)
    # Without a GPU, auto raises: it never lands on a CPU path.
    monkeypatch.setattr(dispatch.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        make_session(world, RenderConfig())


def test_cpu_session_carries_its_prediction_and_provenance(tmp_path):
    world = presets.get_scene("spheres:6")
    session = make_session(world, RenderConfig(**CFG))
    assert session.routing_prediction == cpu_backend.route_prediction(world, session.config)[0]
    # A session built without dispatch carries the same prediction.
    assert RenderSession(world, RenderConfig(**CFG)).routing_prediction == session.routing_prediction
    assert RenderSession(world, RenderConfig(**{**CFG, "backend": "torch"})).routing_prediction is None
    session.step()
    session.save_checkpoint(tmp_path / "c.npz")
    again = make_session(world, RenderConfig(**CFG))
    again.load_checkpoint(tmp_path / "c.npz")
    assert again.frame_count == 1
    other = make_session(world, RenderConfig(**{**CFG, "backend": "torch"}))
    with pytest.raises(ValueError, match="backend"):
        other.load_checkpoint(tmp_path / "c.npz")


def test_cpu_rejects_what_it_cannot_render():
    from myraytracer_tpu_torch.render.adaptive import AdaptiveSession

    world = presets.get_scene("spheres:6")
    cfg = RenderConfig(**CFG)
    for bad, match in ((cfg.replace(nee=True), "nee"), (cfg.replace(qmc=True), "qmc"),
                       (cfg.replace(rr=4), "rr"), (cfg.replace(shard="tiles"), "shard"),
                       (cfg.replace(frame_batch=4), "frame")):
        with pytest.raises(ValueError, match=match):
            make_session(world, bad)
    with pytest.raises(ValueError, match="reference|camera"):
        make_session(presets.reference_scene(), cfg)
    with pytest.raises(ValueError, match="image|bitmap"):
        make_session(presets.get_scene("earth"), cfg)
    with pytest.raises(ValueError, match="adaptive"):
        AdaptiveSession(world, cfg)


def test_routing_prediction_check(caplog):
    """The first sync arms the check; the next warns on a miss past 3x or
    logs a hit, and disarms it."""
    class S:
        routing_prediction = 100.0

    with caplog.at_level(logging.INFO, logger="myraytracer_tpu_torch"):
        assert cli._check_routing_prediction(S, 1.0) is None
        assert cli._check_routing_prediction(S, 1.0) is False
        assert S.routing_prediction is None
        S.routing_prediction, S._route_check_armed = 10.0, False
        cli._check_routing_prediction(S, 5.0)
        assert cli._check_routing_prediction(S, 5.0) is True
    msgs = [r.getMessage() for r in caplog.records]
    assert any("mispredicted" in m and "H100" in m for m in msgs)
    assert any("holds" in m for m in msgs)
