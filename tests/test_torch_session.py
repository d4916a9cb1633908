"""The PyTorch port's session, checkpoints, dispatch and CLI."""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.render.session import _blend_chain as jblend
from myraytracer_tpu_torch import cli
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core import rng as trng
from myraytracer_tpu_torch.kernels import trace as ktrace
from myraytracer_tpu_torch.output.image import read_png
from myraytracer_tpu_torch.render import dispatch
from myraytracer_tpu_torch.render.lights import extract_lights
from myraytracer_tpu_torch.render.session import RenderSession, _blend_chain, fma_f32
from myraytracer_tpu_torch.scene import presets

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = RenderConfig(width=16, height=8, samples_per_frame=2, ray_depth=4, backend="torch")


@pytest.mark.parametrize("cap", [1.0, 0.9])
def test_blend_chain_bitwise_equal_to_jax(cap):
    """The session's weights for frames 0..5, on the same images."""
    rs = np.random.RandomState(0)
    fb = rs.random_sample((18, 32, 3)).astype(np.float32)
    imgs = rs.random_sample((6, 3, 18, 32)).astype(np.float32)
    w = np.asarray([min(cap, n / (n + 1)) if n else 0.0 for n in range(6)], np.float32)
    want = np.asarray(jblend(jnp.asarray(fb), jnp.asarray(imgs), jnp.asarray(w)))
    got = _blend_chain(torch.from_numpy(fb), torch.from_numpy(imgs), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fma_f32_is_xla_fused_multiply_add():
    """XLA's CPU backend fuses ``a*b + c`` into one rounding. An f64 sum
    rounded to f32 is not that: on the first input the exact sum lies just
    below an f32 midpoint, the f64 sum rounds onto the midpoint, and the
    f32 rounding then goes the wrong way. Round-to-odd keeps it right."""
    import jax

    rs = np.random.RandomState(1)
    a = np.concatenate([[2.0**-24 * (1 + 2.0**-23)], rs.standard_normal(4095)]).astype(np.float32)
    b = np.concatenate([[1 - 2.0**-23], rs.standard_normal(4095)]).astype(np.float32)
    c = np.concatenate([[1 + 2.0**-23], rs.standard_normal(4095)]).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)
    f64_sum = (a.astype(np.float64) * b + c).astype(np.float32)
    assert f64_sum[0] != want[0]


def test_checkpoint_resume_continues_the_stream(tmp_path):
    world = presets.defocus_scene()
    straight = dispatch.make_session(world, CFG)
    straight.run(3)

    first = dispatch.make_session(world, CFG)
    first.run(2)
    ck = tmp_path / "ck.npz"
    first.save_checkpoint(ck)
    resumed = dispatch.make_session(world, CFG)
    resumed.load_checkpoint(ck)
    assert (resumed.frame_count, resumed.sample_cursor) == (2, 4)
    resumed.run(1)
    assert torch.equal(resumed.framebuffer, straight.framebuffer)
    assert resumed.segments_traced == straight.segments_traced
    # The packed runtime camera is part of the state.
    assert torch.equal(resumed.scene.cam, straight.scene.cam)


def test_resume_refuses_other_backend_and_other_world(tmp_path):
    world = presets.reference_scene()
    s = dispatch.make_session(world, CFG)
    s.run(1)
    ck = tmp_path / "ck.npz"
    s.save_checkpoint(ck)
    # The same file, claiming the CUDA kernel produced it.
    with np.load(ck) as z:
        arrays = dict(z)
    arrays["meta"] = str(arrays["meta"]).replace('"backend": "torch"', '"backend": "cuda"')
    other = tmp_path / "cuda.npz"
    np.savez(other, **arrays)
    with pytest.raises(ValueError, match="backend"):
        dispatch.make_session(world, CFG).load_checkpoint(other)
    with pytest.raises(ValueError, match="fingerprint"):
        dispatch.make_session(presets.lambertian_sphere_scene(), CFG).load_checkpoint(ck)
    with pytest.raises(ValueError, match="ray_depth"):
        dispatch.make_session(world, CFG.replace(ray_depth=5)).load_checkpoint(ck)


def test_cursor_overflow_guard():
    s = RenderSession(presets.reference_scene(), CFG)
    s.sample_cursor = trng.M32 // trng.DRAWS_PER_SAMPLE
    with pytest.raises(RuntimeError, match="overflow"):
        s.step()


def test_set_camera_resets_accumulation():
    s = dispatch.make_session(presets.defocus_scene(), CFG)
    s.run(1)
    cam = presets.final_scene().camera
    s.set_camera(cam)
    assert s.frame_count == 0 and not s.framebuffer.any()
    assert s.sample_cursor == CFG.samples_per_frame  # the stream continues
    with pytest.raises(ValueError):
        dispatch.make_session(presets.reference_scene(), CFG).set_camera(cam)


def test_auto_backend_is_torch_without_a_gpu():
    """``auto`` is the card: without a GPU it raises and names ``torch``,
    which a caller asks for to render on the CPU."""
    if torch.cuda.is_available():
        s = dispatch.make_session(presets.reference_scene(), CFG.replace(backend="auto"))
        assert s.backend_resolved == "cuda" and s.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='--backend torch .backend="torch".'):
            dispatch.make_session(presets.reference_scene(), CFG.replace(backend="auto"))
    s = dispatch.make_session(presets.reference_scene(), CFG)
    assert s.backend_resolved == "torch" and s.device.type == "cpu"


def test_cli_writes_png(tmp_path):
    out = tmp_path / "cli.png"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "myraytracer_tpu_torch", "--backend", "torch",
         "--scene", "reference", "--width", "32", "--height", "18",
         "--frames", "2", "--ray-depth", "4", "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "Mrays/s=" in res.stderr and "frame=2 spp=2" in res.stderr
    img = read_png(out)
    assert img.shape == (18, 32, 3) and 0 < img.mean() < 255


def test_cli_backend_cuda_never_renders_on_the_cpu(tmp_path):
    out = tmp_path / "x.png"
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        cli.main(["--backend", "cuda", "--width", "8", "--height", "4",
                  "--out", str(out)])
    assert not out.exists()


def test_cli_rejects_unknown_scene():
    with pytest.raises(SystemExit):
        cli.main(["--scene", "nosuch", "--backend", "torch"])


@pytest.mark.parametrize("kw", [
    dict(ray_depth=trng.MAX_DEPTH + 1),
    dict(nee_lights=extract_lights(presets.light_scene())),
    dict(qmc=True),
    dict(rr=3),
    dict(texture_set=(1,)),
    dict(material_set=(1, 4)),
    # Image textures (K7) too.
    dict(texture_set=(3,)),
])
def test_cuda_renderer_refuses_unsupported_features(kw):
    """Nothing is refused now: paged depth, NEE, QMC, Russian roulette,
    emission and textures build a renderer (launching it needs a GPU)."""
    args = dict(cam=presets.reference_scene().camera, width=16, height=8,
                samples_per_frame=1, ray_depth=4)
    args.update(kw)
    assert callable(ktrace.make_renderer(**args))


# ``mesh`` renders since triangles were ported, ``cornell`` and ``light``
# since emission was, ``texture`` since textures were.
@pytest.mark.parametrize("name", ["cornell", "texture", "light"])
def test_sessions_refuse_unsupported_scenes(name):
    session = dispatch.make_session(presets.get_scene(name), CFG)
    assert torch.isfinite(session.step()).all()


@pytest.mark.parametrize("name", ["mesh", "final"])
def test_sessions_sort_and_fingerprint_as_the_jax_sessions(name):
    """Past 64 spheres or 64 triangles both packages' uniform and adaptive
    sessions compile the world spatially sorted (the order decides equal-t
    ties and the kernel's chunk boxes), and one world gives one checkpoint
    fingerprint."""
    from myraytracer_tpu.config import RenderConfig as JConfig
    from myraytracer_tpu.render.adaptive import AdaptiveSession as JAdaptive
    from myraytracer_tpu.render.session import RenderSession as JSession
    from myraytracer_tpu.render.session import scene_fingerprint as jfingerprint
    from myraytracer_tpu.scene import presets as jpresets
    from myraytracer_tpu.scene.compile import compile_scene as jcompile
    from myraytracer_tpu_torch.render.adaptive import AdaptiveSession
    from myraytracer_tpu_torch.render.session import scene_fingerprint, wants_spatial_sort

    jworld, world = jpresets.get_scene(name), presets.get_scene(name)
    assert wants_spatial_sort(world)
    sorted_fp = jfingerprint(jcompile(jworld, spatial_sort=True))
    assert sorted_fp != jfingerprint(jcompile(jworld, spatial_sort=False))
    jcfg = JConfig(width=16, height=8, samples_per_frame=1, ray_depth=2)
    for jsession in (JSession(jworld, jcfg), JAdaptive(jworld, jcfg)):
        assert jfingerprint(jsession.scene) == sorted_fp
    for session in (RenderSession(world, CFG), AdaptiveSession(world, CFG)):
        assert scene_fingerprint(session.scene) == sorted_fp


def test_default_entry_points_need_the_card(tmp_path):
    """With no backend named, a session and the CLI render on the card:
    without a GPU they raise and name ``torch``, and nothing renders on the
    CPU; ``backend="torch"`` renders there."""
    from myraytracer_tpu_torch.render.adaptive import AdaptiveSession

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: tests/test_torch_gpu.py holds the default there")
    world = presets.reference_scene()
    small = dict(width=8, height=4, ray_depth=2)
    for build in (lambda: RenderSession(world),
                  lambda: RenderSession(world, RenderConfig(**small)),
                  lambda: dispatch.make_session(world, RenderConfig()),
                  lambda: AdaptiveSession(world, RenderConfig(**small))):
        with pytest.raises(RuntimeError, match="--backend torch"):
            build()
    out = tmp_path / "x.png"
    with pytest.raises(RuntimeError, match="--backend torch"):
        cli.main(["--width", "8", "--height", "4", "--out", str(out)])
    assert not out.exists()
    s = RenderSession(world, RenderConfig(backend="torch", **small))
    assert s.backend_resolved == "torch" and s.device.type == "cpu"
    assert torch.isfinite(s.step()).all()


def test_myrt_backend_env_applies_only_at_auto(tmp_path, monkeypatch):
    """``MYRT_BACKEND`` as the JAX CLI reads it (cli.py:656-666): it picks
    the backend when the flag is left at auto, a bogus value exits, and an
    explicit flag wins."""
    argv = ["--width", "16", "--height", "8", "--ray-depth", "2", "--checkpoint",
            str(tmp_path / "c.npz"), "--out", str(tmp_path / "e.png")]
    monkeypatch.setenv("MYRT_BACKEND", "torch")
    assert cli.main(argv) == 0
    assert read_png(tmp_path / "e.png").shape == (8, 16, 3)
    with np.load(tmp_path / "c.npz") as z:
        assert '"backend": "torch"' in str(z["meta"])
    monkeypatch.setenv("MYRT_BACKEND", "bogus")
    with pytest.raises(SystemExit, match="MYRT_BACKEND"):
        cli.main(argv)
    assert cli.main(argv + ["--backend", "torch"]) == 0
    if not torch.cuda.is_available():
        monkeypatch.setenv("MYRT_BACKEND", "cuda")
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            cli.main(argv)
