"""The PyTorch port's CLI: adaptive sampling and frame batching."""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import json

import numpy as np
import pytest
import torch

from myraytracer_tpu_torch import cli
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.output.image import read_png
from myraytracer_tpu_torch.render.adaptive import AdaptiveSession
from myraytracer_tpu_torch.scene import presets

BASE = ["--backend", "torch", "--scene", "three-sphere", "--width", "128",
        "--height", "64", "--samples-per-frame", "2", "--ray-depth", "4"]


def test_cli_adaptive_writes_png_and_a_checkpoint_that_resumes(tmp_path, caplog):
    out, ck, ck2 = tmp_path / "a.png", tmp_path / "a.npz", tmp_path / "b.npz"
    with caplog.at_level("INFO", logger="myraytracer_tpu_torch"):
        assert cli.main(BASE + ["--adaptive", "1", "--frames", "4", "--checkpoint",
                                str(ck), "--out", str(out)]) == 0
    done = [r.getMessage() for r in caplog.records if "adaptive done" in r.getMessage()]
    assert done and "spp min/mean/max=" in done[0] and "Mrays/s=" in done[0]
    img = read_png(out)
    assert img.shape == (64, 128, 3) and 0 < img.mean() < 255
    with np.load(ck) as z:
        meta = json.loads(str(z["meta"]))
        spent = int(z["samples_spent"])
    assert meta["adaptive"] and meta["n_sel"] == 1 and meta["backend"] == "torch"
    assert spent <= 4 * 2 * 128 * 64

    # Resume for one more frame's budget: the continued session's state.
    assert cli.main(BASE + ["--adaptive", "1", "--frames", "1", "--resume", str(ck),
                            "--checkpoint", str(ck2), "--out", str(tmp_path / "b.png")]) == 0
    cfg = RenderConfig(width=128, height=64, samples_per_frame=2, ray_depth=4,
                       backend="torch", max_frames=1, frame_batch=meta["windows"])
    s = AdaptiveSession(presets.three_sphere_scene(), cfg, n_sel=1)
    s.load_checkpoint(ck)
    budget = s.samples_spent + 2 * 128 * 64
    while s.samples_spent + s.round_cost() <= budget:
        s.step()
    with np.load(ck2) as z:
        assert int(z["samples_spent"]) == s.samples_spent > spent
        np.testing.assert_array_equal(z["state0"], s._state[0].numpy())


def test_cli_frame_batch_steps(tmp_path):
    """An explicit --frame-batch renders whole batches (3 frames round up
    to 2 steps of 2) and checkpoints the frame count."""
    ck = tmp_path / "f.npz"
    assert cli.main(BASE + ["--frame-batch", "2", "--frames", "3", "--checkpoint",
                            str(ck), "--out", str(tmp_path / "f.png")]) == 0
    with np.load(ck) as z:
        assert (int(z["frame_count"]), int(z["sample_cursor"])) == (4, 8)


def test_cli_adaptive_cuda_never_renders_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = tmp_path / "x.png"
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        cli.main(["--backend", "cuda", "--adaptive", "--width", "64", "--height", "32",
                  "--out", str(out)])
    assert not out.exists()


# -- the output denoiser and the feature images, against the JAX CLI's files --

_SMALL = ["--scene", "three-sphere", "--width", "64", "--height", "32",
          "--samples-per-frame", "2", "--ray-depth", "4", "--frames", "2"]


def _both_clis(tmp_path, flags, suffix=".png"):
    """The port's CLI on the plain integrator and the JAX CLI on its jnp
    integrator with the same flags; returns both output paths."""
    from myraytracer_tpu import cli as jcli

    got, want = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
    assert cli.main(["--backend", "torch"] + _SMALL + flags + ["--out", str(got)]) == 0
    assert jcli.main(["--backend", "jnp"] + _SMALL + flags + ["--out", str(want)]) == 0
    return got, want


def _levels_apart(a, b):
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


@pytest.mark.parametrize("flags", [["--denoise"], ["--denoise", "2"], ["--denoise", "auto"]],
                         ids=["default", "2", "auto"])
def test_cli_denoise_writes_the_jax_clis_image(tmp_path, flags):
    """The denoised PNG against the JAX CLI's: the jitted JAX integrator
    contracts multiply-adds, so a u8 level may round the other way; at most
    one level apart on at most 2% of the values (measured: 0 to 0.3%)."""
    raw = tmp_path / "raw.png"
    assert cli.main(["--backend", "torch"] + _SMALL + ["--out", str(raw)]) == 0
    got, want = _both_clis(tmp_path, flags)
    a, b = read_png(got), read_png(want)
    assert a.shape == b.shape == (32, 64, 3)
    d = _levels_apart(a, b)
    assert d.max() <= 1 and (d > 0).mean() <= 0.02
    assert not np.array_equal(a, read_png(raw))  # the filter ran


def test_cli_denoise_keeps_checkpoints_raw(tmp_path):
    ck_a, ck_b = tmp_path / "a.npz", tmp_path / "b.npz"
    base = ["--backend", "torch"] + _SMALL
    assert cli.main(base + ["--out", str(tmp_path / "a.png"), "--checkpoint", str(ck_a)]) == 0
    assert cli.main(base + ["--denoise", "--out", str(tmp_path / "b.png"),
                            "--checkpoint", str(ck_b)]) == 0
    with np.load(ck_a) as a, np.load(ck_b) as b:
        np.testing.assert_array_equal(a["framebuffer"], b["framebuffer"])
    assert (tmp_path / "a.png").read_bytes() != (tmp_path / "b.png").read_bytes()


def test_cli_aov_writes_the_jax_clis_images(tmp_path):
    """``<stem>.<aov><ext>`` next to --out: u8 encodes within one level of
    the JAX CLI's, and the raw float sinks within a measured bar: the JAX
    CLI's feature pass runs jitted, where XLA contracts multiply-adds
    (measured: normals up to 3.1e-6 apart, held to atol 1e-5; depth held to
    rtol 2e-5)."""
    got, want = _both_clis(tmp_path, ["--aov", "albedo,normal,depth"])
    for name in ("albedo", "normal", "depth"):
        a = read_png(got.with_name(f"t.{name}.png"))
        b = read_png(want.with_name(f"j.{name}.png"))
        assert a.shape == (32, 64, 3) and _levels_apart(a, b).max() <= 1, name
        assert (a != b).mean() <= 0.01, name
    got, want = _both_clis(tmp_path, ["--aov", "normal,depth"], suffix=".npy")
    assert not got.with_name("t.albedo.npy").exists()
    np.testing.assert_allclose(np.load(got.with_name("t.normal.npy")),
                               np.load(want.with_name("j.normal.npy")), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.load(got.with_name("t.depth.npy")),
                               np.load(want.with_name("j.depth.npy")), rtol=2e-5, atol=0)


def test_cli_denoise_and_aov_compose_with_adaptive(tmp_path):
    out = tmp_path / "a.png"
    assert cli.main(BASE + ["--adaptive", "1", "--frames", "2", "--denoise", "auto", "--aov",
                            "depth", "--out", str(out)]) == 0
    assert read_png(out).shape == read_png(tmp_path / "a.depth.png").shape == (64, 128, 3)


def test_cli_rejects_bad_denoise_and_aov_values(tmp_path):
    out = tmp_path / "x.png"
    with pytest.raises(SystemExit):
        cli.main(BASE + ["--denoise", "-1", "--out", str(out)])
    with pytest.raises(SystemExit):
        cli.main(BASE + ["--denoise", "many", "--out", str(out)])
    with pytest.raises(SystemExit, match="unknown channel"):
        cli.main(BASE + ["--aov", "albedo,beauty", "--out", str(out)])
    assert not out.exists()


# -- sharding (--shard, --multihost) against the JAX CLI --------------------


@pytest.fixture
def eight_stripes(monkeypatch):
    """The port's default mesh as 8 CPU entries, as the JAX CLI's is its 8
    virtual CPU devices (tests/conftest.py)."""
    from myraytracer_tpu_torch.parallel import sharding

    default, hybrid, cpu8 = sharding.default_mesh, sharding.hybrid_mesh, ["cpu"] * 8
    monkeypatch.setattr(sharding, "default_mesh",
                        lambda devices=None, axis="tiles", device_type=None: default(cpu8, axis))
    monkeypatch.setattr(sharding, "hybrid_mesh",
                        lambda devices=None, samples=None, device_type=None: hybrid(cpu8, samples))


@pytest.mark.parametrize("mode", ["tiles", "samples", "hybrid"])
def test_cli_shard_writes_the_jax_clis_image(tmp_path, eight_stripes, mode):
    """``--shard M`` on 8 CPU entries against the JAX CLI's on its 8 CPU
    devices (raw .npy sinks): the bar the unsharded port meets against
    jitted JAX (``test_torch_trace.assert_render_close``); tile sharding is
    bitwise the port's unsharded CLI."""
    from test_torch_trace import assert_render_close

    got, want = _both_clis(tmp_path, ["--shard", mode], suffix=".npy")
    a, b = np.load(got), np.load(want)
    assert a.shape == b.shape == (32, 64, 3)
    assert_render_close(a, b, 1.0, 1.0)
    if mode == "tiles":
        plain = tmp_path / "plain.npy"
        assert cli.main(["--backend", "torch"] + _SMALL + ["--out", str(plain)]) == 0
        np.testing.assert_array_equal(a, np.load(plain))


@pytest.mark.parametrize("mode", ["samples", "hybrid"])
def test_cli_adaptive_refuses_sample_shards_as_the_jax_cli_does(tmp_path, mode):
    from myraytracer_tpu import cli as jcli

    flags = _SMALL + ["--adaptive", "--shard", mode, "--out", str(tmp_path / "x.png")]
    with pytest.raises(SystemExit) as mine:
        cli.main(["--backend", "torch"] + flags)
    with pytest.raises(SystemExit) as theirs:
        jcli.main(["--backend", "jnp"] + flags)
    assert str(mine.value) == str(theirs.value) == (
        f"--adaptive does not compose with --shard {mode} (tile stripes only)")


@pytest.mark.parametrize("extra, match", [
    (["--adaptive", "--multihost", "127.0.0.1:1,2,0"],
     "--adaptive does not compose with --multihost without --shard tiles"),
    (["--adaptive", "--shard", "tiles", "--multihost", "127.0.0.1:1,2,0", "--serve", "0"],
     r"--adaptive does not compose with --serve under --multihost \(the viewer is "
     r"single-process\)"),
    (["--serve", "0", "--multihost", "127.0.0.1:1,2,0"],
     "--serve is single-process; run the viewer without --multihost"),
    (["--scene", "defocus", "--serve", "0", "--interactive", "--shard", "tiles"],
     r"--interactive needs --serve, a general-mode \(positionable\) camera scene, and "
     r"--shard none"),
])
def test_cli_refuses_what_sharding_does_not_compose_with(tmp_path, extra, match):
    """The JAX CLI's messages; the --multihost refusals come before any
    process group is joined."""
    with pytest.raises(SystemExit, match=match):
        cli.main(["--backend", "torch"] + _SMALL + extra + ["--out", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


def test_cli_shard_refusals_of_the_session(tmp_path):
    out = str(tmp_path / "x.png")
    with pytest.raises(ValueError, match="frame_batch > 1 requires shard"):
        cli.main(["--backend", "torch"] + _SMALL + ["--shard", "samples", "--frame-batch", "2",
                                                    "--out", out])
    with pytest.raises(ValueError, match="--shard tiles"):
        cli.main(["--backend", "cpu", "--scene", "final", "--width", "32", "--height", "16",
                  "--shard", "tiles", "--out", out])
