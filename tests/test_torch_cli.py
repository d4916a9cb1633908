"""The PyTorch port's CLI: adaptive sampling and frame batching."""

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
