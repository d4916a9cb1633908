"""What the quality A/B tools compute from their images and times.

Every tool (``adaptive_bench``, ``qmc_bench``, ``rr_bench``,
``denoise_bench``) scores an estimator by its RMSE against a high-spp
reference and turns RMSE ratios into sample counts with the Monte Carlo
law RMSE ~ 1/sqrt(n): these are the JAX tools' formulas
(``tools/adaptive_bench.py``, ``tools/qmc_bench.py``, ``tools/rr_bench.py``,
``tools/denoise_bench.py``), and the renders they score, built as a
session builds them. The measurement tools (``configs``, ``stream``,
``ladder``, ``meshscale``, ``cpu_mesh_baseline``, ``sort_probe``,
``orbit``) share the rest: the device line each prints first, the check
that a card is there, the host read that forces an image, and the guard
that refuses host syncs in a dispatch loop.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.render import dispatch
from myraytracer_tpu_torch.render.session import renderer_kwargs, session_scene
from myraytracer_tpu_torch.scene.presets import get_scene


def rmse(a, b) -> float:
    """Per-pixel root-mean-square difference of two images."""
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def equal_quality_spp(n, e_u, e) -> float:
    """Uniform samples a pixel needed to reach RMSE ``e``, from the uniform
    estimator's RMSE ``e_u`` at ``n`` samples: ``n (e_u / e)^2``."""
    return n * (e_u / max(e, 1e-12)) ** 2


def rr_win(t0, t1, e0, e1) -> float:
    """Russian roulette's equal-RMSE wall-clock win: its speed-up ``t0/t1``
    times the sample cost of its extra noise ``(e0/e1)^2``."""
    return (t0 / t1) * (e0 / e1) ** 2


def denoise_efficiency(r_raw, r_dn) -> float:
    """Samples the filter is worth, as a factor: ``(r_raw / r_dn)^2``."""
    return (r_raw / r_dn) ** 2


def denoise_wall_clock(spp, eff, t_spp, filter_s) -> float:
    """The filter's equal-quality wall-clock win: the raw estimator's
    seconds for ``spp * eff`` samples over the filtered one's for ``spp``
    samples and one filter pass, ``spp eff t_spp / (spp t_spp + filter_s)``;
    above 1, filtering reaches the quality sooner."""
    return spp * eff * t_spp / (spp * t_spp + filter_s)


def disp(a) -> np.ndarray:
    """Display-space encode (clip and the sRGB transfer) for the perceptual
    RMSE: linear RMSE over-weights bright emissive pixels that the display
    transform compresses anyway."""
    a = np.clip(np.asarray(a), 0.0, 1.0)
    lo = a * 12.92
    hi = 1.055 * np.power(np.maximum(a, 1e-8), 1.0 / 2.4) - 0.055
    return np.where(a <= 0.0031308, lo, hi)


def falls(errors) -> bool:
    """Whether a ladder's RMSEs fall strictly as samples rise."""
    return all(b < a for a, b in zip(errors, errors[1:]))


# -- Rendering for the tools --------------------------------------------------


def backend_name(name: str) -> str:
    """A tool's backend: the JAX tools' names map ``pallas`` -> ``cuda`` and
    ``jnp`` -> ``torch``."""
    backend = {"pallas": "cuda", "jnp": "torch"}.get(name, name)
    if backend not in ("cuda", "torch"):
        raise ValueError(f"backend {name!r}: use cuda (pallas) or torch (jnp)")
    return backend


def setup(scene_name: str, backend: str, width: int, height: int):
    """(world, compiled scene) as a session on ``backend`` builds them;
    ``cuda`` raises without a GPU."""
    dispatch.resolve_backend(RenderConfig(backend=backend))
    world = get_scene(scene_name, seed=0)
    return world, session_scene(world, backend, width, height)


def renderer(world, backend: str, width: int, height: int, spp: int, depth: int, **modes):
    """The frame renderer a session on ``backend`` builds (one frame a call);
    ``modes`` are RenderConfig's ``nee``, ``qmc`` and ``rr``."""
    config = RenderConfig(width=width, height=height, samples_per_frame=spp, ray_depth=depth,
                          backend=backend, frame_batch=1, **modes)
    factory = dispatch.renderer_factory(backend, world, config)
    return factory(world.camera, width, height, spp, depth, **renderer_kwargs(world, config))


def frame(render, scene, seed: int, sample_base: int = 0):
    """One call of ``render``: (image [H, W, 3] on the host, segments, its
    seconds). The host read of the image ends the timed call, so a launch's
    time is the card's work, not its enqueue."""
    t0 = time.perf_counter()
    img, segs = render(scene, crng.key_from_seed(seed), sample_base)
    out = img.cpu().numpy()
    return out, float(segs), time.perf_counter() - t0


def device_line(backend: str) -> str:
    """A tool's first line: the card's name and power limit as nvidia-smi
    gives them (``sweep.card``) on ``cuda``, else that the plain version
    runs on the CPU."""
    if backend == "cuda":
        from myraytracer_tpu_torch.sweep import card

        return card()
    return "cpu: the plain PyTorch version"


def card_missing(tool: str, backend: str = "cuda") -> bool:
    """Whether ``backend`` needs a CUDA GPU and there is none; if so, says
    it on stderr (a tool then exits non-zero with nothing on stdout)."""
    if backend == "cuda" and not torch.cuda.is_available():
        print(f"{tool}: no CUDA GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return True
    return False


def force(img: torch.Tensor) -> np.ndarray:
    """Wait for ``img`` by reading its last four values to the host: a tiny
    transfer, as the JAX tools force a frame."""
    return img.reshape(-1)[-4:].cpu().numpy()


@contextlib.contextmanager
def no_host_sync(backend: str):
    """On ``cuda``, a block in which a call that waits for the card raises
    (``torch.cuda.set_sync_debug_mode("error")``, which torch calls a
    prototype that may miss some syncs): a dispatch loop that synced the
    host would time one frame after another, not the pipelined loop. A
    no-op on the CPU."""
    if backend != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)
