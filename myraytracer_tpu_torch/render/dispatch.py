"""Backend dispatch: choose the renderer factory for a config.

Three compute paths produce frames with the same semantics:

* ``cuda``  — the hand-written CUDA kernel (kernels/trace.py) on the GPU;
* ``torch`` — the plain PyTorch integrator (render/integrator.py) on the CPU,
  with the same threefry sample stream as ``cuda``;
* ``cpu``   — the native C++ SAH-BVH renderer (native/cpu_backend.py), with
  its own mt19937 stream: images agree with the others statistically.

Sharding (``config.shard`` tiles, samples or hybrid) wraps ``cuda`` and
``torch`` over a device mesh (parallel/sharding.py); ``cpu`` refuses it.

``auto`` means ``cuda``: the entry points run on the card unless the caller
asks for the CPU with ``torch`` or ``cpu``. Neither ``auto`` nor ``cuda``
runs on the CPU: without a GPU they raise. Every scene takes the backend it
is given: unlike the JAX package, which sends image-textured scenes to its
jnp integrator (its Pallas kernel has no per-lane gather), the CUDA kernel
renders them; and unlike the JAX package's ``auto``, which sends a large
world to the CPU renderer where its routing model predicts a win, the
port's ``auto`` logs that model's verdict and stays on the card.
"""

from __future__ import annotations

import logging

import torch

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.render.session import RenderSession, resolve_device_backend
from myraytracer_tpu_torch.scene import api

log = logging.getLogger("myraytracer_tpu_torch")


def resolve_backend(config: RenderConfig) -> str:
    """The backend a config runs on: ``cuda``, ``torch`` or ``cpu``."""
    backend = resolve_device_backend(config.backend)
    if backend == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"backend {config.backend} renders on a CUDA GPU, and "
            "torch.cuda.is_available() is False; use --backend torch "
            '(backend="torch") to render on the CPU'
        )
    return backend


def renderer_factory(backend: str, world: api.World = None, config: RenderConfig = None):
    """The ``make_renderer`` of a resolved backend. ``cpu`` builds its
    factory from the world (its native scene dump) and raises on a world or
    config it cannot render."""
    if backend == "cpu":
        from myraytracer_tpu_torch.native import cpu_backend

        if world is None or config is None:
            raise ValueError("backend cpu builds its factory from the world and config; "
                             "use make_session")
        reason = cpu_backend.cpu_ineligibility(world, config)
        if reason is not None:
            raise ValueError(f"backend cpu does not support {reason}")
        return cpu_backend.make_cpu_factory(world)
    if backend == "cuda":
        from myraytracer_tpu_torch.kernels.trace import make_renderer
    else:
        from myraytracer_tpu_torch.render.integrator import make_renderer
    if config is not None and config.shard != "none":
        from myraytracer_tpu_torch.parallel.sharding import shard_renderer_factory

        return shard_renderer_factory(make_renderer, config.shard, block_factory=backend)
    return make_renderer


def make_session(world: api.World, config: RenderConfig) -> RenderSession:
    backend = resolve_backend(config)
    if config.backend == "auto":
        from myraytracer_tpu_torch.native import cpu_backend

        verdict = cpu_backend.route_verdict(world, config)
        if verdict is not None:
            log.info("%s", verdict)
    cfg = config.replace(backend=backend)
    return RenderSession(world, cfg, renderer_factory=renderer_factory(backend, world, cfg))
