"""Backend dispatch: choose the renderer factory for a config.

Two compute paths produce frames with the same semantics and the same
threefry sample stream:

* ``cuda``  — the hand-written CUDA kernel (kernels/trace.py) on the GPU;
* ``torch`` — the plain PyTorch integrator (render/integrator.py) on the CPU.

``auto`` resolves to ``cuda`` when ``torch.cuda.is_available()`` and to
``torch`` otherwise, and logs the choice. ``cuda`` never runs on the CPU:
without a GPU it raises. Every scene takes the backend it is given:
unlike the JAX package, which sends image-textured scenes to its jnp
integrator (its Pallas kernel has no per-lane gather), the CUDA kernel
renders them.
"""

from __future__ import annotations

import logging

import torch

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.render.session import RenderSession, resolve_device_backend
from myraytracer_tpu_torch.scene import api

log = logging.getLogger("myraytracer_tpu_torch")


def resolve_backend(config: RenderConfig) -> str:
    """The backend a config runs on: ``cuda`` or ``torch``."""
    backend = resolve_device_backend(config.backend)
    if config.backend == "auto":
        log.info(
            "backend auto -> %s (torch.cuda.is_available()=%s)",
            backend, torch.cuda.is_available(),
        )
    if backend == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "backend cuda needs a CUDA GPU, and torch.cuda.is_available() "
            "is False; use --backend torch to render on the CPU"
        )
    return backend


def renderer_factory(backend: str):
    """The ``make_renderer`` of a resolved backend."""
    if backend == "cuda":
        from myraytracer_tpu_torch.kernels.trace import make_renderer
    else:
        from myraytracer_tpu_torch.render.integrator import make_renderer
    return make_renderer


def make_session(world: api.World, config: RenderConfig) -> RenderSession:
    backend = resolve_backend(config)
    cfg = config.replace(backend=backend)
    return RenderSession(world, cfg, renderer_factory=renderer_factory(backend))
