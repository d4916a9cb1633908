"""Backend dispatch: choose the renderer factory for a config.

Two compute paths produce frames with the same semantics and the same
threefry sample stream:

* ``cuda``  — the hand-written CUDA kernel (kernels/trace.py) on the GPU;
* ``torch`` — the plain PyTorch integrator (render/integrator.py) on the CPU.

``auto`` means ``cuda``: the entry points run on the card unless the
caller asks for the CPU with ``torch``. Neither ``auto`` nor ``cuda`` runs
on the CPU: without a GPU they raise. Every scene takes the backend it is given:
unlike the JAX package, which sends image-textured scenes to its jnp
integrator (its Pallas kernel has no per-lane gather), the CUDA kernel
renders them.
"""

from __future__ import annotations

import torch

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.render.session import RenderSession, resolve_device_backend
from myraytracer_tpu_torch.scene import api

def resolve_backend(config: RenderConfig) -> str:
    """The backend a config runs on: ``cuda`` or ``torch``."""
    backend = resolve_device_backend(config.backend)
    if backend == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"backend {config.backend} renders on a CUDA GPU, and "
            "torch.cuda.is_available() is False; use --backend torch "
            '(backend="torch") to render on the CPU'
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
