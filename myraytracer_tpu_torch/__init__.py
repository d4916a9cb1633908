"""myraytracer_tpu_torch — the progressive path tracer on PyTorch and CUDA.

The port of ``myraytracer_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA GPU. It mirrors the JAX package's layout and names; the hot loop is
a CUDA kernel written by hand for Hopper (``csrc/trace.cu``, bound in
``kernels/trace.py``), with a plain PyTorch version of it
(``render/integrator.py``) that runs on the CPU and serves as its oracle.

The package imports torch and numpy only; it never imports jax or the JAX
package.
"""

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.scene.api import (
    Camera,
    Dielectric,
    Lambertian,
    Metal,
    Sphere,
    World,
)
from myraytracer_tpu_torch.scene.compile import CompiledScene, compile_scene
from myraytracer_tpu_torch.render.session import RenderSession

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "CompiledScene",
    "Dielectric",
    "Lambertian",
    "Metal",
    "RenderConfig",
    "RenderSession",
    "Sphere",
    "World",
    "compile_scene",
    "__version__",
]
