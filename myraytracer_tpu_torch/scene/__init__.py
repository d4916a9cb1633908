from myraytracer_tpu_torch.scene.api import (
    Camera,
    Dielectric,
    Lambertian,
    Metal,
    Sphere,
    World,
)
from myraytracer_tpu_torch.scene.compile import CompiledScene, compile_scene

__all__ = [
    "Camera",
    "CompiledScene",
    "Dielectric",
    "Lambertian",
    "Metal",
    "Sphere",
    "World",
    "compile_scene",
]
