"""The native CPU render backend (``--backend cpu``).

Port of ``myraytracer_tpu.native.cpu_backend``: the C++ binned-SAH BVH
path tracer (``csrc/native/cpu_renderer.cpp``, built by
``myraytracer_tpu_torch.native``) as a session backend. The C side renders
one frame of ``spp`` samples a call (``mrt_cpu_render``) from a scene
dumped once (``meshdump.dump_scene``, the "MRTMIX01" format), with
per-row splitmix64-seeded mt19937 streams (deterministic, whatever the
thread count) and the session's packed [19]-f32 runtime camera, so orbits
need no reload. Its sample stream is mt19937, not the threefry stream of
the ``cuda`` and ``torch`` backends: images agree with theirs
statistically, never bitwise, and a checkpoint records ``cpu`` as its
backend. The same world, seed, sample start and camera give JAX's
``--backend cpu`` image bit for bit.

Scope, as in JAX: sphere, mesh and mixed worlds, checker and marble
textures, general (lookfrom/lookat) cameras, the default estimator (no
NEE, QMC or Russian roulette), no image textures, one frame a call.

Routing: ``route_prediction`` models the CPU renderer's and the CUDA
kernel's throughput on a world from rates measured on an NVIDIA H100 and
its host (below). Unlike the JAX package, whose ``auto`` sends a world to
the CPU where the model predicts a win, the port's ``auto`` always renders
on the card: ``render.dispatch`` logs the verdict and names ``--backend
cpu`` when the CPU is predicted to win, and ``--backend cpu`` is the
request.
"""

from __future__ import annotations

import ctypes
import math
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from myraytracer_tpu_torch import native
from myraytracer_tpu_torch.scene import api

def cpu_available() -> bool:
    return native.native_available()


def cpu_threads() -> int:
    """Worker threads for the native renderer: ``MYRT_CPU_THREADS``, else 0
    (every core the host has, ``hardware_concurrency`` C-side)."""
    env = os.environ.get("MYRT_CPU_THREADS", "").strip()
    if env:
        return max(1, int(env))
    return 0


def host_cores() -> int:
    """The threads a frame runs on: ``MYRT_CPU_THREADS``, else the host's
    cores."""
    return cpu_threads() or (os.cpu_count() or 1)


def cpu_ineligibility(world: api.World, config, need_library: bool = True) -> Optional[str]:
    """Why ``world``/``config`` cannot render on the native CPU backend
    (None = eligible). ``--backend cpu`` raises it. ``need_library=False``
    leaves out the library's availability (the routing model needs no
    build)."""
    if not world.spheres and not world.meshes:
        return "empty world"
    if api.TEXTURE_IMAGE in world.texture_set:
        return "image textures (no C-side bitmap sampler; cuda and torch serve them)"
    if world.camera.reference_mode:
        return "the fixed reference-mode camera (general cameras only)"
    if config.nee:
        return "--nee (the MIS shadow-ray estimator runs on cuda and torch only)"
    if config.qmc:
        return "--qmc (the Owen-Sobol camera stream runs on cuda and torch only)"
    if config.rr:
        return "--rr (Russian roulette runs on cuda and torch only)"
    if config.shard != "none":
        return f"--shard {config.shard} (the CPU backend is single-host)"
    if config.frame_batch > 1:
        return "--frame-batch > 1 (a kernel launch window)"
    if need_library and not cpu_available():
        return f"the native library is unavailable ({native.native_error()})"
    return None


# -- Throughput models --------------------------------------------------------
#
# Mrays/s against primitive count, interpolated log-log between measured
# anchors and clamped at the ends. Measured by
# ``python -m myraytracer_tpu_torch.native.anchors`` at 1200x800, depth 50,
# on "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi name, power.limit) and
# its host (8 x86_64 cores, model unnamed): the CUDA kernel at spp 4
# (one launch, the median of three, CUDA events) and the C++ renderer at spp
# 1 (one frame on all 8 cores, the median of three, per core). Triangles:
# one ground triangle, then mesh:1 ... mesh:7; spheres: one ground sphere,
# then spheres:1, 2, 5, 10, 20, 50, 100, 200, 330.
_CUDA_MESH = [(1, 2388.4), (174, 773.4), (414, 539.6), (1614, 399.1), (6414, 269.6),
              (25614, 296.9), (102414, 168.7), (409614, 66.3)]
_CUDA_SPH = [(1, 12588.6), (8, 8973.5), (20, 3285.3), (102, 2925.4), (400, 1580.0),
             (1601, 1473.7), (10002, 1060.5), (40001, 703.3), (160003, 353.2),
             (435601, 131.6)]
_CPU_MESH = [(1, 7.422), (174, 3.325), (414, 3.127), (1614, 2.5), (6414, 2.306),
             (25614, 2.222), (102414, 1.789), (409614, 1.722)]
_CPU_SPH = [(1, 11.625), (8, 8.376), (20, 6.035), (102, 3.769), (400, 3.014), (1601, 2.829),
            (10002, 2.193), (40001, 1.773), (160003, 1.618), (435601, 1.605)]
# Where the anchors were measured, for the routing check's message.
ANCHORED_ON = "NVIDIA H100 80GB HBM3, 700.00 W, and its 8-core host"


def _rate(points, n: int) -> float:
    xs = np.log([p[0] for p in points])
    ys = np.log([p[1] for p in points])
    return float(math.exp(np.interp(math.log(max(n, 1)), xs, ys)))


def _ray_cost(mesh_points, sph_points, n_tris: int, n_sph: int) -> float:
    """Seconds per million rays of a world with ``n_tris`` triangles and
    ``n_sph`` spheres. A kind's anchors price a ray in a world of that kind
    alone, which holds the work every ray does whatever it hits (its
    camera ray, its shading): a mixed world pays both kinds' costs less
    that shared part, taken as the cheaper of the two one-primitive
    worlds. The cost is continuous in each count, and a world of one mesh
    and one ground sphere costs about what the mesh alone does. This rule
    for mixed worlds is a guess: it has been held to a measurement on one
    world only, the 81,920-triangle OBJ mesh on the ground sphere."""
    terms = []
    if n_tris:
        terms.append(1.0 / _rate(mesh_points, n_tris))
    if n_sph:
        terms.append(1.0 / _rate(sph_points, n_sph))
    if len(terms) < 2:
        return terms[0]
    shared = min(1.0 / _rate(mesh_points, 1), 1.0 / _rate(sph_points, 1))
    return max(sum(terms) - shared, max(terms))


def route_prediction(world: api.World, config) -> Optional[Tuple[float, float]]:
    """Predicted ``(cpu_total, cuda)`` throughput in Mrays/s for a world the
    CPU backend can render, else None: the C++ renderer on
    ``host_cores()`` cores, and the CUDA kernel on the card."""
    if cpu_ineligibility(world, config, need_library=False) is not None:
        return None
    n_tris, n_sph = world.triangle_count, len(world.spheres)
    cpu = host_cores() / _ray_cost(_CPU_MESH, _CPU_SPH, n_tris, n_sph)
    cuda = 1.0 / _ray_cost(_CUDA_MESH, _CUDA_SPH, n_tris, n_sph)
    return cpu, cuda


def route_verdict(world: api.World, config) -> Optional[str]:
    """The routing model's verdict on a world, as a log line (None when the
    CPU backend cannot render it). The port renders on the card under
    ``auto`` whatever it says."""
    pred = route_prediction(world, config)
    if pred is None:
        return None
    cpu, cuda = pred
    prims = f"{world.triangle_count} triangles, {len(world.spheres)} spheres"
    if cpu > cuda:
        return (f"routing model: --backend cpu predicted faster for this world ({prims}): "
                f"{cpu:.1f} Mrays/s on {host_cores()} cores vs {cuda:.1f} on the CUDA kernel "
                f"(anchors measured on {ANCHORED_ON}); auto "
                f"renders on the card: pass --backend cpu to use the CPU")
    return (f"routing model: the CUDA kernel predicted faster for this world ({prims}): "
            f"{cuda:.1f} Mrays/s vs {cpu:.1f} on {host_cores()} CPU cores")


# -- Renderer factory (RenderSession contract) --------------------------------


class _CpuScene:
    """Owns the native scene handle for a renderer's lifetime."""

    def __init__(self, world: api.World):
        from myraytracer_tpu_torch.native import meshdump

        lib = native.load_library()
        if lib is None:
            raise RuntimeError(f"the native library is unavailable ({native.native_error()})")
        fd, path = tempfile.mkstemp(suffix=".mrtscene")
        os.close(fd)
        try:
            meshdump.dump_scene(world, path)
            self._handle = lib.mrt_cpu_scene_load(path.encode())
        finally:
            os.unlink(path)
        if not self._handle:
            raise RuntimeError("native CPU scene load failed")
        self._lib = lib

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.mrt_cpu_scene_free(handle)
            self._handle = None


def frame_seed(key, sample_start: int) -> int:
    """The C renderer's 64-bit frame seed: the key's two words, with the
    sample cursor folded in by an odd-constant multiply (JAX
    ``cpu_backend.py:300-310``; ``mix64`` finalizes it per row C-side)."""
    seed64 = (int(key[0]) << 32) | int(key[1])
    return (seed64 ^ (int(sample_start) * 0x9E3779B97F4A7C15)) & ((1 << 64) - 1)


def make_cpu_factory(world: api.World, threads: int = 0):
    """Renderer factory over ``world`` with the session factory signature
    ``factory(cam, width, height, spp, depth, **render_kwargs)``; a frame
    runs on ``threads`` threads (0: ``cpu_threads()``).

    The renderer is ``fn(scene, key, sample_start) -> (img, segs)``, as the
    other backends' are: ``img`` the [H, W, 3] f32 per-pixel mean and
    ``segs`` the traced segment count (f64), both CPU tensors. ``scene``
    supplies only the packed runtime camera (``scene.cam``); the geometry
    was dumped when the factory built the renderer.
    """
    if not world.spheres and not world.meshes:
        raise ValueError("backend cpu does not support empty worlds")
    if api.TEXTURE_IMAGE in world.texture_set:
        raise ValueError(
            "backend cpu has no bitmap sampler; render image-textured "
            "scenes on the cuda or torch backend"
        )

    def factory(
        cam,
        width: int,
        height: int,
        samples_per_frame: int,
        ray_depth: int,
        *,
        t_min: float = 1e-3,
        t_max: float = 1e4,
        frames: int = 1,
        nee_lights=None,
        qmc: bool = False,
        rr: int = 0,
        sample_batch: int = 0,
        material_set=None,
        sky=None,
        texture_set=None,
    ):
        # The dump carries the materials, sky and texture rows itself.
        del sample_batch, material_set, sky, texture_set
        unsupported = [name for name, on in (("frames > 1", frames > 1),
                                             ("nee", nee_lights is not None),
                                             ("qmc", qmc), ("rr", rr)) if on]
        if unsupported:
            raise ValueError(
                f"backend cpu does not support {unsupported} (nee, qmc, rr and "
                f"frame batching run on cuda and torch)"
            )
        if cam.reference_mode:
            raise ValueError("backend cpu needs a general (lookfrom/lookat) camera")
        native_scene = _CpuScene(world)
        lib = native_scene._lib
        n_threads = threads or cpu_threads()

        def render(scene, key, sample_start):
            cam_ptr, cam19 = None, None
            if getattr(scene, "cam", None) is not None:
                cam19 = np.ascontiguousarray(scene.cam.detach().cpu().numpy(), np.float32)
                if cam19.shape != (19,):
                    raise ValueError(f"packed camera shape {cam19.shape}")
                cam_ptr = cam19.ctypes.data_as(ctypes.c_void_p)
            out = np.empty((height, width, 3), np.float32)
            segs = ctypes.c_double(0.0)
            rc = lib.mrt_cpu_render(
                native_scene._handle, width, height, samples_per_frame, ray_depth,
                frame_seed(key, sample_start), t_min, t_max, cam_ptr, n_threads, out,
                ctypes.byref(segs),
            )
            if rc != 0:
                raise RuntimeError(f"mrt_cpu_render failed (rc={rc})")
            return torch.from_numpy(out), torch.tensor(segs.value, dtype=torch.float64)

        return render

    return factory
