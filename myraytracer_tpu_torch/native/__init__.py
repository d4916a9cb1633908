"""Native (C++) host components of the port, with Python fallbacks.

Port of ``myraytracer_tpu.native``: the binned-SAH BVH builder, the OBJ
loader and the CPU renderer (``native/cpu_backend.py``) are the C++ sources
in ``csrc/native/``, a copy of the JAX package's ``native/src``, bound with
ctypes. They are linked at first use by ``kernels.build.build_host`` into
``build/native/libmrt_native_<hash>.so``; the hash covers the sources, the
flags, the compiler and the CPU, so a library from other sources or another
host is never loaded.

A build or load that fails is logged as a warning with the compiler's
error, ``native_available()`` reports False, and ``build_bvh``/``load_obj``
use the Python fallbacks (``bvh_py``, ``obj_py``: the same output contract).
"""

from __future__ import annotations

import ctypes
import logging
import pathlib
import subprocess
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np

from myraytracer_tpu_torch.kernels import build as kbuild

SOURCES = tuple(kbuild.CSRC / "native" / name for name in ("bvh.cpp", "obj.cpp", "cpu_renderer.cpp"))
LIB_NAME = "libmrt_native"

log = logging.getLogger("myraytracer_tpu_torch.native")

_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[pathlib.Path] = None
_lib_error: Optional[str] = None
# The C loader keeps one parse in flight (a global): one caller at a time.
_obj_lock = threading.Lock()


class FlatBVH(NamedTuple):
    """Flat skip-link BVH (depth-first node order).

    Traversal contract: at node ``i``, on a bbox hit descend to ``i+1``
    (or iterate the leaf primitives ``order[first:first+count]``), then
    continue at ``skip[i]``; on a miss jump to ``skip[i]``; finish when the
    cursor reaches ``len(count)``.
    """

    nodes_min: np.ndarray  # [M, 3] f32
    nodes_max: np.ndarray  # [M, 3] f32
    first: np.ndarray  # [M] i32 (valid when count > 0)
    count: np.ndarray  # [M] i32 (0 = interior)
    skip: np.ndarray  # [M] i32
    order: np.ndarray  # [P] i32 primitive permutation


def _bind(lib: ctypes.CDLL) -> None:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.mrt_build_bvh.restype = ctypes.c_int
    lib.mrt_build_bvh.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int,
        f32p, f32p, i32p, i32p, i32p, i32p,
    ]
    lib.mrt_obj_open.restype = ctypes.c_int
    lib.mrt_obj_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mrt_obj_read.restype = ctypes.c_int
    lib.mrt_obj_read.argtypes = [f32p, i32p]
    lib.mrt_obj_free.restype = None
    lib.mrt_obj_free.argtypes = []
    lib.mrt_cpu_scene_load.restype = ctypes.c_void_p
    lib.mrt_cpu_scene_load.argtypes = [ctypes.c_char_p]
    lib.mrt_cpu_scene_free.restype = None
    lib.mrt_cpu_scene_free.argtypes = [ctypes.c_void_p]
    lib.mrt_cpu_scene_info.restype = None
    lib.mrt_cpu_scene_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mrt_cpu_render.restype = ctypes.c_int
    lib.mrt_cpu_render.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_int, f32p, ctypes.POINTER(ctypes.c_double),
    ]


def load_library() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None (after one warning
    naming the error) when it cannot be built or loaded."""
    global _lib, _lib_path, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        path = kbuild.build_host(LIB_NAME, SOURCES)
        lib = ctypes.CDLL(str(path))
        _bind(lib)
    except (OSError, RuntimeError, AttributeError, subprocess.SubprocessError) as e:
        _lib_error = str(e)
        log.warning("native library unavailable; the Python BVH and OBJ fallbacks are in "
                    "use and --backend cpu cannot render: %s", e)
        return None
    _lib, _lib_path = lib, path
    return _lib


def native_available() -> bool:
    return load_library() is not None


def native_error() -> Optional[str]:
    """Why the native library is unavailable (None when it loaded)."""
    load_library()
    return _lib_error


def library_path() -> Optional[pathlib.Path]:
    """The file the native library was loaded from (None when unavailable)."""
    load_library()
    return _lib_path


def build_bvh(
    prim_min: np.ndarray,
    prim_max: np.ndarray,
    max_leaf: int = 4,
    force_python: bool = False,
) -> FlatBVH:
    """Build a flat skip-link BVH over primitive AABBs.

    Uses the native binned-SAH builder when available, else the Python
    median-split fallback (same output contract, different tree shape).
    """
    prim_min = np.ascontiguousarray(prim_min, np.float32)
    prim_max = np.ascontiguousarray(prim_max, np.float32)
    n = prim_min.shape[0]
    assert prim_min.shape == (n, 3) and prim_max.shape == (n, 3)

    lib = None if force_python else load_library()
    if lib is not None:
        cap = 2 * n
        nodes_min = np.empty((cap, 3), np.float32)
        nodes_max = np.empty((cap, 3), np.float32)
        first = np.empty(cap, np.int32)
        count = np.empty(cap, np.int32)
        skip = np.empty(cap, np.int32)
        order = np.empty(n, np.int32)
        m = lib.mrt_build_bvh(
            prim_min, prim_max, n, int(max_leaf),
            nodes_min, nodes_max, first, count, skip, order,
        )
        if m > 0:
            return FlatBVH(
                nodes_min[:m].copy(), nodes_max[:m].copy(),
                first[:m].copy(), count[:m].copy(), skip[:m].copy(), order,
            )
    from myraytracer_tpu_torch.native.bvh_py import build_bvh_python

    return build_bvh_python(prim_min, prim_max, max_leaf)


def load_obj(path, force_python: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Load an OBJ file → (vertices [V,3] f32, triangles [T,3] i32)."""
    lib = None if force_python else load_library()
    if lib is not None:
        nv = ctypes.c_int()
        nt = ctypes.c_int()
        with _obj_lock:
            rc = lib.mrt_obj_open(str(path).encode(), ctypes.byref(nv), ctypes.byref(nt))
            if rc == 0:
                vertices = np.empty((nv.value, 3), np.float32)
                triangles = np.empty((nt.value, 3), np.int32)
                lib.mrt_obj_read(vertices, triangles)
                lib.mrt_obj_free()
                return vertices, triangles
        if rc == -1:
            raise FileNotFoundError(path)
    from myraytracer_tpu_torch.native.obj_py import load_obj_python

    return load_obj_python(path)
