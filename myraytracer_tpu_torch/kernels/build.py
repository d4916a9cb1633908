"""Building and binding the hand-written CUDA sources (``csrc/*.cu``).

Every source is compiled the same way: by ``nvcc`` for ``sm_90a``, from the
repository's file and nothing else, at first use, into the shared library
``build/kernels/<stem>_<hash>.so`` with a plain C interface, loaded with
``ctypes``. The hash covers the source and the flags, so an edit rebuilds;
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside the library as ``<stem>_<hash>.log``. ``build_all`` compiles several
sources at once, one ``nvcc`` process each.

A ``Kernel`` is one entry point of such a library and its launch count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, List, Sequence

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # No contraction of a*b+c into FMA: every product and sum rounds on its
    # own, as the plain version's eager torch ops do. No fast math: sqrtf and
    # divisions stay correctly rounded and denormals are kept.
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: the CUDA toolkit's, or the first on ``PATH``."""
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def nvcc_command(nvcc: str, source: pathlib.Path, out: pathlib.Path,
                 flags: Sequence[str] = NVCC_FLAGS) -> List[str]:
    """The command that builds ``source`` into the shared library ``out``."""
    return [nvcc, *flags, "-o", str(out), str(source)]


def library_path(source: pathlib.Path, flags: Sequence[str] = NVCC_FLAGS) -> pathlib.Path:
    """Where the build of ``source`` as it is now, with ``flags``, is cached."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build_all(sources: Iterable[pathlib.Path],
              flags: Sequence[str] = NVCC_FLAGS) -> Dict[pathlib.Path, pathlib.Path]:
    """Compile each of ``sources`` unless it is built already, all ``nvcc``
    processes started together; returns each source's library path.
    ``nvcc``'s report goes to the ``.log`` beside each library; a failed
    build raises with its errors."""
    outs = {src: library_path(src, flags) for src in sources}
    todo = [src for src, out in outs.items() if not out.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in todo:
            part = pathlib.Path(tmp) / outs[src].name
            procs.append((src, part, subprocess.Popen(
                nvcc_command(nvcc, src, part, flags),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, part, proc in procs:
            stdout, stderr = proc.communicate()
            outs[src].with_suffix(".log").write_text(stdout + stderr)
            if proc.returncode != 0:
                failed.append(f"{src.name}: nvcc failed ({proc.returncode}):\n{stderr}")
            else:
                os.replace(part, outs[src])  # atomic: never half a file
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def build(source: pathlib.Path, flags: Sequence[str] = NVCC_FLAGS) -> pathlib.Path:
    """Compile ``source`` unless it is built already; its library's path."""
    return build_all([source], flags)[source]


_LIBS: Dict[pathlib.Path, ctypes.CDLL] = {}


class Kernel:
    """One entry point of a source's library and its launch count.

    ``launches`` goes up by one at each launch of the kernel and nowhere
    else; a run can reset it and read it to show that it went through the
    kernel. The entry point returns the launch's ``cudaError_t``; a launch
    that is refused raises.
    """

    def __init__(self, source: pathlib.Path, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def load(self):
        if self._fn is None:
            if self.source not in _LIBS:  # one library a source, loaded once
                _LIBS[self.source] = ctypes.CDLL(str(build(self.source)))
            fn = getattr(_LIBS[self.source], self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args):
        err = self.load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: cudaError {err}")
        self.launches += 1
