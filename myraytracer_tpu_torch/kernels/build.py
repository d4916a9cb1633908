"""Building and binding the hand-written CUDA sources (``csrc/*.cu``).

Every source is compiled the same way: by ``nvcc`` for ``sm_90a``, from the
repository's file and nothing else, at first use, into the shared library
``build/kernels/<stem>_<hash>.so`` with a plain C interface, loaded with
``ctypes``. The hash covers the source and the flags, so an edit rebuilds
and one source built with other flags (``-DMRT_ABLATE=...``) is a library
of its own; ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside the library as ``<stem>_<hash>.log``. ``build_many``
compiles several (source, flags) builds at once, one ``nvcc`` process
each.

The C++ host sources (``csrc/native/*.cpp``: the BVH builder, the OBJ
loader and the CPU renderer) follow the same rule with the host compiler:
``build_host`` links them into ``build/native/<name>_<hash>.so``, the hash
over the sources, the flags, the compiler's version and what it makes of ``-march=native`` on
this CPU, so a library built elsewhere or from older sources is never
loaded.

A ``Kernel`` is one entry point of such a library and its launch count.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, List, Sequence, Tuple

from myraytracer_tpu_torch.utils import profiling

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


NATIVE_BUILD_DIR = BUILD_DIR.parent / "native"
# The library flags of the JAX package's native/Makefile.
HOST_FLAGS = ("-O3", "-fPIC", "-Wall", "-std=c++17", "-march=native", "-DMRT_CPU_LIB", "-shared")
HOST_LIBS = ("-lpthread",)


def find_cxx() -> str:
    """Path of the host C++ compiler: ``$CXX``, else ``g++`` or ``c++`` on
    ``PATH``."""
    for cand in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no host C++ compiler (g++, c++ or $CXX) found")


def host_command(cxx: str, sources: Sequence[pathlib.Path], out: pathlib.Path,
                 flags: Sequence[str] = HOST_FLAGS) -> List[str]:
    """The command that links ``sources`` into the shared library ``out``."""
    return [cxx, *flags, "-o", str(out), *map(str, sources), *HOST_LIBS]


def _host_identity(cxx: str) -> bytes:
    """The compiler's version and what it makes of ``-march=native`` on
    this CPU: the driver's commands under ``-###`` (GCC's and Clang's alike
    name the target and every instruction set it enables)."""
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True, timeout=60)
    target = subprocess.run([cxx, "-march=native", "-###", "-E", "-x", "c++", os.devnull],
                            capture_output=True, text=True, timeout=60)
    return (version.stdout + target.stderr).encode()


def host_library_path(name: str, sources: Sequence[pathlib.Path], cxx: str,
                      flags: Sequence[str] = HOST_FLAGS) -> pathlib.Path:
    """Where the host build of ``sources`` as they are now is cached."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join((*flags, *HOST_LIBS)).encode())
    h.update(_host_identity(cxx))
    return NATIVE_BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_host(name: str, sources: Sequence[pathlib.Path],
               flags: Sequence[str] = HOST_FLAGS) -> pathlib.Path:
    """Link ``sources`` with the host compiler into ``name``'s library unless
    it is built already; returns its path. The compiler's output goes to the
    ``.log`` beside it; a failed build raises with its errors. Processes
    that build at once take turns, so one compiles and the rest load."""
    cxx = find_cxx()
    out = host_library_path(name, sources, cxx, flags)
    if out.exists():
        return out
    NATIVE_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(NATIVE_BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        with tempfile.TemporaryDirectory(dir=NATIVE_BUILD_DIR) as tmp:
            part = pathlib.Path(tmp) / out.name
            proc = subprocess.run(host_command(cxx, sources, part, flags),
                                  capture_output=True, text=True)
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed ({proc.returncode}) building {name}:\n"
                                   f"{proc.stderr}")
            os.replace(part, out)  # atomic: never half a file
    return out


def build_many(jobs: Iterable[Tuple[pathlib.Path, Sequence[str]]]) -> List[pathlib.Path]:
    """Compile each (source, flags) build unless it is built already, all
    ``nvcc`` processes started together; returns each build's library path,
    in order. ``nvcc``'s report goes to the ``.log`` beside each library; a
    failed build raises with its errors."""
    jobs = [(src, tuple(flags)) for src, flags in jobs]
    outs = [library_path(src, flags) for src, flags in jobs]
    todo = {out: job for out, job in zip(outs, jobs) if not out.exists()}
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for out, (src, flags) in todo.items():
            part = pathlib.Path(tmp) / out.name
            procs.append((src, out, part, subprocess.Popen(
                nvcc_command(nvcc, src, part, flags),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, out, part, proc in procs:
            stdout, stderr = proc.communicate()
            out.with_suffix(".log").write_text(stdout + stderr)
            if proc.returncode != 0:
                failed.append(f"{src.name}: nvcc failed ({proc.returncode}):\n{stderr}")
            else:
                os.replace(part, out)  # atomic: never half a file
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def build(source: pathlib.Path, flags: Sequence[str] = NVCC_FLAGS) -> pathlib.Path:
    """Compile ``source`` unless it is built already; its library's path."""
    return build_many([(source, flags)])[0]


def entry_registers(log: str, entry: str) -> Dict[str, Tuple[int, int]]:
    """Registers and spill bytes (stores and loads) of the entry functions
    whose mangled names match ``entry``, keyed by its first group, from an
    ``-Xptxas -v`` report."""
    import re

    out, key, spill = {}, None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(entry, ln)
            key = m.group(1) if m else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and key:
            out[key] = (int(m.group(1)), spill)
            key = None
    return out


def sass(library: pathlib.Path) -> str:
    """The SASS of a built library (``cuobjdump -sass``, beside ``nvcc``)."""
    cuobjdump = pathlib.Path(find_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout


_LIBS: Dict[Tuple[pathlib.Path, Tuple[str, ...]], ctypes.CDLL] = {}


class Kernel:
    """One entry point of a source's library, built with ``flags``, and its
    launch count.

    ``launches`` goes up by one at each launch of the kernel and nowhere
    else; a run can reset it and read it to show that it went through the
    kernel. The entry point returns the launch's ``cudaError_t``; a launch
    that is refused raises.
    """

    def __init__(self, source: pathlib.Path, symbol: str, argtypes,
                 flags: Sequence[str] = NVCC_FLAGS):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.flags = tuple(flags)
        self.launches = 0
        self._fn = None

    def load(self):
        if self._fn is None:
            with profiling.span("kernel.load"):
                lib = (self.source, self.flags)
                if lib not in _LIBS:  # one library a source and flags, loaded once
                    _LIBS[lib] = ctypes.CDLL(str(build(self.source, self.flags)))
                fn = getattr(_LIBS[lib], self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def launch(self, *args):
        err = self.load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: cudaError {err}")
        self.launches += 1
