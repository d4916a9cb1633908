"""Bitwise golden hashes of the port's frames on a CUDA card.

Port of ``myraytracer_tpu.utils.hwgolden``. The determinism contract --
same code and key, same bits on the same card -- is pinned as data: the
recorder (``python -m myraytracer_tpu_torch.goldens --record``) stores a
sha256 per (scene, config, backend, device kind) in
``tests/golden/cuda_hashes.json``, and the bench
(``python -m myraytracer_tpu_torch.bench``) re-checks its headline entry
every run. A frame's bits depend on the card and on the compiler as much
as on the code, so each entry carries the torch, CUDA and ``nvcc``
versions it was recorded under: a mismatch under the same three versions
is a code change that altered the card's bits (a regression until shown
otherwise); under another version it is drift, to re-record.

Pure helpers; no device access, so the CPU tests hold them to the JAX
package's.
"""

from __future__ import annotations

import functools
import hashlib
import json
import pathlib
import re
import subprocess

import numpy as np

DEFAULT_PATH = (
    pathlib.Path(__file__).resolve().parents[2]
    / "tests" / "golden" / "cuda_hashes.json"
)
# The key's execution-path component: the port runs its kernels eagerly
# through ctypes, with no exported or traced form beside it.
EXEC_PATH = "eager"
# The versions an entry is recorded under; a mismatch is a regression only
# when all of them are the same.
VERSION_FIELDS = ("torch", "cuda", "nvcc")


def frame_hash(arr) -> str:
    """sha256 of a framebuffer's exact bits (shape and dtype first, so a
    layout change cannot alias a pixel change)."""
    a = np.asarray(arr)
    h = hashlib.sha256()
    h.update(f"{a.dtype.str}:{a.shape}:".encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def entry_key(
    scene: str, width: int, height: int, spp: int, depth: int,
    backend: str, device_kind: str, exec_path: str = EXEC_PATH,
) -> str:
    """One golden per rendering contract: the scene and config fix the
    sample stream, the backend the compute path, the device kind the card
    (``torch.cuda.get_device_name()``); the components and their order are
    the JAX package's."""
    return (
        f"{scene}:{width}x{height}:spp{spp}:d{depth}:{backend}"
        f":{exec_path}:{device_kind}"
    )


def load_table(path=None) -> dict:
    p = pathlib.Path(path or DEFAULT_PATH)
    if not p.exists():
        return {}
    return json.loads(p.read_text())


def save_table(table: dict, path=None) -> None:
    p = pathlib.Path(path or DEFAULT_PATH)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")


@functools.lru_cache(maxsize=1)
def nvcc_release():
    """The release of the ``nvcc`` that ``kernels/build.py`` compiles with
    (``find_nvcc``), as its ``--version`` gives it (``12.8.93``); None where
    there is none."""
    from myraytracer_tpu_torch.kernels.build import find_nvcc

    try:
        nvcc = find_nvcc()
    except RuntimeError:
        return None
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    m = re.search(r"release \S+, V(\S+)", out)
    return m.group(1) if m else out.strip().splitlines()[-1]


def versions() -> dict:
    """The torch, CUDA and nvcc versions of this process."""
    import torch

    return {"torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": nvcc_release()}


def make_entry(digest: str, mean: float, exec_path: str = EXEC_PATH,
               mrays=None) -> dict:
    """A table entry; ``mrays`` is the rate the bench measured beside the
    frame (its ``vs_baseline`` divides by it)."""
    entry = {"hash": digest, "mean": round(float(mean), 8), "exec_path": exec_path,
             **versions()}
    if mrays is not None:
        entry["mrays"] = float(mrays)
    return entry


def check(key: str, digest: str, table: dict) -> tuple[str, dict | None]:
    """Compare a fresh digest with the table: ("match" | "mismatch" |
    "absent", the recorded entry or None)."""
    rec = table.get(key)
    if rec is None:
        return "absent", None
    return ("match" if rec["hash"] == digest else "mismatch"), rec


def same_versions(rec: dict) -> bool:
    """Whether ``rec`` was recorded under this process's torch, CUDA and
    nvcc versions: a mismatch under them is a regression, not drift."""
    now = versions()
    return all(rec.get(f) == now[f] for f in VERSION_FIELDS)


def describe(status: str, key: str, digest: str, rec: dict | None) -> str:
    """One self-contained log line for a check result."""
    if status == "absent":
        return (
            f"hwgolden: no recorded hash for {key} "
            f"(record with python -m myraytracer_tpu_torch.goldens --record)"
        )
    if status == "match":
        return f"hwgolden: bitwise match for {key}"
    if same_versions(rec):
        cause = ("SAME torch, CUDA and nvcc versions -- a code change altered the "
                 "card's bits; investigate before re-recording")
    else:
        now = versions()
        moved = ", ".join(f"{f} {rec.get(f)} -> {now[f]}" for f in VERSION_FIELDS
                          if rec.get(f) != now[f])
        cause = (f"{moved} -- compiler drift; re-record with "
                 f"python -m myraytracer_tpu_torch.goldens --record")
    return (
        f"hwgolden: MISMATCH for {key}: got {digest[:16]}.. "
        f"want {rec['hash'][:16]}.. ({cause})"
    )
