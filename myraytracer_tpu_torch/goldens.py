"""Record or re-check the card's bitwise golden hashes.

    python -m myraytracer_tpu_torch.goldens            # check against the table
    python -m myraytracer_tpu_torch.goldens --record   # (re)record every row

The counterpart of the JAX package's ``tools/tpu_goldens.py``: the same
rows, each one frame at 256x128, spp 4, depth 8 through the session's path
(``dispatch.make_session`` and ``step()``), hashed with ``utils/hwgolden``
into ``tests/golden/cuda_hashes.json`` under this card's device kind. Every
row renders on ``cuda``: the kernel renders image textures, so ``earth``
needs no other backend. The headline entry (final 1200x800, spp 500, depth
50) is the bench's: ``BENCH_RECORD_GOLDEN=1 python -m
myraytracer_tpu_torch.bench``.

Check mode prints one line a row and exits 1 when a row mismatches; a
mismatch under other torch, CUDA or nvcc versions than the entry's is
drift (``hwgolden.describe`` says which). Without a CUDA GPU it exits 3.
"""

from __future__ import annotations

import sys

import torch

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.render.dispatch import make_session
from myraytracer_tpu_torch.scene.presets import get_scene
from myraytracer_tpu_torch.utils import hwgolden

# Scene and config overrides. 256x128 spans several tiles of the kernel's
# queue; the estimator rows pin the MIS, QMC and RR streams on the card.
ROWS = [
    ("reference", {}),
    ("three-sphere", {}),
    ("defocus", {}),
    ("final", {}),
    ("light", {}),
    ("cornell", {}),
    ("texture", {}),
    ("mesh", dict(samples_per_frame=2)),
    ("earth", {}),
    ("cornell", dict(nee=True)),
    ("defocus", dict(qmc=True)),
    ("three-sphere", dict(rr=3, ray_depth=12)),
]

BASE = dict(
    width=256, height=128, samples_per_frame=4, ray_depth=8,
    backend="cuda", seed=0, frame_batch=1,
)


def row_key(scene_name: str, cfg: RenderConfig, device_kind: str) -> str:
    tags = "".join(
        t for t, on in (
            ("+nee", cfg.nee), ("+qmc", cfg.qmc),
            (f"+rr{cfg.rr}", cfg.rr),
        ) if on
    )
    return hwgolden.entry_key(
        scene_name + tags, cfg.width, cfg.height, cfg.samples_per_frame,
        cfg.ray_depth, cfg.backend, device_kind,
    )


def frames(device_kind: str, rows=ROWS, base=BASE):
    """Each row's (key, first frame [H, W, 3] on the host)."""
    for scene_name, overrides in rows:
        cfg = RenderConfig(**{**base, **overrides})
        session = make_session(get_scene(scene_name, seed=0), cfg)
        session.step()
        yield row_key(scene_name, cfg, device_kind), session.framebuffer.cpu().numpy()


def check_rows(table: dict, device_kind: str, rows=ROWS, base=BASE):
    """Each row's (key, status, recorded entry, digest) against ``table``."""
    out = []
    for key, arr in frames(device_kind, rows, base):
        digest = hwgolden.frame_hash(arr)
        status, rec = hwgolden.check(key, digest, table)
        out.append((key, status, rec, digest))
    return out


def main(argv=None) -> int:
    record = "--record" in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("goldens: the hardware goldens are the CUDA card's, and "
              "torch.cuda.is_available() is False; nothing to do", file=sys.stderr)
        return 3
    kind = torch.cuda.get_device_name()
    table = hwgolden.load_table()
    if record:
        for key, arr in frames(kind):
            digest = hwgolden.frame_hash(arr)
            table[key] = hwgolden.make_entry(digest, arr.mean())
            print(f"recorded {key}: {digest[:16]}.. mean={arr.mean():.6f}", flush=True)
        hwgolden.save_table(table)
        print(f"wrote {hwgolden.DEFAULT_PATH} ({len(table)} entries)")
        return 0
    failures = []
    for key, status, rec, digest in check_rows(table, kind):
        print(hwgolden.describe(status, key, digest, rec), flush=True)
        if status == "mismatch":
            failures.append(key)
    if failures:
        print(f"goldens: {len(failures)} MISMATCHED rows: {failures}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
