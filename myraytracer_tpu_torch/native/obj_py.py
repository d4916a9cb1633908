"""Pure-Python OBJ loader fallback (same subset as csrc/native/obj.cpp).

Tolerance matches the native loader: a vertex line whose coordinates do
not parse is skipped (sscanf returning < 3), and a face index token is
read as its leading integer digits (strtol semantics), so both loaders
accept the same malformed-but-common files.
"""

from __future__ import annotations

import re

import numpy as np

_LEADING_INT = re.compile(r"^[+-]?\d+")


def load_obj_python(path):
    vertices = []
    triangles = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith(("v ", "v\t")):
                parts = line.split()
                if len(parts) >= 4:
                    try:
                        vertices.append([
                            float(parts[1]), float(parts[2]), float(parts[3])
                        ])
                    except ValueError:
                        continue  # malformed vertex: skip, like sscanf
            elif line.startswith(("f ", "f\t")):
                idx = []
                nv = len(vertices)
                for tok in line.split()[1:]:
                    head = tok.split("/")[0]
                    m = _LEADING_INT.match(head)
                    if not m:
                        continue
                    v = int(m.group(0))  # leading digits, like strtol
                    v = v - 1 if v > 0 else nv + v
                    if 0 <= v < nv:
                        idx.append(v)
                for k in range(2, len(idx)):  # fan triangulation
                    triangles.append([idx[0], idx[k - 1], idx[k]])
    return (
        np.asarray(vertices, np.float32).reshape(-1, 3),
        np.asarray(triangles, np.int32).reshape(-1, 3),
    )
