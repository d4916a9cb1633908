"""Pure-Python BVH builder fallback (median split).

Same flat skip-link output contract as the native binned-SAH builder
(csrc/native/bvh.cpp); the tree shape differs (median vs SAH splits) but
any traversal result is identical — both are verified against brute force
in tests.
"""

from __future__ import annotations

import numpy as np


def build_bvh_python(prim_min: np.ndarray, prim_max: np.ndarray, max_leaf: int = 4):
    from myraytracer_tpu_torch.native import FlatBVH

    n = prim_min.shape[0]
    cent = 0.5 * (prim_min + prim_max)
    order = np.arange(n, dtype=np.int32)

    nodes_min, nodes_max, first, count, skip = [], [], [], [], []

    def emit(lo, hi, fst, cnt):
        nodes_min.append(lo)
        nodes_max.append(hi)
        first.append(fst)
        count.append(cnt)
        skip.append(-1)
        return len(count) - 1

    def build(lo_i, n_i):
        ids = order[lo_i : lo_i + n_i]
        box_lo = prim_min[ids].min(axis=0)
        box_hi = prim_max[ids].max(axis=0)
        node = emit(box_lo, box_hi, lo_i, n_i)
        if n_i > max_leaf:
            c = cent[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            mid = n_i // 2
            sel = np.argpartition(c[:, axis], mid)
            order[lo_i : lo_i + n_i] = ids[sel]
            count[node] = 0
            build(lo_i, mid)
            build(lo_i + mid, n_i - mid)
        skip[node] = len(count)

    if n > 0:
        build(0, n)
    return FlatBVH(
        nodes_min=np.asarray(nodes_min, np.float32).reshape(-1, 3),
        nodes_max=np.asarray(nodes_max, np.float32).reshape(-1, 3),
        first=np.asarray(first, np.int32),
        count=np.asarray(count, np.int32),
        skip=np.asarray(skip, np.int32),
        order=order,
    )
