"""The trace kernels' bound: the least time the card could take for the
work, the larger of its operations over the FP32 peak and its bytes over
the memory bandwidth. Frozen here, so that only a change to the benchmark
can recount it.

Operations: 25 a ray-sphere test and 40 a ray-triangle test, the tests
being those of the gated sweep (the reference's ``hit.count_tests``: every
leader, and every chunk whose gate a lane enters), counted on the
reference's pixels and scaled to the slice's segments by tests a segment.
Bytes: each scene table (spheres, triangles, gate boxes) read once a
launch, and each frame's image and each launch's segment counts written
once; for the adaptive kernel (``adaptive_bound_s``) each window's sums
of the blocks it renders in place of the image. The count is the same
whatever the kernel does.
"""

from __future__ import annotations

from typing import Optional

FLOP_SPHERE_TEST = 25
FLOP_TRIANGLE_TEST = 40

# Published peaks, dense FP32 outside the tensor cores and memory
# bandwidth (NVIDIA's H100 SXM data sheet), by the device name's part.
PEAKS = {
    "H100": {"flops": 67e12, "bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> Optional[dict]:
    for part, p in PEAKS.items():
        if part in device_name:
            return p
    return None


def bound_s(tests_per_segment: dict, segments: float, launches: int, frames: int,
            table_bytes: int, width: int, height: int, device_name: str) -> Optional[float]:
    """Seconds the card needs at least for ``segments`` segments over
    ``launches`` launches of ``frames`` frames in all; None off the table."""
    p = peaks(device_name)
    if p is None:
        return None
    flop = segments * (tests_per_segment["sphere"] * FLOP_SPHERE_TEST
                       + tests_per_segment["triangle"] * FLOP_TRIANGLE_TEST)
    nbytes = launches * (table_bytes + 4 * width * height) + frames * 12 * width * height
    return max(flop / p["flops"], nbytes / p["bytes_per_s"])


def adaptive_bound_s(tests_per_segment: dict, segments: float, launches: int, windows: int,
                     n_sel: int, block_pixels: int, table_bytes: int,
                     device_name: str) -> Optional[float]:
    """Seconds the card needs at least for ``segments`` segments over
    ``launches`` launches of the adaptive kernel, each rendering ``n_sel``
    blocks of ``block_pixels`` pixels over ``windows`` windows; None off
    the table. Operations as ``bound_s`` counts them; bytes: each table,
    and the block ids and cursors, read once a launch, and each window's
    sums (12 B a pixel) and the segment counts (4 B a pixel) written once."""
    p = peaks(device_name)
    if p is None:
        return None
    flop = segments * (tests_per_segment["sphere"] * FLOP_SPHERE_TEST
                       + tests_per_segment["triangle"] * FLOP_TRIANGLE_TEST)
    nbytes = launches * (table_bytes + 8 * n_sel + n_sel * block_pixels * (12 * windows + 4))
    return max(flop / p["flops"], nbytes / p["bytes_per_s"])
