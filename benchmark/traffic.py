"""The general traffic generator: what a traffic file's parameters and the
seed make of a run.

A traffic file (``benchmark/traffic/<name>.json``) sets the samples a
frame (a number, or ``"config"`` for the configuration's samples per
pixel), the frames a launch (``frame_batch``, 0 for the renderer's own
choice), whether every step moves the camera (``move_each_step``: the next
turntable view, which resets the accumulation), how often the framebuffer
is fetched to host memory (``fetch_every_s``, 0 for after every step),
which turntable views it moves through (``view_stride``: every n-th),
and what the check compares (``check``: how many answers, picked how, and
the pixels a picked answer is compared at).

A mix with ``"session": "adaptive"`` drives the adaptive session instead
(``render/adaptive.py``), one image a unit: it sets the samples of a
window (``samples_per_window``), the image's budget in uniform frames of
that many samples (``budget_frames``), the windows a round renders in one
launch (``windows_per_round``) and the blocks a round picks
(``blocks_per_round``), these two 0 for the session's own choice, with
``view_stride`` and ``check`` as above.

The seed picks the turntable's first view, the answers that are checked
and the pixels they are checked at; it sets nothing else, so every seed
gives a run the same work.
"""

from __future__ import annotations

import math

import numpy as np

# Streams of the seed, one per use.
_VIEW, _ANSWERS, _PIXELS = 1, 2, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def adaptive(traffic: dict) -> bool:
    """Whether the mix drives the adaptive session."""
    return traffic.get("session") == "adaptive"


def samples_per_frame(traffic: dict, cfg: dict) -> int:
    spp = traffic["samples_per_frame"]
    return int(cfg["samples_per_pixel"] if spp == "config" else spp)


def turntable(cfg: dict, api) -> list:
    """The configuration's turntable views, of ``api``'s ``Camera``: even
    steps of a full turn about the look-at point, at the camera's height
    and horizontal distance (copied from ``myraytracer_tpu_torch/orbit.py:
    cameras`` at commit 32ae5bc). One step is the published camera."""
    c = cfg["camera"]
    steps = int(cfg["turntable_steps"])
    la, lf = c["lookat"], c["lookfrom"]
    radius = math.dist((lf[0], lf[2]), (la[0], la[2]))
    phi0 = math.atan2(lf[2] - la[2], lf[0] - la[0])

    def view(i):
        if steps == 1:
            return tuple(lf)
        phi = phi0 + 2.0 * math.pi * i / steps
        return (la[0] + radius * math.cos(phi), lf[1], la[2] + radius * math.sin(phi))

    return [api.Camera(lookfrom=view(i), lookat=tuple(la), vup=tuple(c["vup"]),
                       vfov_degrees=c["vfov_degrees"], aperture=c["aperture"],
                       focus_dist=c["focus_dist"]) for i in range(steps)]


def views(cfg: dict, traffic: dict, api) -> list:
    """The views the traffic moves through: every ``view_stride``-th step of
    the turntable, so that a window of some tens of images covers each of
    them about as often on every seed."""
    return turntable(cfg, api)[::int(traffic.get("view_stride", 1))]


def first_view(seed: int, steps: int) -> int:
    """The turntable step the run starts at."""
    return int(rng(seed, _VIEW).integers(steps))


def check_pixels(seed: int, width: int, height: int, n: int):
    """``n`` pixels spread over the whole image, one drawn in each cell of a
    grid of about ``n`` cells: ``(ix, iy)`` int64 arrays."""
    gx = max(1, min(width, round(math.sqrt(n * width / height))))
    gy = max(1, min(height, n // gx))
    r = rng(seed, _PIXELS)
    x0 = (np.arange(gx) * width) // gx
    x1 = (np.arange(1, gx + 1) * width) // gx
    y0 = (np.arange(gy) * height) // gy
    y1 = (np.arange(1, gy + 1) * height) // gy
    ix = x0[None, :] + (r.random((gy, gx)) * (x1 - x0)[None, :]).astype(np.int64)
    iy = y0[:, None] + (r.random((gy, gx)) * (y1 - y0)[:, None]).astype(np.int64)
    return ix.reshape(-1).astype(np.int64), iy.reshape(-1).astype(np.int64)


class Picker:
    """Which answers the check keeps, decided as they arrive: ``"last"``
    keeps the last ``k``; ``"sample"`` a uniform sample of ``k`` drawn from
    the seed (reservoir sampling), so no answer is kept that is not
    compared."""

    def __init__(self, seed: int, k: int, pick: str):
        if pick not in ("last", "sample"):
            raise ValueError(f"pick must be 'last' or 'sample', got {pick!r}")
        self.k, self.pick = int(k), pick
        self.rng = rng(seed, _ANSWERS)
        self.kept = []  # (answer index, payload)
        self.seen = 0

    def offer(self, payload) -> None:
        n, self.seen = self.seen, self.seen + 1
        if self.k == 0:
            return
        if len(self.kept) < self.k:
            self.kept.append((n, payload))
        elif self.pick == "last":
            self.kept = self.kept[1:] + [(n, payload)]
        else:
            j = int(self.rng.integers(n + 1))
            if j < self.k:
                self.kept[j] = (n, payload)

    def answers(self) -> list:
        return [p for _, p in sorted(self.kept, key=lambda e: e[0])]
