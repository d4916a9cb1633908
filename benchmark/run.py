"""Run one cell of the benchmark once, and print its result as the last
line of standard output.

    python3 benchmark/run.py --workload final.offline --seed 7 --seconds 30 --trace 0

It measures ``myraytracer_tpu_torch`` on one CUDA card through the CLI's
own path: ``render.dispatch.make_session`` with a ``RenderConfig``, then
``RenderSession.set_camera``, ``step`` and ``fetch_framebuffer`` read to
host memory, as the cell's traffic mix (``benchmark/traffic/``) asks.
Set-up builds the world from the configuration file (through the cell's
world module, ``registry.py``), the session, the kernel's library (cached
under ``build/kernels/`` in the checkout, so only a checkout's first run
compiles) and one warm step of the cell's own shape; ``setup_s`` runs
from the process's start to the first timed dispatch. The window then
runs whole steps until ``--seconds`` have passed, and closes when the
last framebuffer begun before then is in host memory. After it closes,
the program's state is freed and the plain reference
(``benchmark/check.py``) judges the answers it picked.

A traffic mix with ``"session": "adaptive"`` takes the path of the CLI's
``--adaptive`` instead: ``render.adaptive.AdaptiveSession`` with the
mix's ``RenderConfig``, one image a unit (``set_camera``, ``bootstrap``,
``step`` while the next round fits the budget, ``fetch_framebuffer``),
its samples counted from the session's ``spp_map`` and its launches by
``kernels.trace.ADAPTIVE``; the warm step is one whole image.

With ``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, from a ``torch.profiler`` slice of
the window (trace written to ``build/bench/``), the benchmark's own spans
and the program's counters, and a ``breakdown``. Every metric is read by
``benchmark/metrics/<name>.py``; a traced run's readers also get the cell
reference's counts on the checked pixels (``tests``, the whole dict
``hit.count_tests`` returns, and ``reference_segments``), so a reader
added with a configuration can count a kind of test of its own.

Exits non-zero and prints no result when there is no CUDA card (or fewer
than the cell asks for), when the program cannot be imported, or when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import pathlib
import sys
import time
import types
from typing import NamedTuple, Optional

_T_LOADED = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":  # run as a script: import the checkout, not benchmark/
    sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check as chk  # noqa: E402
from benchmark import profiling  # noqa: E402
from benchmark import registry  # noqa: E402
from benchmark import traffic as tr  # noqa: E402

# Top-level module names that must not be loaded where the result is printed.
FORBIDDEN = ("jax", "jaxlib", "flax", "myraytracer_tpu")
BUILD = ROOT / "build"


def process_age() -> float:
    """Seconds since this process started (from ``/proc``), or since this
    module was loaded where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        if 0.0 <= age < 86400.0:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - _T_LOADED


def set_cache_dirs() -> None:
    """Every compiler cache of the run inside the checkout, at fixed paths."""
    cache = BUILD / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Program(NamedTuple):
    """What the benchmark takes from the system under test."""

    api: types.ModuleType  # the scene API
    RenderConfig: type
    make_session: object
    kernel: object  # the trace kernel, with its launch counter
    AdaptiveSession: type
    adaptive_kernel: object  # the adaptive trace kernel, with its launch counter


def load_program() -> Program:
    from myraytracer_tpu_torch.config import RenderConfig
    from myraytracer_tpu_torch.kernels import trace as ktrace
    from myraytracer_tpu_torch.render import dispatch
    from myraytracer_tpu_torch.render.adaptive import AdaptiveSession
    from myraytracer_tpu_torch.scene import api

    return Program(api, RenderConfig, dispatch.make_session, ktrace.KERNEL, AdaptiveSession,
                   ktrace.ADAPTIVE)


class Spans:
    """The benchmark's own spans, ``(name, start, end)`` on the host clock,
    and profiler annotations ``bench.<name>`` while a slice is on."""

    def __init__(self):
        self.rows = []
        self.marking = False

    def __call__(self, name: str) -> "_Span":
        return _Span(self, name)


class _Span:
    __slots__ = ("spans", "name", "t0", "mark")

    def __init__(self, spans: Spans, name: str):
        self.spans, self.name, self.mark = spans, name, None

    def __enter__(self):
        if self.spans.marking:
            self.mark = torch.profiler.record_function("bench." + self.name)
            self.mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.rows.append((self.name, self.t0, time.perf_counter()))
        if self.mark is not None:
            self.mark.__exit__(*exc)


class Loop:
    """The cell's traffic on one session: moves, steps and fetches, and
    what each fetch brought to host memory."""

    def __init__(self, session, traffic: dict, views: list, view0: int, spp: int,
                 width: int, height: int, spans: Spans, picker: tr.Picker):
        self.s, self.traffic, self.views = session, traffic, views
        self.next_view = view0
        self.spp, self.pixels = spp, width * height
        self.spans, self.picker = spans, picker
        self.view = None
        self.t_move = None
        # The sample cursor and the frames since the last reset, as the
        # session's contract advances them: spp x frame_batch a step.
        self.cursor = 0
        self.reset_cursor = 0
        self.frames = 0
        self.segs_total = 0.0  # the program's segment total at the last read
        self.segs_at_reset = 0.0
        self.frames_fetched = 0  # frames of this accumulation already fetched
        self.frames_stepped = 0
        self.samples_fetched = 0  # samples that reached host memory
        self.latencies = []
        self.t_host = None
        self.answers = 0

    def move(self, camera=None) -> None:
        """Move to the next turntable view (or to ``camera``): a reset."""
        if camera is None:
            self.view, camera = self.next_view, self.views[self.next_view]
            self.next_view = (self.next_view + 1) % len(self.views)
        else:
            self.view = None
        self.t_move = time.perf_counter()
        with self.spans("set_camera"):
            self.s.set_camera(camera)
        self.reset_cursor = self.cursor
        self.segs_at_reset = self.segs_total
        self.frames = self.frames_fetched = 0

    def step(self) -> None:
        with self.spans("step"):
            self.s.step()
        k = self.s.frame_batch
        self.frames_stepped += k
        self.frames += k
        self.cursor += k * self.spp

    def fetch(self) -> None:
        with self.spans("fetch"):
            fb = self.s.fetch_framebuffer().cpu().numpy()
        self.t_host = time.perf_counter()
        if self.traffic["move_each_step"]:
            self.latencies.append(self.t_host - self.t_move)
        self.segs_total = self.s.segments_traced
        frames = self.frames
        self.samples_fetched += (frames - self.frames_fetched) * self.spp * self.pixels
        self.frames_fetched = frames
        self.answers += 1
        self.picker.offer(chk.Answer(self.view, self.reset_cursor, frames, self.spp,
                                     self.segs_total - self.segs_at_reset, fb))

    def unit(self, last_fetch: float) -> float:
        """One step of the traffic; returns the time of the last fetch."""
        if self.traffic["move_each_step"]:
            self.move()
        self.step()
        every = self.traffic["fetch_every_s"]
        if every == 0 or time.perf_counter() - last_fetch >= every:
            self.fetch()
            return self.t_host
        return last_fetch

    def begin_window(self, picker: tr.Picker) -> None:
        self.picker, self.answers, self.samples_fetched = picker, 0, 0
        self.latencies, self.frames_stepped = [], 0

    def counts(self) -> dict:
        return {"frames": self.frames_stepped}

    def close(self) -> None:
        if self.frames_fetched < self.frames or self.answers == 0:
            self.fetch()  # the frames begun in the window that no fetch brought yet


class AdaptiveLoop:
    """The adaptive traffic on one ``AdaptiveSession``, as the CLI's
    ``--adaptive`` runs it: one image a unit (a move to the next view, the
    bootstrap, auto rounds while the next one fits the budget, a fetch),
    and what each fetch brought to host memory. Each block's sample cursor
    is tracked here from the spp map read after each fetch: the cursors
    start at 0 when the session is made, advance by exactly the samples a
    block got, and survive ``set_camera``.

    The budget is spent on the loop's own count of the samples it asked
    for, whole blocks counted as the session's ``samples_spent`` counts
    them: the bootstrap's two covers of every block, F windows a call, and
    ``n_sel`` blocks of F windows an auto round. On a sound session the
    two counts agree, so the rounds are the CLI's; the check holds the
    spp map to this count (``check.samples_gap``)."""

    COVERS = 2  # the bootstrap's covers: AdaptiveSession.bootstrap's default, the CLI's

    def __init__(self, session, views: list, view0: int, spp: int, budget: int, spans: Spans,
                 picker: tr.Picker):
        self.s, self.views, self.next_view = session, views, view0
        self.spp, self.budget = spp, budget
        self.spans, self.picker = spans, picker
        self.view = None
        self.cursor = np.zeros((session.blocks_y, session.blocks_x), np.int64)
        self.segs_total = 0.0  # the program's segment total at the last read
        self.rounds = 0  # auto rounds stepped
        self.asked = 0  # samples this image asked for, whole blocks counted
        self.samples_fetched = 0
        self.latencies = []  # none: the mix is measured by its rate
        self.t_host = None
        self.answers = 0

    def unit(self, last_fetch: float = 0.0) -> float:
        """One image; returns the time of its fetch."""
        self.view = self.next_view
        self.next_view = (self.next_view + 1) % len(self.views)
        with self.spans("set_camera"):
            self.s.set_camera(self.views[self.view])
        with self.spans("bootstrap"):
            self.s.bootstrap()
        s = self.s
        window = s.windows * self.spp * s.block_w * s.block_h
        self.asked = -(-self.COVERS // s.windows) * s.n_blocks * window
        cost = s.n_sel * window
        while self.asked + cost <= self.budget:
            with self.spans("step"):
                s.step()
            self.rounds += 1
            self.asked += cost
        self.fetch()
        return self.t_host

    def fetch(self) -> None:
        s = self.s
        with self.spans("fetch"):
            fb = s.fetch_framebuffer().cpu().numpy()
        self.t_host = time.perf_counter()
        spp = s.spp_map
        count = spp[::s.block_h, ::s.block_w].astype(np.int64)
        samples = int(spp.sum(dtype=np.int64))
        segs = s.segments_traced
        self.samples_fetched += samples
        self.answers += 1
        blocks = chk.Blocks(self.cursor.copy(), count, s.block_w, s.block_h, samples, self.asked)
        self.picker.offer(chk.Answer(self.view, sample_start=0, frames=0, spp=self.spp,
                                     segments=segs - self.segs_total, framebuffer=fb,
                                     blocks=blocks))
        self.cursor += count
        self.segs_total = segs

    def begin_window(self, picker: tr.Picker) -> None:
        self.picker, self.answers, self.samples_fetched = picker, 0, 0
        self.rounds = 0

    def counts(self) -> dict:
        return {"rounds": self.rounds}

    def close(self) -> None:
        """Nothing is left to fetch: every image ends in its fetch."""


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool, program: Program,
             backend: str = "cuda", on_session=None, trace_path: Optional[pathlib.Path] = None,
             reg: Optional[registry.Registry] = None, control: bool = False) -> dict:
    """Run ``cell`` once and return its result line as a dict.
    ``on_session`` (tests) may replace the session's methods before the
    warm-up; ``backend`` ``"torch"`` (tests) runs the program's plain
    integrator on the CPU. ``control`` (``benchmark/control.py``) adds the
    numbers of the control, the reference in bfloat16 put in the program's
    place, under ``control_checks``."""
    cfg, traffic = cell.config, cell.traffic
    width, height, depth = int(cfg["width"]), int(cfg["height"]), int(cfg["max_depth"])
    world = cell.world.build_world(cfg, program.api)
    views = cell.world.views(cfg, traffic, program.api)
    adaptive = tr.adaptive(traffic)
    if adaptive:
        # The CLI's --adaptive --spp S --frames N (cli.py:_run_adaptive).
        spp = int(traffic["samples_per_window"])
        rc = program.RenderConfig(width=width, height=height, samples_per_frame=spp,
                                  ray_depth=depth, seed=int(seed), backend=backend,
                                  frame_batch=int(traffic["windows_per_round"]),
                                  max_frames=int(traffic["budget_frames"]),
                                  nee=bool(cfg["nee"]))
        session = program.AdaptiveSession(world, rc, n_sel=int(traffic["blocks_per_round"]))
    else:
        spp = tr.samples_per_frame(traffic, cfg)
        rc = program.RenderConfig(width=width, height=height, samples_per_frame=spp,
                                  ray_depth=depth, seed=int(seed), backend=backend,
                                  frame_batch=int(traffic["frame_batch"]), nee=bool(cfg["nee"]))
        session = program.make_session(world, rc)
    if on_session is not None:
        on_session(session)
    device = session.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    spans = Spans()
    picker = tr.Picker(seed, traffic["check"]["answers"], traffic["check"]["pick"])
    view0 = tr.first_view(seed, len(views))
    if adaptive:
        loop = AdaptiveLoop(session, views, view0, spp,
                            int(traffic["budget_frames"]) * spp * width * height, spans,
                            tr.Picker(seed, 0, "last"))
        counter = program.adaptive_kernel
        launch_shape = types.SimpleNamespace(windows=session.windows, n_sel=session.n_sel,
                                             block_pixels=session.block_w * session.block_h)
        # Set-up's warm step: one whole image, through every call the window
        # makes.
        loop.unit()
    else:
        loop = Loop(session, traffic, views, view0, spp, width, height, spans,
                    tr.Picker(seed, 0, "last"))
        counter, launch_shape = program.kernel, None
        # Set-up's warm step, of the cell's own shape, through every call the
        # window makes; the published camera's reset leaves the window a clean
        # accumulation.
        if traffic["move_each_step"]:
            loop.move()
        loop.step()
        loop.fetch()
        if not traffic["move_each_step"]:
            loop.move(world.camera)
    _sync(device)
    loop.begin_window(picker)
    spans.rows.clear()
    launches0 = counter.launches
    count_keys = ("segs", "launches", *loop.counts())

    prof = profiling.Slice(device.type == "cuda") if trace else None
    if prof is not None:
        prof.warm()
    piece_at = min(profiling.START_S, 0.3 * seconds)
    pieces, piece = [], {}
    t0 = time.perf_counter()
    setup_s = process_age()
    deadline = t0 + seconds
    last_fetch = t0
    while time.perf_counter() < deadline:
        if prof is not None and not piece and time.perf_counter() - t0 >= piece_at \
                and sum(x["dev"].window_s for x in pieces) < profiling.MIN_S:
            _sync(device)
            piece = dict(segs=session.segments_traced, launches=counter.launches,
                         **loop.counts())
            prof.start()
            spans.marking = True
            piece["t0"] = time.perf_counter()
        last_fetch = loop.unit(last_fetch)
        if piece and (time.perf_counter() - piece["t0"] >= profiling.PIECE_S
                      or time.perf_counter() >= deadline):
            dev = prof.stop(trace_path.with_name(f"{trace_path.stem}.{len(pieces)}.json"))
            spans.marking = False
            piece.update(t1=time.perf_counter(), dev=dev,
                         segs=session.segments_traced - piece["segs"],
                         launches=counter.launches - piece["launches"],
                         **{k: v - piece[k] for k, v in loop.counts().items()})
            # A piece whose trace lost records of the card is left out.
            if not prof.cuda or dev.trace_events == piece["launches"]:
                pieces.append(piece)
            piece = {}
            piece_at = time.perf_counter() - t0 + profiling.PIECE_S
    loop.close()
    t_end = loop.t_host

    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    window = types.SimpleNamespace(
        seconds=t_end - t0, samples=loop.samples_fetched, answers=loop.answers,
        latencies=loop.latencies, setup_s=setup_s, launches=counter.launches - launches0,
        **loop.counts())
    answers = picker.answers()
    del session, loop, picker
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # The check, after the window and with the program's state freed.
    t_ref = time.perf_counter()
    ix, iy = tr.check_pixels(seed, width, height, traffic["check"]["pixels"])
    ref = chk.Reference(cfg, traffic, seed, device, world=cell.world, reference=cell.reference)
    reading = ref.read(answers, ix, iy, count=trace)
    nums = chk.numbers(answers, reading, ix, iy, width, height)
    checks = chk.verdict(nums, cell.limits)
    failed = sum(chk.max_abs_diff(chk.program_values([a], ix, iy), reading.values[i:i + 1])
                 > cell.limits["fb_max_abs_diff"] for i, a in enumerate(answers))
    reference_s = time.perf_counter() - t_ref
    control_checks = None
    if control:
        low = chk.Reference(cfg, traffic, seed, device, dtype=torch.bfloat16, world=cell.world,
                            reference=cell.reference)
        control_checks = chk.verdict(chk.control_numbers(low.read(answers, ix, iy), reading,
                                                         answers), cell.limits)

    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": device_name, "count": 1, "memory_peak_bytes": int(memory_peak)}
    reg = reg or registry.Registry(ROOT)
    out = {"correct": chk.passed(checks) and failed == 0,
           "attempted": int(window.answers), "failed": int(failed)}
    if not trace:
        ctx = types.SimpleNamespace(cell=cell.name, window=window)
        metrics = _read_metrics(reg, cell.end_to_end, ctx)
    else:
        # A trace without the card's activity has no device time to read.
        dev = profiling.merge([x["dev"] for x in pieces]) \
            if pieces and device.type == "cuda" else None
        counts = {k: sum(x[k] for x in pieces) for k in count_keys}
        tests = reading.tests
        ctx = types.SimpleNamespace(
            cell=cell.name, window=window, width=width, height=height, device_name=device_name,
            spans=_spans_outside(spans.rows, pieces), slice=dev,
            slice_counts=counts if dev is not None else None,
            tests=tests, reference_segments=reading.segments,
            tests_per_segment=({k: tests[k] / reading.segments for k in ("sphere", "triangle")}
                               if tests else None),
            table_bytes=ref.tables.table_bytes, adaptive=launch_shape)
        metrics = _read_metrics(reg, cell.per_layer, ctx)
        if dev is not None:
            device_info.update(busy_s=dev.busy_s, window_s=dev.window_s)
            out["breakdown"] = {"device_ops": dev.device_ops, "idle_gaps": dev.idle_gaps}
    if control_checks is not None:
        out["control_checks"] = control_checks
    out.update(metrics=metrics, device=device_info, reference_s=reference_s, checks=checks)
    return out


def _spans_outside(rows, pieces) -> dict:
    """Span durations in ms by name, outside the profiled pieces."""
    out = {}
    for name, a, b in rows:
        if any(a < x["t1"] and b > x["t0"] for x in pieces):
            continue
        out.setdefault(name, []).append((b - a) * 1e3)
    return out


def _read_metrics(reg: registry.Registry, entries: list, ctx) -> dict:
    out = {}
    for m in entries:
        value = reg.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def check_lines(checks: dict) -> list:
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    reg = registry.Registry(ROOT)
    cell = reg.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    try:
        program = load_program()
    except ImportError as e:
        print(f"benchmark: the program cannot be imported: {e}", file=sys.stderr)
        return 4
    trace_path = BUILD / "bench" / f"trace_{args.workload}.json"  # .<piece> before .json
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), program,
                   trace_path=trace_path, reg=reg)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of {found} are loaded in the process that reports",
              file=sys.stderr)
        return 5
    sys.stderr.flush()
    print("\n".join(check_lines(out["checks"])), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
