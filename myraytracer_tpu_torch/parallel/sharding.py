"""Rendering over several devices and processes.

Port of ``myraytracer_tpu.parallel.sharding``. Three strategies over a
``Mesh`` of devices:

* **tile sharding**: the image's rows are cut into one stripe an entry of
  the mesh; each entry traces its rows alone (no communication a bounce or
  a frame). ``ceil(H / n)`` rows a stripe, the last stripe takes the rows
  that are left, and a stripe with none is skipped: unlike the JAX
  package, which traces padded rows past the image and crops them, no row
  outside the image is traced, so the segment count equals the unsharded
  render's.
* **sample sharding**: every entry renders the whole image for a window of
  ``ceil(spp / n)`` samples (the last windows may be short or empty; an
  empty one is skipped); the partial sums add up in mesh order, and across
  processes with an ``all_reduce``.
* **hybrid**: a 2-D ``("tiles", "samples")`` mesh, rows over the first
  axis and sample windows over the second.

The sample stream is counter-based and keyed on the global (pixel, sample)
pair, so a tile-sharded render is bitwise the unsharded one (K frames in
one launch included); the sample and hybrid sums differ from it only by
f32 reduction order.

A ``Mesh`` is a grid of ``torch.device``s with axis names. A device may
appear more than once: each entry is then a shard that the device renders
in turn, one block-renderer call (one kernel launch on ``cuda``) an entry.
That is how one GPU (or the CPU) runs several stripes. The scene and its
gate tables are placed once on each distinct device; a launch runs with its
device current (``torch.cuda.device``), since the kernels size their grid
and shared memory from the current device.

Several processes (``initialize_multihost``, the CLI's ``--multihost``):
each rank owns an equal run of the mesh's entries and renders only those.
A tile-sharded frame stays split: each rank holds the framebuffer's shape
with only its stripes' rows rendered, and ``fetch_array`` assembles the
image with an ``all_gather`` that every rank must join (as every read of
``segments_traced``, an ``all_reduce``, is). Sample and hybrid sums are
``all_reduce``d a step, so every rank holds the whole image. The
collectives run on ``nccl`` when every rank on the host has a card of its
own, else on ``gloo`` through host memory (``collective_backend``).
"""

from __future__ import annotations

import contextlib
import ipaddress
import logging
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

log = logging.getLogger("myraytracer_tpu_torch")


# -- processes ----------------------------------------------------------------


class Process(NamedTuple):
    """This process's place in a multi-process run."""

    rank: int
    world: int
    backend: str  # "nccl" or "gloo"
    device: torch.device  # the rank's card, or the CPU

    @property
    def comm_device(self) -> torch.device:
        """Where collectives take their tensors: gloo reduces CUDA tensors
        but gathers only host tensors, so it gets host tensors throughout."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


_PROCESS: Optional[Process] = None


def process() -> Optional[Process]:
    """This process's ``Process`` after ``initialize_multihost``, else None."""
    return _PROCESS


def parse_multihost_spec(spec: str) -> dict:
    """Parse ``coordinator:port[,num_processes,process_id]`` into the JAX
    package's keyword names ({} = take everything from the environment
    that ``torchrun`` sets)."""
    if not spec:
        return {}
    parts = spec.split(",")
    if len(parts) == 1:
        return {"coordinator_address": parts[0]}
    if len(parts) == 3:
        return {
            "coordinator_address": parts[0],
            "num_processes": int(parts[1]),
            "process_id": int(parts[2]),
        }
    raise ValueError(
        f"multihost spec {spec!r}: want 'host:port' or 'host:port,nprocs,pid'"
    )


def _is_loopback(host: str) -> bool:
    host = host.strip("[]")
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def process_group_args(spec: dict, env=os.environ) -> dict:
    """``torch.distributed.init_process_group`` arguments of a parsed spec:
    the coordinator as a ``tcp://`` address, with the world size and rank
    from the spec or, where it gives none, from ``WORLD_SIZE`` and
    ``RANK``; no coordinator means ``env://`` (``torchrun``'s
    ``MASTER_ADDR`` and ``MASTER_PORT``)."""
    if "coordinator_address" not in spec:
        return {"init_method": "env://"}
    return {
        "init_method": f"tcp://{spec['coordinator_address']}",
        "world_size": int(spec.get("num_processes", env.get("WORLD_SIZE", 1))),
        "rank": int(spec.get("process_id", env.get("RANK", 0))),
    }


def local_layout(spec: dict, env=os.environ):
    """(local rank, ranks on this host): ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` where ``torchrun`` sets them; else, for a
    coordinator on a loopback address (every rank on this host), the
    spec's process id and count; else one rank a host."""
    if "LOCAL_RANK" in env and "LOCAL_WORLD_SIZE" in env:
        return int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"])
    addr = spec.get("coordinator_address", env.get("MASTER_ADDR", ""))
    if _is_loopback(addr.rsplit(":", 1)[0] if ":" in addr else addr):
        args = process_group_args(spec, env)
        return int(args.get("rank", env.get("RANK", 0))), int(
            args.get("world_size", env.get("WORLD_SIZE", 1)))
    return 0, 1


def collective_backend(device_type: str, ranks_on_host: int, cards_on_host: int) -> str:
    """``nccl`` when the ranks render on CUDA cards and every rank on the
    host has a card of its own; ``gloo`` otherwise (NCCL refuses two ranks
    on one card, and the CPU has no NCCL)."""
    if device_type == "cuda" and 0 < ranks_on_host <= cards_on_host:
        return "nccl"
    return "gloo"


def initialize_multihost(spec: str = "", device_type: Optional[str] = None) -> Process:
    """Join a multi-process run: ``torch.distributed.init_process_group``.

    Must run before the first device use. ``device_type`` is where this
    rank renders (``cuda`` when a GPU is present, unless given): on
    ``cuda`` the rank takes card ``local rank % device_count`` and makes it
    current. After this, ``default_mesh`` and ``hybrid_mesh`` span every
    rank, one entry a rank. The backend follows ``collective_backend`` and
    is logged; a failure raises, with no retry on another backend.
    """
    global _PROCESS
    import torch.distributed as dist

    kw = parse_multihost_spec(spec)
    args = process_group_args(kw)
    local_rank, ranks_on_host = local_layout(kw)
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda":
        if cards == 0:
            raise RuntimeError("multihost on cuda: torch.cuda.is_available() is False")
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend = collective_backend(device_type, ranks_on_host, cards)
    dist.init_process_group(backend, **args)
    _PROCESS = Process(dist.get_rank(), dist.get_world_size(), backend, device)
    log.info(
        "multihost: rank %d of %d (local rank %d of %d) on %s, collectives on %s "
        "(%d card(s) on the host)", _PROCESS.rank, _PROCESS.world, local_rank,
        ranks_on_host, device, backend, cards,
    )
    return _PROCESS


def shutdown_multihost() -> None:
    """Leave the process group that ``initialize_multihost`` joined."""
    global _PROCESS
    if _PROCESS is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
        _PROCESS = None


# -- meshes -------------------------------------------------------------------


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Devices on named axes: the port's ``jax.sharding.Mesh``.

    ``devices`` is an object array of ``torch.device`` whose shape gives the
    axes; entries are numbered in row-major order. Under several processes
    (``proc``, by default ``process()``) rank r owns the entries
    ``[r * size / world, (r + 1) * size / world)``.
    """

    def __init__(self, devices, axis_names: Sequence[str], proc: Optional[Process] = None):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"axis names {self.axis_names} for a mesh of shape "
                             f"{self.devices.shape}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.proc = proc if proc is not None else process()
        world = self.proc.world if self.proc else 1
        if self.size % world:
            raise ValueError(f"a mesh of {self.size} entries over {world} processes")
        self._per_rank = self.size // world
        rank = self.proc.rank if self.proc else 0
        self.local = tuple(range(rank * self._per_rank, (rank + 1) * self._per_rank))

    def owner(self, entry: int) -> int:
        """The rank that renders ``entry``."""
        return entry // self._per_rank

    def device_of(self, entry: int) -> torch.device:
        return self.devices.flat[entry]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"


def local_devices(device_type: Optional[str] = None):
    """The devices this process renders on: under ``initialize_multihost``
    its one device; else every CUDA card for ``cuda`` (the default when a
    GPU is present), or the CPU."""
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    proc = process()
    if proc is not None:
        if proc.device.type != device_type:
            raise ValueError(f"this rank renders on {proc.device}, not {device_type}")
        return [proc.device]
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA GPU; torch.cuda.is_available() "
                               "is False")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def global_devices(device_type: Optional[str] = None):
    """Every rank's ``local_devices``, in rank order (a collective under
    ``initialize_multihost``)."""
    mine = local_devices(device_type)
    proc = process()
    if proc is None:
        return mine
    import torch.distributed as dist

    gathered = [None] * proc.world
    dist.all_gather_object(gathered, [str(d) for d in mine])
    return [torch.device(d) for part in gathered for d in part]


def default_mesh(devices: Optional[Sequence] = None, axis: str = "tiles",
                 device_type: Optional[str] = None) -> Mesh:
    """A 1-D mesh over ``devices`` (default: ``global_devices``)."""
    devices = list(devices if devices is not None else global_devices(device_type))
    return Mesh(devices, (axis,))


def hybrid_mesh(devices: Optional[Sequence] = None, samples: Optional[int] = None,
                device_type: Optional[str] = None) -> Mesh:
    """2-D (tiles x samples) mesh over ``devices`` (default:
    ``global_devices``).

    ``samples=None`` picks 2 when the device count is even and above 1
    (rows stay the long axis: tile sharding needs no communication), else 1.
    """
    devs = list(devices if devices is not None else global_devices(device_type))
    n = len(devs)
    if samples is None:
        samples = 2 if n % 2 == 0 and n > 1 else 1
    if samples < 1 or n % samples:
        raise ValueError(f"samples axis {samples} must divide {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(n // samples, samples), ("tiles", "samples"))


# -- collectives ----------------------------------------------------------------


class Rows(NamedTuple):
    """How axis 0 of a tensor splits over a mesh's entries: entry ``i``
    holds ``[bounds[i][0], bounds[i][1])``. Under several processes each
    rank holds the tensor's whole shape, but only its own entries' rows."""

    mesh: Mesh
    bounds: tuple


def fetch_array(x, rows: Optional[Rows] = None) -> np.ndarray:
    """The whole of ``x`` on this host, as numpy.

    A tensor that one process holds whole (``rows`` None, or one process)
    is a plain copy to the host. One split by ``rows`` across processes is
    assembled from every rank's own rows with an ``all_gather``: a
    collective, so every rank must call it at the same point.
    """
    if isinstance(x, np.ndarray):
        return x
    if rows is None or rows.mesh.proc is None:
        return x.detach().cpu().numpy()
    import torch.distributed as dist

    mesh, proc = rows.mesh, rows.mesh.proc
    owned = [[i for i in range(mesh.size) if mesh.owner(i) == r] for r in range(proc.world)]
    count = [sum(rows.bounds[i][1] - rows.bounds[i][0] for i in ent) for ent in owned]
    n_max = max(count)
    dev = proc.comm_device
    buf = torch.zeros((n_max,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
    at = 0
    for i in owned[proc.rank]:
        lo, hi = rows.bounds[i]
        buf[at:at + hi - lo] = x[lo:hi].to(dev)
        at += hi - lo
    parts = [torch.empty_like(buf) for _ in range(proc.world)]
    dist.all_gather(parts, buf)
    parts = [p.cpu().numpy() for p in parts]
    out = np.zeros(tuple(x.shape), dtype=parts[0].dtype)
    for part, ent in zip(parts, owned):
        at = 0
        for i in ent:
            lo, hi = rows.bounds[i]
            out[lo:hi] = part[at:at + hi - lo]
            at += hi - lo
    return out


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the mesh's processes (``x`` itself with one
    process), on ``x``'s device. Every rank must call it at the same
    point."""
    if mesh is None or mesh.proc is None:
        return x
    import torch.distributed as dist

    buf = x.to(mesh.proc.comm_device).contiguous()
    if buf.data_ptr() == x.data_ptr():
        buf = buf.clone()
    dist.all_reduce(buf)
    return buf.to(x.device)


def total_segments(pending, mesh: Optional[Mesh]) -> float:
    """The sum of per-step segment counts ``pending`` (f64 scalars on one
    device): this process's, and under several processes every rank's (an
    ``all_reduce`` that every rank must join)."""
    local = torch.stack(pending).sum() if pending else torch.zeros((), dtype=torch.float64)
    return float(all_reduce_sum(local, mesh).item())


# -- renderers ----------------------------------------------------------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _device_type(block_factory) -> Optional[str]:
    """The device type of a named block factory's default mesh."""
    if block_factory == "torch":
        return "cpu"
    if block_factory == "cuda":
        return "cuda"
    return None


def _resolve_block_factory(block_factory):
    """The block implementation: ``cuda`` (the kernel, ``kernels.trace``),
    ``torch`` (the plain integrator) or a callable; None means ``cuda``, as
    the port's ``auto`` does. Both consume the same sample stream."""
    if callable(block_factory):
        return block_factory
    if block_factory in (None, "cuda"):
        from myraytracer_tpu_torch.kernels.trace import make_block_renderer

        return make_block_renderer
    if block_factory == "torch":
        from myraytracer_tpu_torch.render.integrator import make_block_renderer

        return make_block_renderer
    raise ValueError(f"unknown block factory {block_factory!r}: use cuda|torch|a callable")


def _to_device(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        items = [_to_device(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device for a launch (a no-op off CUDA)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class Placement:
    """A compiled scene on the devices of a mesh: ``place(scene, dev)`` is
    the scene itself on its own device, else a copy made once a scene and
    device (the runtime camera copied each call)."""

    def __init__(self):
        self.key = None
        self.copies = {}

    def __call__(self, scene, dev: torch.device):
        if scene.device == dev:
            return scene
        if self.key is not scene.radius:
            self.key, self.copies = scene.radius, {}
        if dev not in self.copies:
            self.copies[dev] = _to_device(scene._replace(cam=None), dev)
        return self.copies[dev]._replace(cam=None if scene.cam is None else scene.cam.to(dev))


class _Shards:
    """A sharded renderer's per-device parts: the scene's ``Placement`` and
    one block renderer a (device, rows, samples) triple, each with its own
    table cache."""

    def __init__(self, factory, cam, width, height, ray_depth, kw):
        self.factory, self.cam, self.width, self.height = factory, cam, width, height
        self.ray_depth, self.kw = ray_depth, kw
        self.blocks = {}
        self.place = Placement()

    def block(self, dev: torch.device, n_rows: int, max_samples: int):
        k = (dev, n_rows, max_samples)
        if k not in self.blocks:
            self.blocks[k] = self.factory(self.cam, self.width, self.height, n_rows,
                                          max_samples, self.ray_depth, **self.kw)
        return self.blocks[k]

    def render(self, entry_dev, scene, key, row0, n_rows, max_samples, sample_start, n_valid):
        """One block call on ``entry_dev``: ``(sum, segments f64 scalar)`` on
        the scene's device."""
        with on_device(entry_dev):
            img, segs = self.block(entry_dev, n_rows, max_samples)(
                self.place(scene, entry_dev), key, row0, sample_start, n_valid)
        return img.to(scene.device), segs.sum(dtype=torch.float64).to(scene.device)


def _block_kwargs(t_min, t_max, sample_batch, material_set, sky, nee_lights, texture_set,
                  qmc, rr, frames=1):
    kw = dict(t_min=t_min, t_max=t_max, sample_batch=sample_batch,
              material_set=material_set, sky=sky, nee_lights=nee_lights,
              texture_set=texture_set, qmc=qmc, rr=rr)
    if frames > 1:
        kw["frames"] = frames
    return kw


def _refuse_frames(frames: int) -> None:
    if frames > 1:
        raise ValueError(
            "frame batching requires shard 'tiles' or 'none': a sample-sharded "
            "device's window is not contiguous across frame buckets"
        )


def row_bounds(height: int, n: int):
    """Stripe ``i`` of ``n``: rows ``[i * ceil(H/n), (i+1) * ceil(H/n))`` cut
    at the image's edge (empty past it)."""
    per = _ceil_div(height, n)
    return tuple((min(i * per, height), min((i + 1) * per, height)) for i in range(n))


def sample_windows(spp: int, n: int):
    """Window ``i`` of ``n``: (offset, count) with ``ceil(spp/n)`` samples a
    window, clipped at ``spp`` (count 0 past it)."""
    per = _ceil_div(spp, n)
    return tuple((i * per, max(0, min(per, spp - i * per))) for i in range(n))


def make_tile_sharded_renderer(
    cam, width: int, height: int, samples_per_frame: int, ray_depth: int,
    t_min: float = 1e-3, t_max: float = 1e4, sample_batch: int = 1,
    mesh: Optional[Mesh] = None, material_set=None, static_ior=None, sky=None,
    nee_lights=None, block_factory=None, frames: int = 1, texture_set=None,
    qmc: bool = False, rr: int = 0,
):
    """Image rows over the mesh's entries; each entry renders its stripe.

    ``render(scene, key, sample_base) -> (image, segments)``: ``image`` is
    ``[H, W, 3]``, or ``[K, 3, H, W]`` per-frame means with ``frames = K >
    1`` (each stripe's K frames from one block call), bitwise the unsharded
    renderer's; ``segments`` (f64) counts this process's stripes.
    ``render.rows`` says which rows each entry renders (``fetch_array``).
    """
    del static_ior  # the port's kernels read the IOR off the scene
    factory = _resolve_block_factory(block_factory)
    mesh = mesh or default_mesh(device_type=_device_type(block_factory))
    nd = mesh.shape[mesh.axis_names[0]]
    spp, frames = int(samples_per_frame), int(frames)
    bounds = row_bounds(height, nd)
    shards = _Shards(factory, cam, width, height, ray_depth, _block_kwargs(
        t_min, t_max, sample_batch, material_set, sky, nee_lights, texture_set, qmc, rr,
        frames))

    def render(scene, key, sample_base):
        shape = (height, width, 3) if frames == 1 else (frames, 3, height, width)
        out = torch.zeros(shape, dtype=torch.float32, device=scene.device)
        segs = torch.zeros((), dtype=torch.float64, device=scene.device)
        for i in mesh.local:
            lo, hi = bounds[i]
            if hi == lo:  # a stripe past the image's last row
                continue
            img, sg = shards.render(mesh.device_of(i), scene, key, lo, hi - lo, spp,
                                    int(sample_base), frames * spp)
            if frames == 1:
                out[lo:hi] = img
            else:
                out[:, :, lo:hi] = img
            segs = segs + sg
        return out * (1.0 / spp), segs

    render.mesh, render.rows = mesh, Rows(mesh, bounds)
    return render


def make_sample_sharded_renderer(
    cam, width: int, height: int, samples_per_frame: int, ray_depth: int,
    t_min: float = 1e-3, t_max: float = 1e4, sample_batch: int = 1,
    mesh: Optional[Mesh] = None, material_set=None, static_ior=None, sky=None,
    nee_lights=None, block_factory=None, frames: int = 1, texture_set=None,
    qmc: bool = False, rr: int = 0,
):
    """Each entry renders the whole image for its window of samples; the
    partial sums add up in mesh order (an ``all_reduce`` across
    processes). ``segments`` counts this process's windows."""
    _refuse_frames(frames)
    del static_ior
    factory = _resolve_block_factory(block_factory)
    mesh = mesh or default_mesh(axis="samples", device_type=_device_type(block_factory))
    nd = mesh.shape[mesh.axis_names[0]]
    spp = int(samples_per_frame)
    windows = sample_windows(spp, nd)
    per_dev = _ceil_div(spp, nd)
    shards = _Shards(factory, cam, width, height, ray_depth, _block_kwargs(
        t_min, t_max, sample_batch, material_set, sky, nee_lights, texture_set, qmc, rr))

    def render(scene, key, sample_base):
        total = torch.zeros((height, width, 3), dtype=torch.float32, device=scene.device)
        segs = torch.zeros((), dtype=torch.float64, device=scene.device)
        for i in mesh.local:
            off, n = windows[i]
            if n == 0:  # a window past the frame's last sample
                continue
            img, sg = shards.render(mesh.device_of(i), scene, key, 0, height, per_dev,
                                    int(sample_base) + off, n)
            total, segs = total + img, segs + sg
        return all_reduce_sum(total, mesh) * (1.0 / spp), segs

    render.mesh, render.rows = mesh, None
    return render


def make_hybrid_sharded_renderer(
    cam, width: int, height: int, samples_per_frame: int, ray_depth: int,
    t_min: float = 1e-3, t_max: float = 1e4, sample_batch: int = 1,
    mesh: Optional[Mesh] = None, material_set=None, static_ior=None, sky=None,
    nee_lights=None, block_factory=None, frames: int = 1, texture_set=None,
    qmc: bool = False, rr: int = 0,
):
    """2-D mesh: rows over ``"tiles"``, sample windows over ``"samples"``.

    Entry (t, s) traces stripe t for window s; each stripe's windows add
    up in mesh order, and across processes the frame is ``all_reduce``d.
    The 1-D renderers are its degenerate cases.
    """
    _refuse_frames(frames)
    del static_ior
    factory = _resolve_block_factory(block_factory)
    if mesh is None:
        mesh = hybrid_mesh(device_type=_device_type(block_factory))
    nd_t, nd_s = mesh.shape["tiles"], mesh.shape["samples"]
    spp = int(samples_per_frame)
    bounds, windows = row_bounds(height, nd_t), sample_windows(spp, nd_s)
    per_dev = _ceil_div(spp, nd_s)
    shards = _Shards(factory, cam, width, height, ray_depth, _block_kwargs(
        t_min, t_max, sample_batch, material_set, sky, nee_lights, texture_set, qmc, rr))

    def render(scene, key, sample_base):
        out = torch.zeros((height, width, 3), dtype=torch.float32, device=scene.device)
        segs = torch.zeros((), dtype=torch.float64, device=scene.device)
        stripes = {}
        for i in mesh.local:
            t, s = divmod(i, nd_s)
            (lo, hi), (off, n) = bounds[t], windows[s]
            if hi == lo or n == 0:
                continue
            img, sg = shards.render(mesh.device_of(i), scene, key, lo, hi - lo, per_dev,
                                    int(sample_base) + off, n)
            stripes[t] = img if t not in stripes else stripes[t] + img
            segs = segs + sg
        for t, img in stripes.items():
            out[bounds[t][0]:bounds[t][1]] = img
        return all_reduce_sum(out, mesh) * (1.0 / spp), segs

    render.mesh, render.rows = mesh, None
    return render


def shard_renderer_factory(base_factory, mode: str, mesh: Optional[Mesh] = None,
                           block_factory=None):
    """Adapt a sharding mode to the ``RenderSession`` renderer-factory
    protocol. ``base_factory`` is accepted for the JAX package's interface
    (the sharded renderers build on block renderers); ``block_factory``
    picks each entry's implementation (``cuda``, ``torch``, a callable, or
    None = ``cuda``)."""
    del base_factory
    makers = {"tiles": make_tile_sharded_renderer, "samples": make_sample_sharded_renderer,
              "hybrid": make_hybrid_sharded_renderer}
    if mode not in makers:
        raise ValueError(f"unknown shard mode {mode!r}")
    maker = makers[mode]

    def factory(cam, width, height, samples_per_frame, ray_depth, **kw):
        return maker(cam, width, height, samples_per_frame, ray_depth, mesh=mesh,
                     block_factory=block_factory, **kw)

    return factory
