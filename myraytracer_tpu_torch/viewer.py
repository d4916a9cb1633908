"""Live progressive-render viewer over HTTP.

Port of ``myraytracer_tpu.viewer``. The reference ships a browser runner: a
wasm module driving the renderer into a full-window canvas served from a
static page (``index.html:22-36``, ``wasm-runner/src/lib.rs:47-94``), with
render parameters parseable from the URL query string. Here the render loop
stays on the host next to the GPU, and the *viewer* is the browser: a tiny
stdlib HTTP server that serves the progressively accumulating framebuffer
as a PNG behind an auto-refreshing page. ``python -m myraytracer_tpu_torch
--serve PORT`` is the counterpart of opening the reference's deployed page.

Endpoints:

* ``/``           — viewer page (auto-refreshes the image; shows stats).
                    Render parameters parse from the URL query exactly
                    like the reference's web runner
                    (``wasm-runner/src/lib.rs:72-77,87-94``):
                    ``?width=&height=&samples_per_frame=&ray_depth=&``
                    ``max_framebuffer_weight=&scene=&seed=`` queue a
                    session rebuild (the render loop polls
                    ``pending_session()``), ``?width=0&height=0`` follows
                    the browser window (the page measures the viewport and
                    re-navigates — the reference's both-zero size rule,
                    ``lib.rs:149-154``), ``?log_level=`` adjusts the
                    process log level (``lib.rs:49-67``), and out-of-bounds
                    magnitudes are rejected with 400 (``SESSION_BOUNDS``).
* ``/frame.png``  — the latest accumulated frame, gamma-encoded PNG
* ``/stats.json`` — frame count, accumulated spp, image size
* ``/set``        — camera control (``?yaw=&pitch=&dist=`` radians/units);
                    the page sends these on mouse drag / wheel, the render
                    loop polls ``pending_camera()`` between frames and
                    re-packs the runtime camera operand (no rebuild of the
                    kernel or its tables — see render/camera.pack_camera). Going one better than
                    the reference: its window has no camera controls at
                    all (camera fixed, shader.wgsl:360-361).

Thread-safety: a frame is published by swapping attributes under a lock;
the request handler only reads them. The PNG encode runs on the caller's
thread or, with ``update(..., background=True)``, on the viewer's encoder
thread, so that the render loop does not wait for it. What the handler threads serve is host data the
render loop published (PNG ``bytes``, a stats dict of Python numbers): no
request thread touches a CUDA tensor. The server runs on a daemon thread
and never blocks the render loop.
"""

from __future__ import annotations

import json
import logging
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np

from myraytracer_tpu_torch.output.image import encode_png, to_u8

log = logging.getLogger("myraytracer_tpu_torch.viewer")

# URL-query render parameters (name → parser), mirroring the reference's
# Args-from-query-string (wasm-runner/src/lib.rs:7-15,72-77): the five
# reference knobs plus the scene/seed extensions.
SESSION_PARAMS = {
    "width": int,
    "height": int,
    "samples_per_frame": int,
    "ray_depth": int,
    "max_framebuffer_weight": float,
    "scene": str,
    "seed": int,
    # ?nee=1 toggles next-event estimation (render/lights.py).
    "nee": lambda s: s.lower() not in ("0", "false", ""),
    # ?qmc=1 toggles low-discrepancy camera sampling (core/rng.py).
    "qmc": lambda s: s.lower() not in ("0", "false", ""),
    # ?denoise=N: 0 turns the à-trous output filter off, N>=1 sets its
    # iteration count, 'auto' (sentinel -1) schedules it from the
    # accumulated spp (render/denoise.py:auto_iterations; a display
    # transform — accumulation/checkpoint state is unaffected live).
    "denoise": lambda s: -1 if s.strip().lower() == "auto" else int(s),
}

# Magnitude bounds on viewer-requested rebuilds. The serving loop rebuilds
# sessions (their tables on the card) on request; without bounds a stray
# browser tab asking for ?width=16384&samples_per_frame=10000 triggers an
# unbounded rebuild/allocation inside the loop. Within these bounds any request
# costs at most one modest rebuild. 0 stays legal for width/height (the
# reference's 0-means-derive rule, lib.rs:113-134).
SESSION_BOUNDS = {
    "width": (0, 4096),
    "height": (0, 4096),
    "samples_per_frame": (1, 4096),
    # Any u32 depth renders (paged draw keys, core/rng.py), but viewer
    # rebuilds are cost-bounded: depth multiplies worst-case kernel time.
    "ray_depth": (1, 1024),
    "max_framebuffer_weight": (0.0, 1.0),
    # Filter support doubles per iteration; 12 covers any sane display.
    # -1 is the ?denoise=auto sentinel (spp-scheduled iterations).
    "denoise": (-1, 12),
}
# Bound on the *resolved* pixel count (the per-dimension bounds alone
# admit 4096x4096 ≈ 16.8M pixels — 4x the budget).
MAX_PIXELS = 4 << 20


def validate_config_bounds(config) -> None:
    """Reject a viewer-requested config that would stall the serving loop.

    Raises ValueError (the serving loop's reject-and-keep-serving error
    class) on out-of-bounds values. Checked against the merged config, not
    the raw query, so e.g. ?width=4096 alone cannot combine with an
    already-large height into an over-budget framebuffer.
    """
    for k, (lo, hi) in SESSION_BOUNDS.items():
        # Non-config knobs (e.g. denoise) are bounded at query-parse time.
        v = getattr(config, k, None)
        if v is not None and not lo <= v <= hi:
            raise ValueError(f"{k}={v} outside viewer bounds [{lo}, {hi}]")
    w, h = config.resolve_size()
    if w * h > MAX_PIXELS:
        raise ValueError(
            f"{w}x{h} = {w * h} pixels exceeds the viewer bound {MAX_PIXELS}"
        )

_PAGE = b"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>myraytracer_tpu_torch live view</title>
<style>
  body { margin: 0; background: #111; color: #ddd;
         font: 13px/1.4 system-ui, sans-serif; }
  img  { display: block; margin: 0 auto; image-rendering: pixelated;
         max-width: 100vw; max-height: 92vh; }
  #bar { padding: 6px 10px; }
</style>
</head>
<body>
<div id="bar">myraytracer_tpu_torch &mdash; <span id="stats">connecting&hellip;</span>
  <button id="dn" title="toggle the a-trous output filter (display only)">denoise: &hellip;</button>
  <span id="aovs"></span>
  <span id="hint" style="color:#777"> &mdash; drag to orbit, wheel to zoom</span></div>
<img id="frame" src="/frame.png" draggable="false">
<script>
  // ?width=0&height=0 = follow the window, the reference's size rule
  // (raytracer/src/lib.rs:149-154): measure the viewport client-side and
  // re-navigate with concrete values (the server skips the both-zero
  // request, so exactly one rebuild happens, at the measured size).
  {
    const p = new URLSearchParams(location.search);
    if (p.get("width") === "0" && p.get("height") === "0") {
      p.set("width", Math.min(4096, Math.max(8, window.innerWidth | 0)));
      p.set("height", Math.min(4096, Math.max(8,
        Math.floor(window.innerHeight * 0.92))));
      location.replace(location.pathname + "?" + p);
    }
  }
  const img = document.getElementById("frame");
  const stats = document.getElementById("stats");
  const dnBtn = document.getElementById("dn");
  let dnState = 0;  // last server-reported iteration count (0 = off)
  let dnAuto = false;  // spp-scheduled filter armed (count may be 0)
  async function tick() {
    try {
      const s = await (await fetch("/stats.json")).json();
      stats.textContent = `${s.width}x${s.height}  frame ${s.frame}  ` +
                          `${s.spp} spp accumulated`;
      dnState = s.denoise | 0;
      dnAuto = !!s.denoise_auto;
      dnBtn.textContent = dnAuto
        ? `denoise: auto (${dnState} iters` +
          (s.denoise_noise != null ? `, noise ${s.denoise_noise}` : "") + `)`
        : (dnState ? `denoise: ${dnState} iters` : "denoise: off");
      // Published AOV guide buffers (--aov with --serve): link them.
      const aovSpan = document.getElementById("aovs");
      const names = s.aovs || [];
      if (aovSpan.childElementCount !== names.length) {
        aovSpan.innerHTML = names.map(n =>
          ` <a href="/aov/${n}.png" target="_blank"
               style="color:#8ab">${n}</a>`).join("");
      }
      img.src = "/frame.png?f=" + s.frame;  // cache-bust per frame
    } catch (e) { stats.textContent = "render loop finished"; }
  }
  setInterval(tick, 500);
  tick();

  // Denoise is a display transform: the toggle query swaps the output
  // filter server-side without touching the accumulation (cli.py's
  // denoise-only session-request path). 5 = render/denoise.py default.
  dnBtn.addEventListener("click", () => {
    fetch(`/?denoise=${(dnState || dnAuto) ? 0 : 5}`).catch(() => {});
  });

  // Camera controls: spherical orbit about the scene's look-at point.
  // The render loop polls /set's latest value between frames and repacks
  // the kernel's runtime camera operand (no rebuild).
  let yaw = 0.0, pitch = 0.0, dist = 1.0, dragging = false, px = 0, py = 0;
  let dirty = false;
  img.addEventListener("mousedown", e => { dragging = true; px = e.clientX; py = e.clientY; });
  window.addEventListener("mouseup", () => { dragging = false; });
  window.addEventListener("mousemove", e => {
    if (!dragging) return;
    yaw   += (e.clientX - px) * 0.01;
    pitch += (e.clientY - py) * 0.01;
    pitch = Math.max(-1.3, Math.min(1.3, pitch));
    px = e.clientX; py = e.clientY; dirty = true;
  });
  img.addEventListener("wheel", e => {
    e.preventDefault();
    dist *= Math.exp(e.deltaY * 0.001);
    dist = Math.max(0.05, Math.min(20.0, dist)); dirty = true;
  }, { passive: false });
  setInterval(() => {
    if (!dirty) return;
    dirty = false;
    fetch(`/set?yaw=${yaw}&pitch=${pitch}&dist=${dist}`).catch(() => {});
  }, 100);
</script>
</body>
</html>
"""


class LiveViewer:
    """Serve the accumulating framebuffer at ``http://localhost:port/``."""

    def __init__(self, port: int, gamma=2.0, exposure: float = 1.0):
        # String transfers pass through verbatim ('srgb', 'aces' — already
        # validated by parse_gamma); anything else is a float exponent.
        self.gamma = gamma if isinstance(gamma, str) else float(gamma)
        self.exposure = float(exposure)
        self._lock = threading.Lock()
        self._png = encode_png(np.zeros((1, 1, 3), np.uint8))
        self._aovs = {}
        self._aov_names = []
        self._stats = {"frame": 0, "spp": 0, "width": 0, "height": 0}
        self._camera_request = None  # latest /set payload, consumed by poll
        self._session_request = None  # latest /?param= payload, ditto

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                path, _, query = self.path.partition("?")
                if path == "/":
                    if query:
                        q = parse_qs(query)
                        if "log_level" in q:
                            # ?log_level= parity (wasm-runner lib.rs:49-67)
                            lv = getattr(
                                logging, q["log_level"][0].upper(), None
                            )
                            if isinstance(lv, int):
                                logging.getLogger("myraytracer_tpu_torch").setLevel(lv)
                        req = {}
                        for k, conv in SESSION_PARAMS.items():
                            if k in q:
                                try:
                                    req[k] = conv(q[k][0])
                                except ValueError:
                                    self.send_error(400, f"bad {k}")
                                    return
                                lo_hi = SESSION_BOUNDS.get(k)
                                if lo_hi and not (
                                    lo_hi[0] <= req[k] <= lo_hi[1]
                                ):
                                    log.warning(
                                        "viewer query rejected: %s=%s "
                                        "outside %s", k, req[k], lo_hi,
                                    )
                                    self.send_error(
                                        400,
                                        f"{k}={req[k]} outside bounds "
                                        f"[{lo_hi[0]}, {lo_hi[1]}]",
                                    )
                                    return
                        if req.get("width") == 0 and req.get("height") == 0:
                            # Both-zero = follow the window (lib.rs:149-154):
                            # the page script measures the viewport and
                            # re-navigates with concrete values; don't
                            # rebuild at the headless default meanwhile.
                            req.pop("width")
                            req.pop("height")
                        if req:
                            with viewer._lock:
                                viewer._session_request = req
                    body, ctype = _PAGE, "text/html; charset=utf-8"
                elif path == "/set":
                    q = parse_qs(query)
                    try:
                        req = {
                            k: float(q[k][0])
                            for k in ("yaw", "pitch", "dist") if k in q
                        }
                    except ValueError:
                        self.send_error(400)
                        return
                    # A camera move resets the accumulation, so reject
                    # requests that would poison or pointlessly clear it:
                    # non-finite values (float('nan') parses fine) and
                    # empty queries.
                    if not req or any(not math.isfinite(v)
                                      for v in req.values()):
                        self.send_error(400, "finite yaw/pitch/dist required")
                        return
                    with viewer._lock:
                        viewer._camera_request = req
                    body, ctype = b"{}", "application/json"
                elif path == "/frame.png":
                    with viewer._lock:
                        body = viewer._png
                    ctype = "image/png"
                elif path == "/stats.json":
                    with viewer._lock:
                        body = json.dumps(viewer._stats).encode()
                    ctype = "application/json"
                elif path.startswith("/aov/") and path.endswith(".png"):
                    # Live guide-buffer inspection: /aov/<name>.png for
                    # whatever the CLI published via set_aovs (--aov
                    # with --serve). 404 for unpublished channels.
                    name = path[len("/aov/"):-len(".png")]
                    with viewer._lock:
                        body = viewer._aovs.get(name)
                    if body is None:
                        self.send_error(404, f"aov {name!r} not published")
                        return
                    ctype = "image/png"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet: the render log owns stdout
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]  # resolved if port was 0
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="live-viewer", daemon=True
        )
        self._thread.start()
        # The encoder thread: a frame handed over with update(...,
        # background=True) is encoded there while the render loop goes on
        # queueing work for the GPU (at 1200x800 the encode takes as long as
        # some fifty frames of `final` at spp 1 on an H100). Only the latest
        # frame waits; one the encoder has not started is replaced.
        self._jobs = threading.Condition()
        self._job = None
        self._encoding = False
        self._closed = False
        self._encoder = threading.Thread(
            target=self._encode_loop, name="live-viewer-encoder", daemon=True
        )
        self._encoder.start()
        log.info("live viewer at http://localhost:%d/", self.port)

    def _encode_loop(self) -> None:
        while True:
            with self._jobs:
                while self._job is None and not self._closed:
                    self._jobs.wait()
                if self._closed:
                    return
                job, self._job = self._job, None
                self._encoding = True
            try:
                self._publish(*job)
            finally:
                with self._jobs:
                    self._encoding = False
                    self._jobs.notify_all()

    def flush(self) -> None:
        """Wait until every frame handed over is published."""
        with self._jobs:
            while (self._job is not None or self._encoding) and not self._closed:
                self._jobs.wait()

    def update(self, framebuffer, frame: int, spp: int,
               denoise: int = 0, denoise_auto: bool = False,
               denoise_noise=None, background: bool = False) -> None:
        """Publish a new accumulated frame: a host float radiance array
        (numpy), encoded to PNG on the caller's thread, or with
        ``background`` handed to the encoder thread (``flush`` waits for
        it).

        ``denoise`` reports the active output-filter iteration count
        (0 = off) so the page's toggle button reflects server state;
        ``denoise_auto`` marks an spp-scheduled filter, whose effective
        count can be 0 past the crossover while auto mode is still armed
        — without the flag the page would show 'off' for an active
        schedule.
        """
        job = (np.asarray(framebuffer), frame, spp, denoise, denoise_auto,
               denoise_noise)
        if background:
            with self._jobs:
                self._job = job
                self._jobs.notify_all()
            return
        self.flush()  # an earlier frame must not land after this one
        self._publish(*job)

    def _publish(self, fb, frame, spp, denoise, denoise_auto, denoise_noise):
        png = encode_png(to_u8(fb, self.gamma, self.exposure))
        with self._lock:
            self._png = png
            self._stats = {
                "frame": int(frame),
                "spp": int(spp),
                "width": int(fb.shape[1]),
                "height": int(fb.shape[0]),
                "denoise": int(denoise),
                "denoise_auto": bool(denoise_auto),
            }
            if denoise_noise is not None:
                # The auto schedule's measured display-space noise level
                # (render/denoise.py:estimate_noise) — the page shows it
                # so the noise-driven iteration count is explainable.
                self._stats["denoise_noise"] = round(float(denoise_noise), 5)
            if self._aov_names:
                self._stats["aovs"] = self._aov_names

    def set_aovs(self, images) -> None:
        """Publish AOV images for ``/aov/<name>.png``.

        ``images``: dict of name → [H, W, 3] float array already in
        display range [0, 1] (the CLI's LDR AOV encodes — linear u8,
        gamma 1.0). Encoded once here, served from cache; re-publish
        whenever the camera or session changes (features are static per
        camera, so there is nothing to refresh between frames).
        """
        encoded = {
            str(name): encode_png(to_u8(np.asarray(img), 1.0))
            for name, img in images.items()
        }
        with self._lock:
            self._aovs = encoded
            self._aov_names = sorted(encoded)
            self._stats["aovs"] = self._aov_names

    def pending_camera(self):
        """Return-and-clear the latest camera request from the page.

        ``{"yaw": r, "pitch": r, "dist": scale}`` (orbit angles in radians
        about the scene's look-at point, distance as a multiplier of the
        starting distance) or None. The render loop applies it via
        ``RenderSession.set_camera`` — a repack, not a rebuild.
        """
        with self._lock:
            req, self._camera_request = self._camera_request, None
        return req

    def pending_session(self):
        """Return-and-clear the latest render-parameter request.

        A dict of ``SESSION_PARAMS`` values from the last ``/?param=``
        page load, or None. The render loop rebuilds the session with the
        merged config (the reference's analog: reloading the page with a
        new query string restarts the wasm app with those Args).
        """
        with self._lock:
            req, self._session_request = self._session_request, None
        return req

    def close(self) -> None:
        with self._jobs:
            self._closed = True
            self._jobs.notify_all()
        self._server.shutdown()
        self._server.server_close()
