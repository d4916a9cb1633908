"""The PyTorch port's live viewer and its camera orbit, against the JAX
package's: the same framebuffer serves the same bytes, the same queries get
the same answers, and ``orbit_camera`` is the same float math."""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import dataclasses
import json
import logging
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.output.image import read_png
from myraytracer_tpu_torch.render.camera import orbit_camera
from myraytracer_tpu_torch.scene.api import Camera
from myraytracer_tpu_torch.viewer import LiveViewer, validate_config_bounds


def _get(port, path):
    """(status, body, content type) of a GET; errors are answers too."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, b"", None


@pytest.fixture
def viewer():
    v = LiveViewer(0)  # port 0: a free port
    yield v
    v.close()


@pytest.fixture
def both():
    """The port's viewer and the JAX package's, built alike."""
    from myraytracer_tpu import viewer as jviewer

    made = []

    def make(**kw):
        pair = LiveViewer(0, **kw), jviewer.LiveViewer(0, **kw)
        made.extend(pair)
        return pair

    yield make
    for v in made:
        v.close()


def _decode(body, tmp_path):
    p = tmp_path / "x.png"
    p.write_bytes(body)
    return read_png(p)


# -- orbit_camera -----------------------------------------------------------


def _bases(jax_api):
    """Cameras of both packages: a pinhole, the defocus scene's (explicit
    focus), one above its target and one with a focus closer than it."""
    from myraytracer_tpu.scene import api as japi

    mod = japi if jax_api else None
    cls = mod.Camera if mod else Camera
    return [
        cls(lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0), vfov_degrees=20.0,
            aperture=0.1, focus_dist=None),
        cls(lookfrom=(3.0, 3.0, 2.0), lookat=(0.0, 0.0, -1.0), vfov_degrees=20.0,
            aperture=2.0, focus_dist=5.196152422706632),
        cls(lookfrom=(0.0, 8.0, 0.5), lookat=(0.0, 0.0, 0.0), vfov_degrees=40.0),
        cls(lookfrom=(-2.0, 1.0, 4.0), lookat=(1.0, 0.5, -1.0), vfov_degrees=60.0,
            aperture=0.5, focus_dist=0.01),
    ]


@pytest.mark.parametrize("focus", ["none", "explicit"])
def test_orbit_camera_equals_jax_field_for_field(focus):
    """Over a seeded grid of yaw, pitch (past the ±1.45 clamp) and distance
    (past the 1e-3 floor), every field of the orbited camera equals the JAX
    package's, bit for bit."""
    from myraytracer_tpu.render.camera import orbit_camera as jorbit

    rng = np.random.default_rng(8)
    yaws = rng.uniform(-2 * math.pi, 2 * math.pi, 12).tolist() + [0.0, math.pi]
    pitches = rng.uniform(-2.0, 2.0, 12).tolist() + [0.0, 10.0]
    dists = rng.uniform(0.05, 5.0, 12).tolist() + [1.0, 0.0]
    pairs = [(b, jb) for b, jb in zip(_bases(False), _bases(True))
             if (b.focus_dist is None) == (focus == "none")]
    assert pairs
    n = 0
    for base, jbase in pairs:
        for yaw in yaws:
            for pitch in pitches:
                for dist in dists:
                    got = dataclasses.asdict(orbit_camera(base, yaw, pitch, dist))
                    want = dataclasses.asdict(jorbit(jbase, yaw, pitch, dist))
                    assert got == want, (base, yaw, pitch, dist)
                    n += 1
    assert n >= 2 * 14 ** 3


def test_orbit_camera_geometry():
    """The JAX package's own cases (tests/test_viewer.py), on the port."""
    base = Camera(lookfrom=(3.0, 0.0, 0.0), lookat=(0.0, 0.0, 0.0), vfov_degrees=40.0)
    np.testing.assert_allclose(orbit_camera(base, math.pi, 0.0, 1.0).lookfrom,
                               (-3.0, 0.0, 0.0), atol=1e-12)
    np.testing.assert_allclose(orbit_camera(base, 0.0, 0.0, 2.0).lookfrom,
                               (6.0, 0.0, 0.0), atol=1e-12)
    c3 = orbit_camera(base, 0.0, 10.0, 1.0)
    assert abs(c3.lookfrom[1] - 3.0 * math.sin(1.45)) < 1e-9
    assert c3.lookat == base.lookat and c3.vfov_degrees == base.vfov_degrees
    # An explicit focus moves with the zoom; it never reaches 0.
    focused = dataclasses.replace(base, focus_dist=2.5)
    assert orbit_camera(focused, 0.0, 0.0, 2.0).focus_dist == pytest.approx(5.5)
    assert orbit_camera(focused, 0.0, 0.0, 0.0).focus_dist == 1e-3


def test_compile_order_does_not_depend_on_the_camera():
    """An orbited camera compiles the world in the same order (the spatial
    sort reads only the primitives): one fingerprint, so a session built at
    the orbited view renders the same tables as an orbited session."""
    from myraytracer_tpu_torch.render.session import scene_fingerprint, wants_spatial_sort
    from myraytracer_tpu_torch.scene import presets
    from myraytracer_tpu_torch.scene.api import World
    from myraytracer_tpu_torch.scene.compile import compile_scene

    for name in ("final", "mesh"):
        world = presets.get_scene(name)
        moved = World(world.spheres, camera=orbit_camera(world.camera, 0.5, 0.1, 1.2),
                      meshes=world.meshes, ambient=world.ambient)
        sort = wants_spatial_sort(world)
        assert sort
        assert (scene_fingerprint(compile_scene(world, spatial_sort=sort))
                == scene_fingerprint(compile_scene(moved, spatial_sort=sort)))


# -- both viewers, fed the same framebuffer ----------------------------------


def _frame(seed=3, h=16, w=24):
    rng = np.random.default_rng(seed)
    fb = rng.uniform(0.0, 1.6, (h, w, 3)).astype(np.float32)
    fb[0, 0] = (0.0, 0.25, 4.0)  # clipped and exact values
    return fb


@pytest.mark.parametrize("gamma,exposure", [(2.0, 1.0), ("srgb", 1.0), ("aces", 2.0),
                                            (2.2, 0.5)])
def test_both_viewers_serve_the_same_frame_and_stats(both, gamma, exposure):
    """One framebuffer, one frame.png byte for byte and one stats.json, at
    every transfer; the denoise fields and the AOV list ride along."""
    mine, theirs = both(gamma=gamma, exposure=exposure)
    fb = _frame()
    for frame, spp, kw in ((1, 2, {}),
                           (7, 14, dict(denoise=3, denoise_auto=True, denoise_noise=0.0123456))):
        mine.update(fb, frame, spp, **kw)
        theirs.update(fb, frame, spp, **kw)
        got, want = _get(mine.port, "/frame.png"), _get(theirs.port, "/frame.png")
        assert got[0] == want[0] == 200 and got[1] == want[1] and got[2] == want[2]
        got, want = _get(mine.port, "/stats.json"), _get(theirs.port, "/stats.json")
        assert json.loads(got[1]) == json.loads(want[1])
        assert json.loads(got[1])["frame"] == frame


def test_both_viewers_serve_the_same_aovs(both, tmp_path):
    mine, theirs = both(gamma="aces")
    rng = np.random.default_rng(5)
    images = {"albedo": rng.uniform(0, 1, (8, 16, 3)).astype(np.float32),
              "depth": rng.uniform(0, 1, (8, 16, 3)).astype(np.float32)}
    mine.set_aovs(images)
    theirs.set_aovs(images)
    for name in ("albedo", "depth", "normal", "nosuch"):
        got = _get(mine.port, f"/aov/{name}.png")
        want = _get(theirs.port, f"/aov/{name}.png")
        assert got[:2] == want[:2], name
    assert _get(mine.port, "/aov/normal.png")[0] == 404
    img = _decode(_get(mine.port, "/aov/albedo.png")[1], tmp_path)
    assert img.shape == (8, 16, 3)
    # A linear encode: gamma 1.0, whatever the viewer's transfer.
    assert abs(int(img[0, 0, 0]) - int(images["albedo"][0, 0, 0] * 255 + 0.5)) <= 0
    mine.update(np.zeros((4, 4, 3), np.float32), 1, 2)
    theirs.update(np.zeros((4, 4, 3), np.float32), 1, 2)
    assert (json.loads(_get(mine.port, "/stats.json")[1])
            == json.loads(_get(theirs.port, "/stats.json")[1]))
    assert json.loads(_get(mine.port, "/stats.json")[1])["aovs"] == ["albedo", "depth"]


_QUERIES = [
    "/nope", "/frame", "/set", "/set?yaw=bogus", "/set?yaw=nan", "/set?pitch=inf",
    "/set?yaw=0.5&pitch=-0.25&dist=1.5", "/?width=bogus", "/?width=16384", "/?height=-1",
    "/?samples_per_frame=10000", "/?samples_per_frame=0", "/?ray_depth=2000",
    "/?max_framebuffer_weight=2.5", "/?denoise=13", "/?denoise=-2", "/?denoise=x",
    "/?denoise=auto", "/?nee=1&qmc=0", "/?width=4096&height=512",
    "/?width=0&height=0", "/?width=0&height=0&scene=final", "/?width=0&height=256",
    "/?width=320&height=180&samples_per_frame=4&scene=final&seed=7", "/",
    "/aov/albedo.png", "/aov/.png",
]


def test_both_viewers_answer_queries_alike(both):
    """The same status for every query of tests/test_viewer.py (400s for
    malformed or out-of-bounds values, 404s for unknown paths and
    unpublished AOVs), and the same queued requests after it."""
    mine, theirs = both()
    for q in _QUERIES:
        got, want = _get(mine.port, q), _get(theirs.port, q)
        assert got[0] == want[0], q
        if q.startswith("/?") or q == "/":
            assert got[0] != 200 or b"frame.png" in got[1]
        assert mine.pending_session() == theirs.pending_session(), q
        assert mine.pending_camera() == theirs.pending_camera(), q


# -- the port's viewer, as tests/test_viewer.py holds the JAX one -------------


def test_viewer_serves_page_frame_and_stats(viewer, tmp_path):
    fb = np.zeros((4, 6, 3), np.float32)
    fb[..., 0] = 0.25  # gamma-2 encode -> 0.5 -> ~127
    viewer.update(fb, frame=3, spp=12)
    status, page, ctype = _get(viewer.port, "/")
    assert status == 200 and b"frame.png" in page and ctype.startswith("text/html")
    status, stats, ctype = _get(viewer.port, "/stats.json")
    assert ctype == "application/json"
    assert json.loads(stats) == {"frame": 3, "spp": 12, "width": 6, "height": 4,
                                 "denoise": 0, "denoise_auto": False}
    status, png, ctype = _get(viewer.port, "/frame.png?f=3")
    assert ctype == "image/png"
    img = _decode(png, tmp_path)
    assert img.shape == (4, 6, 3)
    assert int(img[0, 0, 0]) in (127, 128) and img[0, 0, 1] == 0


def test_viewer_camera_controls(viewer):
    assert viewer.pending_camera() is None
    _get(viewer.port, "/set?yaw=0.5&pitch=-0.25&dist=1.5")
    _get(viewer.port, "/set?yaw=0.7&pitch=-0.25&dist=1.5")  # the latest wins
    assert viewer.pending_camera() == {"yaw": 0.7, "pitch": -0.25, "dist": 1.5}
    assert viewer.pending_camera() is None  # consumed
    assert _get(viewer.port, "/set?yaw=bogus")[0] == 400
    assert _get(viewer.port, "/set?yaw=nan")[0] == 400
    assert viewer.pending_camera() is None


def test_viewer_url_query_session_params(viewer):
    assert viewer.pending_session() is None
    _get(viewer.port, "/?width=320&height=180&samples_per_frame=4&scene=final&seed=7")
    assert viewer.pending_session() == {"width": 320, "height": 180,
                                        "samples_per_frame": 4, "scene": "final", "seed": 7}
    assert viewer.pending_session() is None
    _get(viewer.port, "/")
    assert viewer.pending_session() is None
    assert _get(viewer.port, "/?width=bogus")[0] == 400
    _get(viewer.port, "/?denoise=auto&nee=1")
    assert viewer.pending_session() == {"denoise": -1, "nee": True}


def test_viewer_bounds_rejected(viewer):
    for query in ("/?width=16384", "/?height=-1", "/?samples_per_frame=10000",
                  "/?samples_per_frame=0", "/?ray_depth=2000",
                  "/?max_framebuffer_weight=2.5", "/?denoise=13"):
        assert _get(viewer.port, query)[0] == 400, query
        assert viewer.pending_session() is None, query
    _get(viewer.port, "/?width=4096&height=512")
    assert viewer.pending_session() == {"width": 4096, "height": 512}


def test_viewer_merged_config_bounds():
    validate_config_bounds(RenderConfig(width=2048, height=2048))
    with pytest.raises(ValueError, match="pixels"):
        validate_config_bounds(RenderConfig(width=4096, height=4096))
    validate_config_bounds(RenderConfig(width=64, height=64, ray_depth=63))
    with pytest.raises(ValueError, match="ray_depth"):
        validate_config_bounds(RenderConfig(width=64, height=64, ray_depth=2000))
    validate_config_bounds(RenderConfig(width=0, height=0))


def test_viewer_follow_window_roundtrip(viewer):
    status, page, _ = _get(viewer.port, "/?width=0&height=0")
    assert b"location.replace" in page
    assert viewer.pending_session() is None
    _get(viewer.port, "/?width=0&height=0&scene=final")
    assert viewer.pending_session() == {"scene": "final"}
    _get(viewer.port, "/?width=800&height=600&scene=final")
    assert viewer.pending_session() == {"width": 800, "height": 600, "scene": "final"}
    _get(viewer.port, "/?width=0&height=256")
    assert viewer.pending_session() == {"width": 0, "height": 256}


def test_viewer_log_level_query(viewer):
    """?log_level= sets the port's logger (lib.rs:49-67), not the JAX
    package's."""
    logger = logging.getLogger("myraytracer_tpu_torch")
    other = logging.getLogger("myraytracer_tpu")
    old, old_other = logger.level, other.level
    try:
        _get(viewer.port, "/?log_level=debug")
        assert logger.level == logging.DEBUG
        _get(viewer.port, "/?log_level=warning")
        assert logger.level == logging.WARNING
        assert other.level == old_other
    finally:
        logger.setLevel(old)


def test_viewer_stats_report_auto_noise(viewer):
    fb = np.zeros((4, 6, 3), np.float32)
    viewer.update(fb, frame=1, spp=2, denoise=3, denoise_auto=True, denoise_noise=0.012345)
    s = json.loads(_get(viewer.port, "/stats.json")[1])
    assert s["denoise_auto"] is True and s["denoise"] == 3
    assert abs(s["denoise_noise"] - 0.012345) < 1e-5
    viewer.update(fb, frame=2, spp=4)
    assert "denoise_noise" not in json.loads(_get(viewer.port, "/stats.json")[1])


def test_viewer_publishes_host_data_only(viewer):
    """What the handler threads read is bytes and Python numbers: a frame
    is encoded on the caller's thread, so no request touches a tensor."""
    import torch

    viewer.update(torch.zeros((4, 6, 3)).numpy(), 1, 1)
    viewer.set_aovs({"depth": np.zeros((4, 6, 3), np.float32)})
    assert isinstance(viewer._png, bytes)
    assert all(isinstance(v, bytes) for v in viewer._aovs.values())
    assert all(isinstance(v, (int, float, bool, list)) for v in viewer._stats.values())


def test_background_updates_publish_the_same_bytes(both):
    """A frame handed to the encoder thread is published as a synchronous
    update publishes it: after ``flush`` the same PNG and stats as the JAX
    viewer's; frames handed over faster than they encode keep the latest,
    and a synchronous update is never overwritten by an older frame."""
    mine, theirs = both(gamma="srgb", exposure=1.5)
    frames = [_frame(seed) for seed in range(4)]
    for i, fb in enumerate(frames):
        mine.update(fb, i + 1, 2 * (i + 1), background=True)
    mine.flush()
    theirs.update(frames[-1], 4, 8)
    assert _get(mine.port, "/frame.png")[1] == _get(theirs.port, "/frame.png")[1]
    assert (json.loads(_get(mine.port, "/stats.json")[1])
            == json.loads(_get(theirs.port, "/stats.json")[1]))
    mine.update(frames[0], 9, 9, background=True)
    mine.update(frames[1], 10, 10)
    mine.flush()
    theirs.update(frames[1], 10, 10)
    assert _get(mine.port, "/frame.png")[1] == _get(theirs.port, "/frame.png")[1]
    assert json.loads(_get(mine.port, "/stats.json")[1])["frame"] == 10


def test_background_updates_keep_frame_and_stats_together(viewer, tmp_path):
    """A stress run of the encoder thread: a producer hands over frames
    while readers take the published PNG and stats under the viewer's lock,
    with a short switch interval; every pair read belongs to one frame, and
    after ``flush`` the last frame is the one published."""
    import sys
    import threading

    def frame(i):
        return np.full((2, 3, 3), i / 255.0, np.float32)  # gamma 1: pixel value i

    viewer.gamma = 1.0
    seen, errors = [], []

    def read():
        for _ in range(200):
            with viewer._lock:
                png, stats = viewer._png, dict(viewer._stats)
            if stats.get("frame"):
                p = tmp_path / f"r{threading.get_ident()}.png"
                p.write_bytes(png)
                value = int(read_png(p)[0, 0, 0])
                seen.append(stats["frame"])
                if value != stats["frame"]:
                    errors.append((value, stats["frame"]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        readers = [threading.Thread(target=read) for _ in range(3)]
        for t in readers:
            t.start()
        for i in range(1, 201):
            viewer.update(frame(i), i, i, background=True)
        viewer.flush()
        for t in readers:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:5]
    assert json.loads(_get(viewer.port, "/stats.json")[1])["frame"] == 200
    assert int(_decode(_get(viewer.port, "/frame.png")[1], tmp_path)[0, 0, 0]) == 200
