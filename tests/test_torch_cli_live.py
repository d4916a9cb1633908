"""The PyTorch port's live CLI against the JAX CLI: the viewer loop and its
orbits (uniform and adaptive, with --denoise and --aov), session rebuilds
from the URL query, --frames 0, --preview-every, --ambient, --exposure,
--sample-batch, --profile and --debug-nans, and a step that commits whole.

The port runs ``--backend torch`` (the plain integrator on the CPU), the
JAX CLI ``--backend jnp``. The JAX integrator runs jitted, where XLA
contracts multiply-adds, so a u8 level may round the other way: images are
held to at most one level apart on at most 2% of the values (as
tests/test_torch_cli.py holds the denoiser's). Port against port is
bitwise.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import json
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from myraytracer_tpu_torch import cli
from myraytracer_tpu_torch import viewer as viewer_mod
from myraytracer_tpu_torch.output.image import read_png, to_u8
from myraytracer_tpu_torch.render import session as session_mod
from myraytracer_tpu_torch.render.adaptive import AdaptiveSession
from myraytracer_tpu_torch.render.camera import orbit_camera, pack_camera
from myraytracer_tpu_torch.render.session import RenderSession
from myraytracer_tpu_torch.scene import presets
from myraytracer_tpu_torch.utils import profiling

SMALL = ["--scene", "defocus", "--width", "32", "--height", "16", "--samples-per-frame",
         "1", "--ray-depth", "3"]
ADAPTIVE = ["--scene", "defocus", "--width", "128", "--height", "64",
            "--samples-per-frame", "1", "--ray-depth", "2", "--adaptive", "1"]
ORBIT = "/set?yaw=0.5&pitch=0.1&dist=1.2"


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def _close(a, b):
    """At most one u8 level apart on at most 2% of the values."""
    assert a.shape == b.shape
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.02, (d.max(), (d > 0).mean())


class Driver:
    """Wraps one package's session ``step`` and ``LiveViewer``: with
    ``sleep`` past the viewer's 0.25 s cadence every step is a sync point,
    so a request sent inside step n (``at[n]``, GET paths) lands at step n's
    sync; a step past ``stop`` raises KeyboardInterrupt."""

    def __init__(self, monkeypatch, viewer_cls, session_cls, at=None, stop=None,
                 sleep=0.3):
        self.viewer, self.steps, self.codes = None, 0, {}
        real_init, real_step = viewer_cls.__init__, session_cls.step
        drv = self

        def init(v, port, *a, **kw):
            real_init(v, port, *a, **kw)
            drv.viewer = v

        def step(s):
            drv.steps += 1
            if stop is not None and drv.steps > stop:
                raise KeyboardInterrupt
            for path in (at or {}).get(drv.steps, ()):
                drv.codes[path] = _get(drv.viewer.port, path)[0]
            if sleep:
                time.sleep(sleep)
            return real_step(s)

        monkeypatch.setattr(viewer_cls, "__init__", init)
        monkeypatch.setattr(session_cls, "step", step)


def _run_both(tmp_path, monkeypatch, flags, adaptive=False, port_flags=(), **drive):
    """The port's CLI and the JAX CLI with the same flags, each driven alike;
    returns (port PNG, JAX PNG, port driver, JAX driver)."""
    from myraytracer_tpu import cli as jcli
    from myraytracer_tpu import viewer as jviewer
    from myraytracer_tpu.render.adaptive import AdaptiveSession as JAdaptive
    from myraytracer_tpu.render.session import RenderSession as JSession

    mine = Driver(monkeypatch, viewer_mod.LiveViewer,
                  AdaptiveSession if adaptive else RenderSession, **drive)
    theirs = Driver(monkeypatch, jviewer.LiveViewer, JAdaptive if adaptive else JSession,
                    **drive)
    got, want = tmp_path / "t.png", tmp_path / "j.png"
    assert cli.main(["--backend", "torch"] + flags + list(port_flags)
                    + ["--out", str(got)]) == 0
    assert jcli.main(["--backend", "jnp"] + flags + ["--out", str(want)]) == 0
    return got, want, mine, theirs


# -- the viewer loop ------------------------------------------------------------


@pytest.mark.parametrize("adaptive", [False, True], ids=["uniform", "adaptive"])
def test_cli_serve_interactive_orbit_writes_the_jax_clis_image(tmp_path, monkeypatch,
                                                              adaptive):
    """--serve --interactive with --denoise and --aov: an orbit posted in
    step 2 lands at that step's sync in both CLIs (uniform: the three frames
    after it accumulate at the orbited view; adaptive: the schedule and the
    budget restart there), and the written image and feature images agree."""
    ck = tmp_path / "c.npz"
    base = (ADAPTIVE + ["--frames", "4"]) if adaptive else (SMALL + ["--frames", "5"])
    flags = base + ["--serve", "0", "--interactive", "--denoise", "2",
                    "--aov", "albedo,depth"]
    got, want, mine, theirs = _run_both(tmp_path, monkeypatch, flags, adaptive,
                                        port_flags=["--checkpoint", str(ck)],
                                        at={2: [ORBIT, "/aov/albedo.png", "/aov/normal.png"]})
    assert mine.codes == theirs.codes == {ORBIT: 200, "/aov/albedo.png": 200,
                                         "/aov/normal.png": 404}
    assert mine.steps == theirs.steps
    _close(read_png(got), read_png(want))
    for aov in ("albedo", "depth"):
        _close(read_png(tmp_path / f"t.{aov}.png"), read_png(tmp_path / f"j.{aov}.png"))
    world = presets.get_scene("defocus")
    w, h = (128, 64) if adaptive else (32, 16)
    with np.load(ck) as z:
        np.testing.assert_array_equal(
            z["camera"], pack_camera(orbit_camera(world.camera, 0.5, 0.1, 1.2), w, h))
        if not adaptive:
            assert int(z["frame_count"]) == 3 and int(z["sample_cursor"]) == 5
    stats = json.loads(_get(mine.viewer.port, "/stats.json")[1])
    assert (stats["width"], stats["height"]) == (w, h) and stats["aovs"] == ["albedo", "depth"]


def test_cli_url_query_rebuilds_the_session_as_the_jax_cli(tmp_path, monkeypatch):
    """A /?param= load rebuilds the session with the merged config (the
    reference web runner's Args-from-query, lib.rs:72-94) and restarts the
    frame budget: both CLIs write the rebuilt session's image."""
    flags = ["--scene", "reference", "--width", "16", "--height", "8",
             "--samples-per-frame", "1", "--ray-depth", "2", "--frames", "4",
             "--serve", "0"]
    got, want, mine, _ = _run_both(
        tmp_path, monkeypatch, flags, sleep=0,
        at={2: ["/?width=24&height=12&samples_per_frame=2"]})
    a = read_png(got)
    assert a.shape == (12, 24, 3)
    _close(a, read_png(want))
    assert mine.steps == 6  # two steps, then the restarted budget's four


def test_cli_denoise_toggle_keeps_the_accumulation(tmp_path, monkeypatch):
    """?denoise=N alone swaps the output filter and keeps the session: the
    checkpoint is a plain run's, and the image a --denoise run's."""
    flags = SMALL + ["--frames", "4"]
    plain, dn, live = tmp_path / "p", tmp_path / "d", tmp_path / "l"
    assert cli.main(["--backend", "torch"] + flags + ["--checkpoint", f"{plain}.npz",
                                                      "--out", f"{plain}.png"]) == 0
    assert cli.main(["--backend", "torch"] + flags + ["--denoise", "2",
                                                      "--out", f"{dn}.png"]) == 0
    drv = Driver(monkeypatch, viewer_mod.LiveViewer, RenderSession, sleep=0,
                 at={2: ["/?denoise=2"]})
    assert cli.main(["--backend", "torch"] + flags + ["--serve", "0", "--checkpoint",
                                                      f"{live}.npz", "--out", f"{live}.png"]) == 0
    assert drv.codes == {"/?denoise=2": 200} and drv.steps == 4
    with np.load(f"{plain}.npz") as a, np.load(f"{live}.npz") as b:
        np.testing.assert_array_equal(a["framebuffer"], b["framebuffer"])
    assert (tmp_path / "l.png").read_bytes() == (tmp_path / "d.png").read_bytes()


def test_cli_rejected_requests_keep_the_session(tmp_path, monkeypatch, caplog):
    """An unknown scene and a merged size past the pixel bound are rejected
    in the loop, and the running session goes on: the image is a plain
    run's."""
    flags = SMALL + ["--frames", "4"]
    assert cli.main(["--backend", "torch"] + flags + ["--out", str(tmp_path / "p.png")]) == 0
    drv = Driver(monkeypatch, viewer_mod.LiveViewer, RenderSession, sleep=0,
                 at={1: ["/?scene=nosuch"], 2: ["/?width=4096&height=4096"]})
    with caplog.at_level("WARNING", logger="myraytracer_tpu_torch"):
        assert cli.main(["--backend", "torch"] + flags + ["--serve", "0",
                                                          "--out", str(tmp_path / "s.png")]) == 0
    rejected = [r.getMessage() for r in caplog.records if "rejected" in r.getMessage()]
    assert len(rejected) == 2 and "nosuch" in rejected[0] and "pixels" in rejected[1]
    assert drv.steps == 4
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "s.png").read_bytes()


def test_cli_adaptive_serve_shows_progress_and_refuses_rebuilds(tmp_path, monkeypatch):
    """--adaptive --serve: the viewer shows the rounds and the mean spp; a
    size request is ignored (the state is bound to one scene and size), so
    the image is a headless run's."""
    flags = ["--backend", "torch"] + ADAPTIVE + ["--frames", "3"]
    assert cli.main(flags + ["--out", str(tmp_path / "h.png")]) == 0
    drv = Driver(monkeypatch, viewer_mod.LiveViewer, AdaptiveSession, sleep=0.3,
                 at={1: ["/?width=24"]})
    assert cli.main(flags + ["--serve", "0", "--out", str(tmp_path / "s.png")]) == 0
    assert drv.codes == {"/?width=24": 200}
    stats = json.loads(_get(drv.viewer.port, "/stats.json")[1])
    assert (stats["width"], stats["height"]) == (128, 64)
    assert stats["frame"] > 0 and stats["spp"] > 0
    assert _get(drv.viewer.port, "/frame.png")[1][:8] == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "h.png").read_bytes() == (tmp_path / "s.png").read_bytes()


def test_cli_orbits_turn_about_the_resumed_view(tmp_path, monkeypatch):
    """A resumed run orbits about the view its checkpoint recorded (the JAX
    CLI turns about the scene's construction camera, cli.py:531): an
    identity orbit keeps the resumed camera."""
    ck, ck2 = tmp_path / "a.npz", tmp_path / "b.npz"
    flags = ["--backend", "torch"] + SMALL + ["--serve", "0", "--interactive"]
    Driver(monkeypatch, viewer_mod.LiveViewer, RenderSession, at={2: [ORBIT]})
    assert cli.main(flags + ["--frames", "3", "--checkpoint", str(ck),
                             "--out", str(tmp_path / "a.png")]) == 0
    drv = Driver(monkeypatch, viewer_mod.LiveViewer, RenderSession,
                 at={1: ["/set?yaw=0&pitch=0&dist=1"]})
    assert cli.main(flags + ["--frames", "3", "--resume", str(ck), "--checkpoint", str(ck2),
                             "--out", str(tmp_path / "b.png")]) == 0
    assert drv.codes == {"/set?yaw=0&pitch=0&dist=1": 200}
    world = presets.get_scene("defocus")
    with np.load(ck) as a, np.load(ck2) as b:
        np.testing.assert_array_equal(b["camera"], a["camera"])
        assert not np.array_equal(b["camera"], pack_camera(world.camera, 32, 16))
        assert int(b["frame_count"]) == 2  # the identity orbit reset it
        assert json.loads(str(b["meta"]))["view"] == json.loads(str(a["meta"]))["view"]


def test_cli_live_flags_refuse_what_they_cannot_do(tmp_path):
    out = str(tmp_path / "x.png")
    base = ["--backend", "torch"] + SMALL + ["--out", out]
    for extra, match in ((["--interactive"], "--interactive"),
                         (["--serve", "0", "--interactive", "--scene", "reference"],
                          "--interactive"),
                         (["--adaptive", "--frames", "0"], "--frames 0"),
                         (["--frames", "-1"], "--frames"),
                         (["--ambient", "0,0"], "--ambient"),
                         (["--ambient", "a,b,c"], "--ambient"),
                         (["--ambient=-1,0,0"], "--ambient")):
        with pytest.raises(SystemExit, match=match):
            cli.main(base + extra)


def test_cli_flags_differ_from_the_jax_clis_by_the_unported_modules():
    """Every module is ported: the two parsers have the same flags (the
    sharding's --shard and --multihost included, with the same shard
    modes); the backend choices differ by the JAX package's names for its
    paths (cpu is both packages' native renderer)."""
    from myraytracer_tpu import cli as jcli

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}, {
            a.dest: a.choices for a in parser._actions}

    mine, my_choices = flags(cli.build_parser())
    theirs, their_choices = flags(jcli.build_parser())
    assert mine == theirs
    assert len(mine - {"-h", "--help"}) == 33
    assert my_choices["shard"] == their_choices["shard"] == ["none", "tiles", "samples", "hybrid"]
    assert set(my_choices["backend"]) == {"auto", "cuda", "torch", "cpu"}
    assert set(their_choices["backend"]) == {"auto", "jnp", "pallas", "cpu"}


# -- headless flags ---------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    ["--ambient", "0,0,0"],
    ["--ambient", "1,0.5,0.25", "--exposure", "2"],
    ["--exposure", "0.5", "--gamma", "aces"],
    ["--samples-per-frame", "2", "--sample-batch", "1"],
], ids=["black-ambient", "ambient-exposure", "exposure-aces", "sample-batch"])
def test_cli_headless_flags_write_the_jax_clis_image(tmp_path, monkeypatch, extra):
    got, want, _, _ = _run_both(tmp_path, monkeypatch, SMALL + ["--frames", "2"] + extra)
    a, b = read_png(got), read_png(want)
    _close(a, b)
    if extra[:2] == ["--ambient", "0,0,0"]:
        assert a.max() == 0  # the sky was the only light
    else:
        assert a.max() > 0


def test_cli_exposure_scales_display_sinks_only(tmp_path):
    """--exposure moves the u8 image and leaves the HDR sink and the
    checkpoint alone."""
    base = ["--backend", "torch"] + SMALL + ["--frames", "1"]
    for name, extra in (("a", []), ("b", ["--exposure", "2"])):
        assert cli.main(base + extra + ["--checkpoint", str(tmp_path / f"{name}.npz"),
                                        "--out", str(tmp_path / f"{name}.png")]) == 0
        assert cli.main(base + extra + ["--out", str(tmp_path / f"{name}.npy")]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), np.load(tmp_path / "b.npy"))
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        np.testing.assert_array_equal(a["framebuffer"], b["framebuffer"])
        fb = a["framebuffer"]
    np.testing.assert_array_equal(read_png(tmp_path / "b.png"), to_u8(fb, 2.0, 2.0))
    assert (read_png(tmp_path / "b.png") >= read_png(tmp_path / "a.png")).all()


def test_cli_preview_every_writes_the_jax_clis_previews(tmp_path, monkeypatch):
    """--preview-every 2 with 3 frames a step: a preview where frame_count
    crosses a multiple of 2 (frames 3, 6 and 9), then the final image; each
    write as the JAX CLI's."""
    from myraytracer_tpu import cli as jcli

    writes = {"t": [], "j": []}

    def recorder(key, real):
        def write(path, img, gamma=2.0, exposure=1.0):
            writes[key].append(to_u8(np.asarray(img), gamma, exposure))
            return real(path, img, gamma=gamma, exposure=exposure)
        return write

    monkeypatch.setattr(cli, "write_image", recorder("t", cli.write_image))
    monkeypatch.setattr(jcli, "write_image", recorder("j", jcli.write_image))
    _run_both(tmp_path, monkeypatch, SMALL + ["--frames", "7", "--frame-batch", "3",
                                              "--preview-every", "2", "--exposure", "1.5"])
    assert len(writes["t"]) == len(writes["j"]) == 4
    for a, b in zip(writes["t"], writes["j"]):
        _close(a, b)
    assert not np.array_equal(writes["t"][0], writes["t"][-1])


def test_cli_frames_0_runs_until_interrupted(tmp_path, monkeypatch):
    """--frames 0 accumulates until Ctrl-C (lib.rs:187-196), then writes the
    checkpoint and the image: three frames, as the JAX CLI's, and bitwise a
    --frames 3 run's."""
    ck = tmp_path / "c.npz"
    got, want, mine, theirs = _run_both(tmp_path, monkeypatch, SMALL + ["--frames", "0"],
                                        port_flags=["--checkpoint", str(ck)],
                                        stop=3, sleep=0)
    assert mine.steps == theirs.steps == 4
    with np.load(ck) as z:
        assert (int(z["frame_count"]), int(z["sample_cursor"])) == (3, 3)
    _close(read_png(got), read_png(want))
    monkeypatch.undo()
    assert cli.main(["--backend", "torch"] + SMALL + ["--frames", "3",
                                                      "--out", str(tmp_path / "3.png")]) == 0
    assert got.read_bytes() == (tmp_path / "3.png").read_bytes()


def test_cli_adaptive_interrupt_writes_the_image(tmp_path, monkeypatch):
    ck = tmp_path / "a.npz"
    Driver(monkeypatch, viewer_mod.LiveViewer, AdaptiveSession, stop=2, sleep=0)
    assert cli.main(["--backend", "torch"] + ADAPTIVE + ["--frames", "64", "--checkpoint",
                                                         str(ck), "--out",
                                                         str(tmp_path / "a.png")]) == 0
    assert read_png(tmp_path / "a.png").shape == (64, 128, 3)
    with np.load(ck) as z:
        assert 0 < int(z["samples_spent"]) < 64 * 128 * 64


# -- a step commits whole ------------------------------------------------------------


def test_interrupt_inside_the_blend_resumes_to_the_uninterrupted_image(tmp_path,
                                                                       monkeypatch):
    """Ctrl-C inside the third step's blend: the checkpoint holds two whole
    frames, and a resume for two more is bitwise a four-frame run."""
    real_blend, calls = session_mod._blend_chain, {"n": 0}

    def blend(*a):
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt
        return real_blend(*a)

    base = ["--backend", "torch"] + SMALL
    ck, ck2, ref = tmp_path / "a.npz", tmp_path / "b.npz", tmp_path / "r.npz"
    monkeypatch.setattr(session_mod, "_blend_chain", blend)
    assert cli.main(base + ["--frames", "0", "--checkpoint", str(ck),
                            "--out", str(tmp_path / "a.png")]) == 0
    monkeypatch.undo()
    with np.load(ck) as z:
        assert (int(z["frame_count"]), int(z["sample_cursor"])) == (2, 2)
    assert cli.main(base + ["--frames", "2", "--resume", str(ck), "--checkpoint", str(ck2),
                            "--out", str(tmp_path / "b.png")]) == 0
    assert cli.main(base + ["--frames", "4", "--checkpoint", str(ref),
                            "--out", str(tmp_path / "r.png")]) == 0
    with np.load(ck2) as b, np.load(ref) as r:
        np.testing.assert_array_equal(b["framebuffer"], r["framebuffer"])
        assert int(b["sample_cursor"]) == int(r["sample_cursor"]) == 4
    assert (tmp_path / "b.png").read_bytes() == (tmp_path / "r.png").read_bytes()


def test_an_interrupt_at_any_line_of_a_step_leaves_a_step_boundary():
    """KeyboardInterrupt raised at every line of ``RenderSession.step`` in
    turn (a trace hook, where a signal would land between bytecodes): the
    session is left before or after the step, never between, and finishing
    the run gives the uninterrupted framebuffer bit for bit."""
    from myraytracer_tpu_torch.config import RenderConfig

    world = presets.get_scene("defocus")
    cfg = RenderConfig(width=16, height=8, samples_per_frame=1, ray_depth=2, backend="torch")
    ref = RenderSession(world, cfg)
    states = [(ref.framebuffer.clone(), 0, 0)]
    for _ in range(3):
        ref.step()
        states.append((ref.framebuffer.clone(), ref.frame_count, ref.sample_cursor))
    code = RenderSession.step.__code__
    lines = sorted({ln for _, _, ln in code.co_lines() if ln is not None})
    assert len(lines) > 10
    for line in lines:
        s = RenderSession(world, cfg)
        s.step()

        def hook(frame, event, arg, line=line):
            if frame.f_code is code:
                if event == "line" and frame.f_lineno == line:
                    raise KeyboardInterrupt
                return hook
            return None

        sys.settrace(hook)
        try:
            s.step()
        except KeyboardInterrupt:
            pass
        finally:
            sys.settrace(None)
        at = [i for i, (fb, n, c) in enumerate(states)
              if (s.frame_count, s.sample_cursor) == (n, c) and torch.equal(s.framebuffer, fb)]
        assert at in ([1], [2]), line
        while s.frame_count < 3:
            s.step()
        assert torch.equal(s.framebuffer, states[3][0]), line


# -- --debug-nans and --profile ---------------------------------------------------------


@pytest.mark.parametrize("adaptive", [False, True], ids=["uniform", "adaptive"])
def test_cli_debug_nans_trips_on_a_poisoned_step(tmp_path, monkeypatch, adaptive):
    """A framebuffer poisoned before step 2: --debug-nans raises
    FloatingPointError naming the frame (or round), and the switch is the
    process's again after the run."""
    cls = AdaptiveSession if adaptive else RenderSession
    real_step, calls = cls.step, {"n": 0}

    def step(self):
        calls["n"] += 1
        if calls["n"] == 2:
            if adaptive:
                fbB = self._state[0].clone()
                fbB[0, 0, 0, 0] = float("nan")
                self._state = (fbB,) + tuple(self._state[1:])
            else:
                fb = self.framebuffer.clone()
                fb[0, 0, 0] = float("nan")
                self.framebuffer = fb
        return real_step(self)

    monkeypatch.setattr(cls, "step", step)
    flags = ["--backend", "torch"] + (ADAPTIVE + ["--frames", "4"] if adaptive
                                      else SMALL + ["--frames", "3"])
    with pytest.raises(FloatingPointError, match="adaptive round" if adaptive else "frame 2"):
        cli.main(flags + ["--debug-nans", "--out", str(tmp_path / "x.png")])
    assert not profiling.debug_nans()
    calls["n"] = 0
    assert cli.main(flags + ["--out", str(tmp_path / "y.png")]) == 0  # off: no check


def test_cli_debug_nans_passes_a_clean_run_and_costs_nothing_off(tmp_path, monkeypatch):
    checks = []
    real = profiling.check_finite
    monkeypatch.setattr(profiling, "check_finite",
                        lambda fb, what: (checks.append(what), real(fb, what)))
    base = ["--backend", "torch"] + SMALL + ["--frames", "3"]
    assert cli.main(base + ["--out", str(tmp_path / "a.png")]) == 0
    assert checks == []
    assert cli.main(base + ["--debug-nans", "--out", str(tmp_path / "b.png")]) == 0
    assert checks == ["frame 1 (sample cursor 0)", "frame 2 (sample cursor 1)",
                      "frame 3 (sample cursor 2)"]
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


def test_cli_profile_writes_a_trace_of_the_loop(tmp_path):
    logdir = tmp_path / "prof"
    assert cli.main(["--backend", "torch"] + SMALL + ["--frames", "2", "--profile",
                                                      str(logdir), "--out",
                                                      str(tmp_path / "p.png")]) == 0
    events = json.loads((logdir / profiling.TRACE_NAME).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert read_png(tmp_path / "p.png").shape == (16, 32, 3)
