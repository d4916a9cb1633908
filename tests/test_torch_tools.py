"""The port's measurement tools (``configs``, ``stream``, ``ladder``,
``meshscale``, ``cpu_mesh_baseline``, ``sort_probe``, ``orbit``) against
the JAX package's ``tools/*.py``.

The config tables are imported from ``tools/configs.py`` (it imports only
numpy when loaded); what the JAX tools compute inside ``main`` -- the
per-config renderer arguments, the sort probe's keys and step, the orbit's
cameras -- is written out here from their lines as the oracle, with the
JAX package's own worlds, lights and ``pack_camera``. ``configs`` and
``stream`` run their plain versions on the CPU at tiny sizes: their lines
have the JAX tools' formats, and each frame's segments are a direct call's
of the same renderer. The tools that need a card exit non-zero here and
print nothing on stdout.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import importlib.util
import json
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.render import camera as jcam
from myraytracer_tpu.render.lights import extract_lights as jextract_lights
from myraytracer_tpu.scene import presets as jpresets
from myraytracer_tpu.scene.api import Camera as JCamera
from myraytracer_tpu_torch import (configs, cpu_mesh_baseline, ladder, meshscale, orbit, quality,
                                   sort_probe, stream)
from myraytracer_tpu_torch.core import rng as crng
from myraytracer_tpu_torch.native import cpu_backend
from myraytracer_tpu_torch.render import camera as tcam
from myraytracer_tpu_torch.render import dispatch
from myraytracer_tpu_torch.render.session import renderer_kwargs
from myraytracer_tpu_torch.scene import presets as tpresets

REPO = pathlib.Path(__file__).resolve().parents[1]
PRESETS = sorted(jpresets.SCENES)
NUM = r"-?[0-9.]+"


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


# -- configs ------------------------------------------------------------------


def test_config_tables_are_the_jax_tools():
    jt = _jax_tool("configs")
    assert configs.CONFIGS == jt.CONFIGS
    assert configs.SMALL == jt.SMALL


def _jax_renderer_args(world, use_nee, backend, spp):
    """``tools/configs.py:88-114``, written out."""
    mats = {s.material.type_id for s in world.spheres}
    mats |= {m.material.type_id for m in world.meshes}
    iors = {s.material.ior for s in world.spheres if s.material.type_id == 3}
    iors |= {m.material.ior for m in world.meshes if m.material.type_id == 3}
    kw = dict(
        material_set=tuple(sorted(mats)) or None,
        static_ior=(iors.pop() if len(iors) == 1 else None),
        sky=world.ambient,
    )
    if use_nee:
        kw["nee_lights"] = jextract_lights(world)
    if backend != "pallas":
        kw["sample_batch"] = min(spp, 2)
    return kw


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("name", PRESETS)
def test_renderer_args_are_the_jax_tools(name, nee):
    jw, tw = jpresets.get_scene(name, seed=0), tpresets.get_scene(name, seed=0)
    for jb, tb in (("pallas", "cuda"), ("jnp", "torch")):
        for spp in (1, 125):
            want = _jax_renderer_args(jw, nee, jb, spp)
            assert configs.renderer_args(tw, nee, tb, spp) == want, (name, nee, tb, spp)


@pytest.mark.parametrize("nee_env", ["0", "1", "both"])
def test_runs_are_the_jax_tools(nee_env):
    want = []  # tools/configs.py:71-82
    for cfg in configs.CONFIGS:
        want.append((cfg, False))
        if nee_env in ("1", "both") and jextract_lights(jpresets.get_scene(cfg[1], seed=0)):
            if nee_env == "1":
                want[-1] = (cfg, True)
            else:
                want.append((cfg, True))
    assert configs.runs(configs.CONFIGS, nee_env) == want
    s = configs.settings({"CFG_NEE": nee_env, "CFG_ONLY": "final,light"})
    assert [c[0] for c, _ in s["runs"]] == [c[0] for c, _ in want if c[0] in ("final", "light")]
    assert s["backend"] == "cuda" and s["frames"] == 4


def test_configs_small_runs_the_plain_version_with_the_jax_tools_lines(capsys):
    assert configs.main({"CFG_SMALL": "1", "CFG_FRAMES": "1"}) == 0
    lines = _lines(capsys)
    res = json.loads(lines[-1])
    assert lines[0] == "cpu: the plain PyTorch version" and res["backend"] == "torch"
    rows = res["rows"]
    assert [r["config"] for r in rows] == [c[0] for c in configs.SMALL]
    key = crng.key_from_seed(0)
    for line, r in zip(lines[1:], rows):
        # tools/configs.py:131-136; its compile seconds are the first call's here.
        want = (f"{r['config']:>12} {r['width']}x{r['height']} spp={r['spp']} "
                f"depth={r['depth']}: {r['ms_per_frame']:8.1f} ms/frame "
                f"{r['mrays_s']:8.1f} Mrays/s (first call {r['first_call_s']:.0f}s)")
        assert line == want
        world, scene = quality.setup(r["scene"], "torch", r["width"], r["height"])
        direct = quality.renderer(world, "torch", r["width"], r["height"], r["spp"], r["depth"])
        assert r["sample_bases"] == [0, r["spp"]]
        assert [float(direct(scene, key, b)[1]) for b in r["sample_bases"]] == r["segments"]
        assert all(s > 0 for s in r["segments"])
    table = lines[1 + len(rows):-1]
    assert table[:3] == ["", "| config | setup | ms/frame | Mrays/s/chip |", "|---|---|---|---|"]
    for line, r in zip(table[3:], rows):
        assert line == (f"| {r['config']} | {r['width']}×{r['height']}, {r['spp']} spp, depth "
                        f"{r['depth']} | {r['ms_per_frame']:.1f} | {r['mrays_s']:.1f} |")
    assert len(table) == 3 + len(rows)


def test_configs_nee_both_times_a_lit_scene_twice(capsys):
    assert configs.main({"CFG_SMALL": "1", "CFG_FRAMES": "1", "CFG_ONLY": "final,light",
                         "CFG_NEE": "both"}) == 0
    rows = json.loads(_lines(capsys)[-1])["rows"]
    assert [(r["config"], r["nee"]) for r in rows] == [
        ("final", False), ("light", False), ("light+nee", True)]
    world, scene = quality.setup("light", "torch", 48, 32)
    direct = quality.renderer(world, "torch", 48, 32, 2, 4, nee=True)
    assert float(direct(scene, crng.key_from_seed(0), 2)[1]) == rows[2]["segments"][1]


# -- stream -------------------------------------------------------------------


STREAM_ENV = {"STREAM_BACKEND": "jnp", "STREAM_WH": "24x16", "STREAM_SPPS": "1,2",
              "STREAM_MIN_SAMPLES": "4", "STREAM_DEPTH": "4"}


@pytest.mark.parametrize("extra", [{}, {"STREAM_BATCH": "2"},
                                   {"STREAM_BATCH": "2", "STREAM_SHARD": "tiles"}])
def test_stream_runs_the_plain_version_with_the_jax_tools_lines(capsys, extra):
    env = {**STREAM_ENV, **extra}
    assert stream.main(env) == 0
    lines = _lines(capsys)
    res = json.loads(lines[-1])
    assert lines[0] == "cpu: the plain PyTorch version"
    assert lines[1] == (f"scene=final 24x16 depth=4 backend=torch "
                        f"shard={env.get('STREAM_SHARD', 'none')} (pipelined streaming)")
    s = stream.settings(env)
    key = crng.key_from_seed(0)
    rows = res["rows"]
    for line, r in zip(lines[2:], rows):
        k = int(env.get("STREAM_BATCH", "1"))
        n_calls = max(2, -(-4 // (r["spp"] * k)))  # tools/stream.py:98
        assert r["K"] == k and r["frames"] == n_calls * k
        assert r["sample_bases"] == [(i + 2) * k * r["spp"] for i in range(n_calls)]
        # tools/stream.py:119-121; its compile seconds are the first call's here.
        assert line == (f"spp={r['spp']:4d} K={k:3d}  {r['frames']:4d} frames "
                        f"{r['ms_per_frame']:8.1f} ms/frame  {r['mrays_s']:7.1f} Mrays/s "
                        f"(first call {r['first_call_s']:.0f}s)")
        # The same rung through the unsharded plain renderer, called directly.
        world, scene = quality.setup("final", "torch", 24, 16)
        cfg = stream.config_of(s, r["spp"]).replace(shard="none")
        direct = dispatch.renderer_factory("torch", world, cfg)(
            world.camera, 24, 16, r["spp"], 4, **renderer_kwargs(world, cfg, frames=k))
        assert [float(direct(scene, key, b)[1]) for b in r["sample_bases"]] == r["segments"]
    table = lines[2 + len(rows):-1]
    assert table[:3] == ["", "| samples/frame | frame batch | ms/frame | Mrays/s/chip |",
                         "|---|---|---|---|"]
    assert table[3:] == [f"| {r['spp']} | {r['K']} | {r['ms_per_frame']:.1f} | "
                         f"{r['mrays_s']:.1f} |" for r in rows]


def test_stream_auto_batch_is_the_ports_policy():
    from myraytracer_tpu_torch.config import CUDA_FRAME_WINDOW

    s = stream.settings({"STREAM_BATCH": "auto"})
    assert [stream.config_of(s, spp).frame_batch for spp in (1, 4, 8, 32, 125)] == [
        CUDA_FRAME_WINDOW, CUDA_FRAME_WINDOW // 4, CUDA_FRAME_WINDOW // 8, 1, 1]
    torch_s = stream.settings({"STREAM_BATCH": "auto", "STREAM_BACKEND": "torch"})
    assert stream.config_of(torch_s, 1).frame_batch == 1


# -- sort_probe ---------------------------------------------------------------


def _jax_keys_of(state):
    """``tools/sort_probe.py:42-47``, written out."""
    k = jax.lax.bitcast_convert_type(state[0], jnp.uint32)
    return k * jnp.uint32(2654435761) ^ (k >> jnp.uint32(13))


def _jax_step_sorted(state):
    """``tools/sort_probe.py:49-53``, written out (``jnp.argsort`` is stable)."""
    perm = jnp.argsort(_jax_keys_of(state))
    return [s[perm] for s in state]


def test_sort_probe_keys_and_step_are_the_jax_tools():
    rs = np.random.RandomState(15)
    pay = [(rs.standard_normal(4096) * 100).astype(np.float32) for _ in range(4)]
    pay[0][:512] = pay[0][512:1024]  # equal keys: the stable order decides
    pay[0][7] = -0.0
    jstate = [jnp.asarray(p) for p in pay]
    tstate = [torch.from_numpy(p) for p in pay]
    np.testing.assert_array_equal(sort_probe.keys_of(tstate).numpy(),
                                  np.asarray(_jax_keys_of(jstate)).astype(np.int64))
    for got, want in zip(sort_probe.step_sorted(tstate), _jax_step_sorted(jstate)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kf = _jax_keys_of(jstate).astype(jnp.float32) * jnp.float32(1e-30)  # tools/sort_probe.py:58
    for got, s in zip(sort_probe.step_base(tstate), jstate):
        np.testing.assert_array_equal(got.numpy(), np.asarray(s + kf))
    # The tool's own state, tools/sort_probe.py:35-38.
    for got, i in zip(sort_probe.initial_state(4096, 15, "cpu"), range(15)):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jnp.arange(4096, dtype=jnp.float32) * (0.37 + 0.11 * i)))
    assert sort_probe.settings({}) == dict(n=960000, payload=15, iters=30)


# -- orbit --------------------------------------------------------------------


def _jax_cameras(base, frames):
    """``tools/orbit.py:53-68``, written out."""
    la, lf = base.lookat, base.lookfrom
    radius = math.dist((lf[0], lf[2]), (la[0], la[2]))
    phi0 = math.atan2(lf[2] - la[2], lf[0] - la[0])
    out = []
    for i in range(frames):
        phi = phi0 + 2.0 * math.pi * i / frames
        out.append(JCamera(
            lookfrom=(la[0] + radius * math.cos(phi), lf[1], la[2] + radius * math.sin(phi)),
            lookat=la, vup=base.vup, vfov_degrees=base.vfov_degrees,
            aperture=base.aperture, focus_dist=base.focus_dist,
        ))
    return out


@pytest.mark.parametrize("frames", [8, 5])
def test_orbit_cameras_and_packing_are_the_jax_tools(frames):
    got = orbit.cameras(tpresets.get_scene("final").camera, frames)
    want = _jax_cameras(jpresets.get_scene("final").camera, frames)
    assert len(got) == frames
    for t, j in zip(got, want):
        for field in ("lookfrom", "lookat", "vup", "vfov_degrees", "aperture", "focus_dist"):
            assert getattr(t, field) == getattr(j, field), field
        for w, h in ((480, 270), (1200, 800)):
            np.testing.assert_array_equal(tcam.pack_camera(t, w, h), jcam.pack_camera(j, w, h))


# -- the tools that need a card -----------------------------------------------


@pytest.mark.parametrize("tool,env", [
    (ladder, {}), (meshscale, {}), (orbit, {}), (sort_probe, {}), (cpu_mesh_baseline, {}),
    (cpu_mesh_baseline, {"CC_TPU": "1"}), (configs, {}), (stream, {}),
])
def test_card_tools_exit_nonzero_without_a_gpu(tool, env, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(env) != 0
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA GPU" in err


def test_cpu_mesh_baseline_cpu_column(capsys):
    if not cpu_backend.cpu_available():
        pytest.skip("the native library does not build here")
    env = {"CC_TPU": "0", "CC_SUBDIVS": "2", "CC_WH": "32x18", "CC_SPP": "1", "CC_DEPTH": "3",
           "CC_THREADS": "2"}
    assert cpu_mesh_baseline.main(env) == 0
    lines = _lines(capsys)
    res = json.loads(lines[-1])
    assert lines[0] == "# 32x18 spp=1 depth=3 cpu_threads=2"
    assert lines[1] == ("subdiv  tris    cpu-bvh(1x)  cpu-bvh(x32 extrap)  card-kernel  "
                        "card/cpu32")
    (r,) = res["rows"]
    assert r["tris"] == tpresets.mesh_scene(2).triangle_count and r["card_mrays"] is None
    assert r["cpu_mrays_per_core"] == max(r["cpu_mrays_each"]) / 2 > 0
    assert r["cpu_x32_projected"] == 32 * r["cpu_mrays_per_core"]
    assert re.fullmatch(rf"\s+2\s+{r['tris']}\s+{NUM}\s+{NUM}\s+-\s+-", lines[2])
    assert cpu_mesh_baseline.settings({"CC_CARD": "0"})["card"] is False
    assert cpu_mesh_baseline.settings({"CC_TPU": "0"})["card"] is False
    assert cpu_mesh_baseline.settings({})["card"] is True


def test_defaults_are_the_jax_tools():
    assert ladder.settings({}) == dict(spps=[32, 125, 500], reps=3, width=1200, height=800)
    assert meshscale.settings({}) == dict(subdivs=[2, 3, 4], spp=8, depth=20, reps=2,
                                          width=480, height=270)
    assert orbit.settings({}) == dict(frames=8, spp=8, width=480, height=270, out_dir=None)
    s = stream.settings({})
    assert (s["spps"], s["width"], s["height"], s["depth"], s["scene"], s["min_samples"],
            s["backend"], s["batch"], s["shard"]) == (
        [1, 4, 8, 32, 125], 1200, 800, 50, "final", 256, "cuda", "1", "none")
    c = cpu_mesh_baseline.settings({})
    assert (c["subdivs"], c["width"], c["height"], c["spp"], c["depth"], c["reps"]) == (
        [2, 3, 4, 5], 480, 270, 8, 20, 2)
    assert [g[1].SUPER_MIN for g in meshscale.GATES] == [24, 10 ** 9]
