"""Shared helpers of the benchmark's CPU tests: the cells at a size a test
run holds, run through the harness on the program's plain integrator."""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import registry, run  # noqa: E402

CELLS = ("final.offline", "cornell.offline", "final.progressive", "final.orbit")
ADAPTIVE_CELLS = ("final.adaptive",)
MESH_CELLS = ("mesh5.offline",)
SEED = 2**31 + 77


@pytest.fixture(scope="session")
def reg():
    return registry.Registry(ROOT)


@pytest.fixture(scope="session")
def program():
    torch.set_num_threads(2)
    return run.load_program()


def tiny(cell, width=24, height=16, spp=4, depth=6):
    """``cell`` at a test's size: the configuration's scene kept, its
    image, samples and depth cut, and every pixel checked (so the
    segments compare exactly)."""
    cfg = dict(cell.config, width=width, height=height, samples_per_pixel=spp, max_depth=depth)
    tf = dict(cell.traffic, check=dict(cell.traffic["check"], pixels=width * height))
    return cell._replace(config=cfg, traffic=tf)


def run_tiny(reg, program, name, seconds=0.6, seed=SEED, **kw):
    """One run of the tiny cell on the CPU through ``run.run_cell``."""
    return run.run_cell(tiny(reg.cell(name)), seed, seconds, False, program, backend="torch",
                        reg=reg, **kw)


def tiny_mesh(cell, width=48, height=32, spp=2, cut=3):
    """A mesh ``cell`` at a test's size: its image and samples cut, every
    icosphere ``cut`` subdivisions coarser (``mesh:5``'s scene becomes
    ``mesh:2``'s, 414 triangles, under the program's CPU triangle BVH's
    512), its depth kept, and every pixel checked."""
    cell = tiny(cell, width, height, spp, cell.config["max_depth"])
    scene = dict(cell.config["scene"], icospheres=[
        dict(s, subdivisions=s["subdivisions"] - cut) for s in cell.config["scene"]["icospheres"]])
    return cell._replace(config=dict(cell.config, scene=scene))


def run_tiny_mesh(reg, program, name="mesh5.offline", seconds=0.6, seed=SEED, **kw):
    """One run of the tiny mesh cell on the CPU through ``run.run_cell``."""
    return run.run_cell(tiny_mesh(reg.cell(name)), seed, seconds, False, program,
                        backend="torch", reg=reg, **kw)


def tiny_adaptive(cell, width=96, height=40, spp=2, budget=8, windows=2, depth=6):
    """An adaptive ``cell`` at a test's size: 2 x 2 blocks of 64 x 32, the
    right and bottom ones hanging over the image's edge, one block a round,
    ``windows`` windows of ``spp`` samples a launch and a budget of
    ``budget`` frames; every pixel checked."""
    cfg = dict(cell.config, width=width, height=height, max_depth=depth)
    tf = dict(cell.traffic, samples_per_window=spp, budget_frames=budget,
              windows_per_round=windows, check=dict(cell.traffic["check"], pixels=width * height))
    return cell._replace(config=cfg, traffic=tf)


def run_tiny_adaptive(reg, program, name="final.adaptive", seconds=0.3, seed=SEED, **kw):
    """One run of the tiny adaptive cell on the CPU through ``run.run_cell``:
    the warm image, then at least one image in the window."""
    return run.run_cell(tiny_adaptive(reg.cell(name)), seed, seconds, False, program,
                        backend="torch", reg=reg, **kw)
