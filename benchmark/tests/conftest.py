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
