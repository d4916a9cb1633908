"""The adaptive session's statistics on the CPU: a CPU state takes the
plain functions (``_block_scores``, ``select_blocks``, ``_update_stats``)
and never the CUDA kernels (``csrc/adaptive.cu``, held to those functions
on the card by ``tests/test_torch_adaptive_stats_gpu.py``), whose wrappers
refuse what they do not take rather than fall back. The select kernel's
rank rule is written here in numpy and held to ``select_blocks``' order."""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import re

import numpy as np
import pytest
import torch

from benchmark.profiling import TRACE_KERNELS
from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.kernels import adaptive as kadaptive
from myraytracer_tpu_torch.kernels import build as kbuild
from myraytracer_tpu_torch.parallel import sharding
from myraytracer_tpu_torch.render import adaptive
from myraytracer_tpu_torch.scene import presets

BH, BW = adaptive.BLOCK_H, adaptive.BLOCK_W


@pytest.fixture
def no_kernel(monkeypatch):
    """The kernels' library may not load: a CPU path that reached it fails."""
    def refuse():
        raise AssertionError("the adaptive kernels' library was loaded on the CPU path")

    for kern in (kadaptive.SELECT, kadaptive.FOLD):
        monkeypatch.setattr(kern, "load", refuse)
        monkeypatch.setattr(kern, "launches", 0)


def _state(nb1=5, seed=0):
    rs = np.random.RandomState(seed)
    return adaptive.state_from_numpy((
        rs.random_sample((nb1, BH, BW, 3)), rs.random_sample((nb1, BH, BW)),
        rs.random_sample((nb1, BH, BW)) * 2, rs.randint(0, 40, nb1), rs.randint(0, 5, nb1),
        rs.randint(0, 900, nb1)))


def _fold_args(case):
    fbB, s1, s2, n_b, r_b, cursor = _state()
    idx = torch.tensor([3, 0, 4], dtype=torch.int64)
    sums = torch.ones((2, 3, BH, BW, 3), dtype=torch.float32)
    k = 8
    if case == "f64 framebuffer":
        fbB = fbB.double()
    elif case == "i64 sample counts":
        n_b = n_b.long()
    elif case == "i32 cursors":
        cursor = cursor.int()
    elif case == "i32 ids":
        idx = idx.int()
    elif case == "non-contiguous s1":
        s1 = s1.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "rows of another count":
        s2 = s2[:4]
    elif case == "sums of one window, unstacked":
        sums = sums[0]
    elif case == "sums for other ids":
        sums = sums[:, :2]
    elif case == "ids of two dimensions":
        idx = idx[None]
    elif case == "no samples":
        k = 0
    return (fbB, s1, s2, n_b, r_b, cursor, idx, sums, k)


FOLD_BAD = ["f64 framebuffer", "i64 sample counts", "i32 cursors", "i32 ids",
            "non-contiguous s1", "rows of another count", "sums of one window, unstacked",
            "sums for other ids", "ids of two dimensions", "no samples"]


@pytest.mark.parametrize("case", FOLD_BAD)
def test_fold_wrapper_refuses_what_the_kernel_does_not_take(no_kernel, case):
    with pytest.raises(ValueError, match="must be|a fold needs"):
        kadaptive.fold(*_fold_args(case))
    assert kadaptive.FOLD.launches == 0


def _select_args(case):
    _, s1, s2, _, r_b, _ = _state()
    args = dict(s1=s1, s2=s2, r_b=r_b, n_sel=2, n_live=4, base=0, sentinel=4)
    if case == "f64 s1":
        args["s1"] = s1.double()
    elif case == "i64 rounds":
        args["r_b"] = r_b.long()
    elif case == "s2 of another block":
        args["s2"] = s2[:, :, :32].contiguous()
    elif case == "non-contiguous s2":
        args["s2"] = s2.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "no picks":
        args["n_sel"] = 0
    elif case == "more picks than candidates":
        args["n_sel"] = 5
    elif case == "more live ids than candidates":
        args["n_live"] = 5
    return args


SELECT_BAD = ["f64 s1", "i64 rounds", "s2 of another block", "non-contiguous s2", "no picks",
              "more picks than candidates", "more live ids than candidates"]


@pytest.mark.parametrize("case", SELECT_BAD)
def test_select_wrapper_refuses_what_the_kernel_does_not_take(no_kernel, case):
    with pytest.raises(ValueError, match="must be|must lie in"):
        kadaptive.select(**_select_args(case))
    assert kadaptive.SELECT.launches == 0


def test_the_wrappers_refuse_cpu_tensors(no_kernel):
    with pytest.raises(ValueError, match="run on cuda tensors, not cpu"):
        kadaptive.select(**_select_args("good"))
    with pytest.raises(ValueError, match="run on cuda tensors, not cpu"):
        kadaptive.fold(*_fold_args("good"))
    assert (kadaptive.SELECT.launches, kadaptive.FOLD.launches) == (0, 0)


def _cfg():
    return RenderConfig(width=128, height=64, samples_per_frame=1, ray_depth=2,
                        backend="torch", seed=4)


@pytest.mark.parametrize("stripes", [1, 3])
def test_cpu_session_runs_the_plain_statistics_without_the_kernels(no_kernel, monkeypatch,
                                                                   stripes):
    """A bootstrap and two auto rounds, flat and over three stripes (the
    last with dead ids): every fold is ``_update_stats`` and every pick
    ``pick_blocks``, and the kernels' library never loads."""
    calls = {"fold": 0, "pick": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(adaptive, "_update_stats", counted("fold", adaptive._update_stats))
    monkeypatch.setattr(adaptive, "pick_blocks", counted("pick", adaptive.pick_blocks))
    cfg = _cfg()
    if stripes > 1:
        cfg = RenderConfig(**{**cfg.__dict__, "shard": "tiles"})
        s = adaptive.AdaptiveSession(presets.three_sphere_scene(), cfg, n_sel=2,
                                     mesh=sharding.default_mesh(["cpu"] * stripes))
        assert s.local_nb * stripes > s.n_blocks  # dead ids in the last stripe
    else:
        s = adaptive.AdaptiveSession(presets.three_sphere_scene(), cfg, n_sel=2)
    s.bootstrap()
    folds = calls["fold"]
    s.step()
    s.step()
    assert calls["pick"] == 2 * stripes
    assert calls["fold"] - folds == 2 * stripes * s.windows
    assert (kadaptive.SELECT.launches, kadaptive.FOLD.launches) == (0, 0)
    assert not any(src == kadaptive.SOURCE for src, _ in kbuild._LIBS)


def order_keys(scores: np.ndarray) -> np.ndarray:
    """``order_key`` of ``csrc/adaptive.cu`` in numpy: the score's order as
    an unsigned key (NaN highest, -0 as +0) above the complement of the
    id, so a larger key comes first and the lower id first among equals."""
    s = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    b = s.view(np.uint32).astype(np.uint64)
    u = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    u = np.where(np.isnan(s), 0xFFFFFFFF, u).astype(np.uint64)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - np.arange(len(s), dtype=np.uint64))


def rank_picks(scores: np.ndarray, n_sel: int) -> np.ndarray:
    """The kernel's picks: candidate i goes to place ``rank_i``, the count
    of keys above its own, if that is below ``n_sel``."""
    keys = order_keys(scores)
    rank = (keys[None, :] > keys[:, None]).sum(axis=1)
    assert sorted(rank) == list(range(len(scores)))  # a permutation: the keys differ
    picks = np.empty(n_sel, np.int64)
    for i in np.nonzero(rank < n_sel)[0]:
        picks[rank[i]] = i
    return picks


NAN, INF = np.float32(np.nan), np.float32(np.inf)
RANK_CASES = {
    "bootstrap ties at +inf": [INF] * 9,
    "ties at inf, 2 and 0": [0.0, 2.0, 0.0, 2.0, INF, 0.0, INF, -0.0, 2.0],
    "NaN above inf, -0 ties +0": [1.0, NAN, INF, NAN, -INF, INF, 0.0, -0.0, 0.0],
    "dead ids at -inf": [0.5, 3e-39, 1e-45, 0.25, 0.5, -INF, -INF, -INF, -INF],
    "random": list(np.random.RandomState(3).random_sample(9).astype(np.float32)),
    "subnormal and huge": [1e-45, 2e-45, 1e38, 3.4e38, 1e-45, 0.0, 1e38, 1.0, 3e-39],
}


@pytest.mark.parametrize("n_sel", [1, 4, 9])
@pytest.mark.parametrize("case", RANK_CASES)
def test_rank_rule_gives_select_blocks_order(case, n_sel):
    scores = np.asarray(RANK_CASES[case], np.float32)
    want = adaptive.select_blocks(torch.from_numpy(scores), n_sel).numpy()
    np.testing.assert_array_equal(rank_picks(scores, n_sel), want)


def test_pick_blocks_masks_dead_ids_to_the_spare_row_and_the_sentinel():
    """A last stripe of 4 candidates of which 2 are alive: dead ids, even
    with the highest scores, fall behind every live one."""
    _, s1, s2, _, r_b, _ = _state(nb1=5, seed=7)
    r_b[:] = 1  # every score +inf: the dead ids would win without the mask
    rows, ids = adaptive.pick_blocks(s1, s2, r_b, 3, 2, 40, 42)
    assert rows.tolist() == [0, 1, 4] and ids.tolist() == [40, 41, 42]


def test_flat_pick_is_select_blocks_of_the_scores():
    _, s1, s2, _, r_b, _ = _state(nb1=9, seed=1)
    rows, ids = adaptive.pick_blocks(s1, s2, r_b, 5, 8, 0, 8)
    want = adaptive.select_blocks(adaptive._block_scores(s1, s2, r_b)[:8], 5)
    assert torch.equal(rows, want) and torch.equal(ids, want)


def test_kernel_names_avoid_the_profilers_trace_kernels():
    """The profiler counts every kernel whose name holds none of
    ``TRACE_KERNELS`` in ``adaptive.ops_ms_per_round``; both statistics
    kernels must be among them."""
    names = re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?(?:void\s+)?"
                       r"(\w+)\s*\(", kadaptive.SOURCE.read_text())
    assert names == ["adaptive_select_kernel", "adaptive_fold_kernel"]
    assert not [n for n in names for t in TRACE_KERNELS if t in n]


def test_fold_bytes_is_the_sums_once_and_the_state_twice():
    row = 2048 * 20 + 16
    assert kadaptive.fold_bytes(476, 118, 15) == 15 * 118 * 2048 * 12 + 118 * 8 + 2 * 476 * row
    assert kadaptive.fold_bytes(476, 118, 15) == 82_509_616
    assert kadaptive.fold_bytes(2, 1, 1) == 2048 * 12 + 8 + 2 * 2 * row


def test_select_bytes_is_the_candidates_statistics_once():
    assert kadaptive.select_bytes(476, 118) == 475 * (2048 * 8 + 4) + 118 * 16 == 7_786_188
    assert kadaptive.select_bytes(2, 1) == 2048 * 8 + 4 + 16
