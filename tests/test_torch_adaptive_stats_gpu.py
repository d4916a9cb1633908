"""The adaptive statistics kernels (``csrc/adaptive.cu``) on a GPU, held bit
for bit to the plain functions of ``render/adaptive.py`` run on CPU copies
of the same inputs.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip. The file
imports no JAX, so on a machine with a GPU they run with:

    python -m pytest tests/test_torch_adaptive_stats_gpu.py --noconftest -m cuda

``select`` is held to ``pick_blocks`` (``_block_scores``, then
``select_blocks`` with dead ids at -inf) and ``fold`` to F calls of
``_update_stats``: every value of the state, bitwise, on inputs made with
numpy, zeros and subnormals among the sums. NaN is kept out of the fold's
inputs: the card and the CPU give a NaN different bits. Then two whole
sessions on final, flat and over three stripes of the card, against the
plain statistics replayed on the CPU from the same window sums.
"""

import numpy as np
import pytest
import torch

from myraytracer_tpu_torch.config import RenderConfig
from myraytracer_tpu_torch.kernels import adaptive as kadaptive
from myraytracer_tpu_torch.parallel import sharding
from myraytracer_tpu_torch.render import adaptive
from myraytracer_tpu_torch.render.adaptive import AdaptiveSession
from myraytracer_tpu_torch.scene import presets

pytestmark = pytest.mark.cuda

BH, BW = adaptive.BLOCK_H, adaptive.BLOCK_W
SUBNORMALS = np.float32([0.0, -0.0, 1e-40, 1e-45, 3e-39, -1e-40])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def state(seed, nb1, r_max=8):
    """A state as a session holds it: no -0 and no NaN in s1 and s2, s2 at
    least about s1^2 / r, counters below 2^31."""
    rs = np.random.RandomState(seed)
    r_b = rs.randint(0, r_max, nb1).astype(np.int32)
    s1 = (rs.exponential(1.0, (nb1, BH, BW)) * np.maximum(r_b, 1)[:, None, None]).astype(np.float32)
    s2 = (s1 * s1 / np.maximum(r_b, 1)[:, None, None]
          * rs.uniform(0.999, 1.5, (nb1, BH, BW))).astype(np.float32)
    return (rs.exponential(0.5, (nb1, BH, BW, 3)).astype(np.float32), s1, s2,
            (r_b * rs.randint(1, 9, nb1)).astype(np.int32), r_b,
            rs.randint(0, 2**30, nb1).astype(np.int64))


def window_sums(seed, windows, n_sel, k):
    rs = np.random.RandomState(seed)
    sums = rs.exponential(0.7 * k, (windows, n_sel, BH, BW, 3)).astype(np.float32)
    hit = rs.random_sample(sums.shape) < 0.05
    sums[hit] = rs.choice(SUBNORMALS, int(hit.sum()))
    return sums


def bits(t):
    t = t.cpu().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_state_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(bits(g), bits(w))


def plain_fold(st, idx, sums, k):
    st = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in st)
    for w in torch.from_numpy(sums):
        st = adaptive._update_stats(*st, torch.from_numpy(idx), w, k)
    return st


def kernel_fold(st, idx, sums, k, dev):
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in st]
    before = kadaptive.FOLD.launches
    out = kadaptive.fold(*args, torch.from_numpy(idx).to(dev), torch.from_numpy(sums).to(dev), k)
    assert kadaptive.FOLD.launches == before + 1
    for a, o, s in zip(args, out, st):  # fresh tensors; the input is left as it was
        assert a.data_ptr() != o.data_ptr() and torch.equal(bits(a), bits(torch.from_numpy(s)))
    return out


@pytest.mark.parametrize("k", [8, 3, 5])
@pytest.mark.parametrize("windows", [1, 2, 15])
def test_fold_is_update_stats_bitwise(cuda, windows, k):
    """A round of 118 of 475 blocks, one id repeated and the spare row named
    twice, F windows of k samples."""
    nb1, n_sel = 476, 118
    rs = np.random.RandomState(100 * windows + k)
    idx = rs.permutation(nb1 - 1)[:n_sel].astype(np.int64)
    idx[[5, 77]] = nb1 - 1
    idx[9] = idx[40]
    st = state(windows + k, nb1)
    sums = window_sums(7 * windows + k, windows, n_sel, k)
    assert_state_bitwise(kernel_fold(st, idx, sums, k, cuda), plain_fold(st, idx, sums, k))


@pytest.mark.parametrize("sentinel_sums", ["zero", "nonzero"])
def test_fold_of_the_bootstraps_last_chunk(cuda, sentinel_sums):
    """3 real ids and 115 sentinels on the spare row, which is folded once
    a window with the sums of all its occurrences added in order."""
    nb1, n_sel, windows, k = 476, 118, 15, 8
    idx = np.full(n_sel, nb1 - 1, np.int64)
    idx[:3] = [472, 473, 474]
    st = state(1, nb1, r_max=2)
    sums = window_sums(2, windows, n_sel, k)
    if sentinel_sums == "zero":
        sums[:, 3:] = 0.0
    assert_state_bitwise(kernel_fold(st, idx, sums, k, cuda), plain_fold(st, idx, sums, k))


def test_fold_of_subnormal_and_zero_sums(cuda):
    nb1, n_sel, windows, k = 40, 12, 3, 3
    rs = np.random.RandomState(5)
    idx = rs.permutation(nb1)[:n_sel].astype(np.int64)
    st = list(state(5, nb1))
    st[0][:] = rs.choice(SUBNORMALS[[0, 2, 3, 4]], st[0].shape)
    st[1][:] = np.abs(rs.choice(SUBNORMALS, st[1].shape))
    st[2][:] = np.abs(rs.choice(SUBNORMALS, st[2].shape))
    sums = rs.choice(SUBNORMALS, (windows, n_sel, BH, BW, 3)).astype(np.float32)
    assert_state_bitwise(kernel_fold(st, idx, sums, k, cuda), plain_fold(st, idx, sums, k))


def kernel_pick(st, n_sel, n_live, base, sentinel, dev):
    _, s1, s2, _, r_b, _ = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in st)
    before = kadaptive.SELECT.launches
    got = kadaptive.select(s1, s2, r_b, n_sel, n_live, base, sentinel)
    assert kadaptive.SELECT.launches == before + 1
    return tuple(t.cpu() for t in got)


def plain_pick(st, n_sel, n_live, base, sentinel):
    _, s1, s2, _, r_b, _ = (torch.from_numpy(np.ascontiguousarray(a)) for a in st)
    return adaptive.pick_blocks(s1, s2, r_b, n_sel, n_live, base, sentinel)


def select_case(case):
    """(state, n_sel, n_live, base, sentinel) of each case."""
    nb1 = 476
    st = state(11, nb1)
    if case == "a round":
        return st, 118, nb1 - 1, 0, nb1 - 1
    if case == "r below 2":  # +inf ties, lowest id first
        st[4][::3] = np.int32(1)
        st[4][1::7] = np.int32(0)
        return st, 200, nb1 - 1, 0, nb1 - 1
    if case == "equal finite scores":
        for dst in range(0, 300, 4):
            for i in (1, 2, 4):
                st[i][dst + 1] = st[i][dst]
                st[i][dst + 3] = st[i][dst]
        return st, 150, nb1 - 1, 0, nb1 - 1
    if case == "zero and NaN scores":
        st[4][10:20] = st[4][30:33] = 3
        st[1][10:20], st[2][10:15], st[2][15:20] = 0.0, 0.0, -0.0  # scores +0 and -0: ties
        st[1][30:33, 0, 0], st[2][30:33, 0, 0] = np.inf, np.inf  # inf - inf: NaN
        return st, 100, nb1 - 1, 0, nb1 - 1
    if case == "a striped state with dead ids":  # the last of 4 stripes of 1,497 blocks
        st = state(12, 376)
        st[4][::5] = 1
        return st, 94, 1497 - 3 * 375, 3 * 375, 1497
    if case == "more candidates than a key tile":
        st = state(13, 5001)
        st[4][4000:] = 1
        return st, 1250, 5000, 0, 5000
    raise KeyError(case)


@pytest.mark.parametrize("case", ["a round", "r below 2", "equal finite scores",
                                  "zero and NaN scores", "a striped state with dead ids",
                                  "more candidates than a key tile"])
def test_select_is_pick_blocks_bitwise(cuda, case):
    st, n_sel, n_live, base, sentinel = select_case(case)
    got = kernel_pick(st, n_sel, n_live, base, sentinel, cuda)
    want = plain_pick(st, n_sel, n_live, base, sentinel)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_a_dead_stripe_picks_the_spare_row(cuda):
    st = state(14, 9)
    got = kernel_pick(st, 3, 0, 80, 70, cuda)
    assert got[0].tolist() == [8, 8, 8] and got[1].tolist() == [70, 70, 70]


def _bad(case, dev):
    st = [torch.from_numpy(a).to(dev) for a in state(3, 6)]
    idx = torch.tensor([0, 5], dtype=torch.int64, device=dev)
    sums = torch.zeros((2, 2, BH, BW, 3), dtype=torch.float32, device=dev)
    if case == "cpu framebuffer":
        st[0] = st[0].cpu()
    elif case == "cpu ids":
        idx = idx.cpu()
    elif case == "cpu sums":
        sums = sums.cpu()
    elif case == "f64 s2":
        st[2] = st[2].double()
    elif case == "non-contiguous sums":
        sums = sums.transpose(2, 3).contiguous().transpose(2, 3)
    return (*st, idx, sums, 8)


@pytest.mark.parametrize("case", ["cpu framebuffer", "cpu ids", "cpu sums", "f64 s2",
                                  "non-contiguous sums"])
def test_kernels_refuse_what_they_do_not_take(cuda, case):
    args = _bad(case, cuda)
    before = (kadaptive.FOLD.launches, kadaptive.SELECT.launches)
    with pytest.raises(ValueError):
        kadaptive.fold(*args)
    with pytest.raises(ValueError):
        kadaptive.select(args[1].cpu(), args[2], args[4], 1, 5, 0, 5)
    assert (kadaptive.FOLD.launches, kadaptive.SELECT.launches) == before


def _cfg(**kw):
    return RenderConfig(**{**dict(width=200, height=100, samples_per_frame=2, ray_depth=6,
                                  backend="cuda", seed=9, frame_batch=3), **kw})


@pytest.mark.parametrize("stripes", [1, 3])
def test_session_is_the_plain_statistics_with_two_launches_a_round(cuda, tmp_path, stripes):
    """final at 200x100 (16 blocks), F = 3: a bootstrap and three auto
    rounds on the kernels, flat and over three stripes of the card (the
    last with dead ids), against the plain picks and folds replayed on the
    CPU from the same window sums: one fold a call and one select a stripe
    a round, and the state, the framebuffer, the spp map and the
    checkpoint's arrays equal."""
    if stripes > 1:
        s = AdaptiveSession(presets.get_scene("final"), _cfg(shard="tiles"), n_sel=5,
                            mesh=sharding.default_mesh(["cuda:0"] * stripes))
        assert s.local_nb * stripes > s.n_blocks
    else:
        s = AdaptiveSession(presets.get_scene("final"), _cfg(), n_sel=5)
    assert s.windows == 3
    calls = []

    def capture(render):
        def run(scene, key, ids, samp0):
            sums, segs = render(scene, key, ids, samp0)
            calls.append((ids.cpu(), sums.cpu()))
            return sums, segs
        return run

    if stripes > 1:
        make = s._make_render
        s._make_render = lambda: capture(make())
    else:
        s._render = capture(s._render)
    states = (lambda: [s._state]) if stripes == 1 else (lambda: s._state)
    mirror = [tuple(t.cpu() for t in st) for st in states()]
    launches = []
    for step in range(4):
        before = (kadaptive.SELECT.launches, kadaptive.FOLD.launches)
        seen = len(calls)
        s.step()
        launches.append((kadaptive.SELECT.launches - before[0],
                         kadaptive.FOLD.launches - before[1]))
        for c, (ids, sums) in enumerate(calls[seen:]):
            d = c % stripes
            base = d * s.local_nb
            if step:  # an auto round: the plain picks of the mirror's state
                _, s1, s2, _, r_b, _ = mirror[d]
                n_live = min(s.local_nb, max(0, s.n_blocks - base))
                rows, want_ids = adaptive.pick_blocks(s1, s2, r_b, s.n_sel_local, n_live, base,
                                                      s.n_blocks)
                assert torch.equal(ids, want_ids)
            else:
                rows = torch.where(ids < s.n_blocks, ids - base, s.local_nb)
            for w in sums:
                mirror[d] = adaptive._update_stats(*mirror[d], rows, w, 2)
    chunks = -(-s.local_nb // s.n_sel_local)
    assert launches == [(0, chunks * stripes)] + [(stripes, stripes)] * 3
    for st, want in zip(states(), mirror):
        assert_state_bitwise(st, want)

    def stacked(i):
        return mirror[0][i] if stripes == 1 else torch.stack([m[i] for m in mirror])

    s.save_checkpoint(tmp_path / "a.npz")
    with np.load(tmp_path / "a.npz") as data:
        for i in range(6):
            got = data[f"state{i}"]
            np.testing.assert_array_equal(got.view(np.uint8),
                                          stacked(i).numpy().astype(got.dtype).view(np.uint8))
    assert torch.equal(bits(s.framebuffer), bits(s._image(stacked(0))))
    assert (s.spp_map[::BH, ::BW].reshape(-1) == s._unstripe(stacked(3)).numpy()).all()
