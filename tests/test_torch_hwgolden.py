"""The port's hardware-golden helpers (``myraytracer_tpu_torch.utils.hwgolden``)
against the JAX package's, and the cases of ``tests/test_hwgolden.py``.

The digests themselves come from the card (``python -m
myraytracer_tpu_torch.goldens``, the bench); these tests hold the pure
helpers: hashes and keys equal to the JAX package's on the same inputs,
the table's round trip, and the match / mismatch / absent verdicts, with a
mismatch called a code change under the same torch, CUDA and nvcc
versions and drift under others.
"""

import cpu_share  # noqa: F401  (first: this process's share of the CPU)

import numpy as np
import pytest

from myraytracer_tpu.utils import hwgolden as jhw
from myraytracer_tpu_torch.utils import hwgolden


def test_frame_hash_exact_bits():
    a = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    h1 = hwgolden.frame_hash(a)
    assert h1 == hwgolden.frame_hash(a.copy())
    b = a.copy()
    b[0, 0, 0] = np.nextafter(b[0, 0, 0], 1e9)  # one ulp flips the hash
    assert hwgolden.frame_hash(b) != h1
    assert hwgolden.frame_hash(a.reshape(3, 2, 2)) != h1
    assert hwgolden.frame_hash(a.astype(np.float64)) != h1
    c = np.arange(24, dtype=np.float32).reshape(2, 4, 3)[:, ::2, :]
    assert hwgolden.frame_hash(c) == hwgolden.frame_hash(np.ascontiguousarray(c))


@pytest.mark.parametrize("shape,dtype", [((8, 16, 3), np.float32), ((5, 7), np.float64),
                                         ((4, 4, 3), np.uint8)])
def test_frame_hash_equals_jax(shape, dtype):
    a = (np.random.RandomState(3).random_sample(shape) * 255).astype(dtype)
    assert hwgolden.frame_hash(a) == jhw.frame_hash(a)
    assert hwgolden.frame_hash(a[::2]) == jhw.frame_hash(a[::2])


def test_frame_hash_of_a_torch_tensor_is_its_bits():
    import torch

    a = np.random.RandomState(4).random_sample((6, 4, 3)).astype(np.float32)
    assert hwgolden.frame_hash(torch.from_numpy(a)) == jhw.frame_hash(a)


def test_entry_key_components():
    k = hwgolden.entry_key("final", 1200, 800, 500, 50, "cuda", "NVIDIA H100 80GB HBM3")
    assert k == "final:1200x800:spp500:d50:cuda:eager:NVIDIA H100 80GB HBM3"
    assert hwgolden.EXEC_PATH == "eager"
    # The components and their order are the JAX package's.
    for args in [("final", 1200, 800, 500, 50, "pallas", "TPU v5 lite", "export"),
                 ("cornell+nee", 256, 128, 4, 8, "cuda", "NVIDIA H100 80GB HBM3", "eager")]:
        assert hwgolden.entry_key(*args) == jhw.entry_key(*args)
    assert k != hwgolden.entry_key("final", 1200, 800, 500, 50, "cuda", "NVIDIA A100")


def test_table_roundtrip_and_check(tmp_path):
    path = tmp_path / "hashes.json"
    assert hwgolden.load_table(path) == {}
    digest = hwgolden.frame_hash(np.ones((2, 2, 3), np.float32))
    table = {"k1": hwgolden.make_entry(digest, 1.0), "k2": hwgolden.make_entry(digest, 1.0,
                                                                              mrays=2400.5)}
    hwgolden.save_table(table, path)
    loaded = hwgolden.load_table(path)
    assert loaded["k1"]["hash"] == digest and loaded["k1"]["exec_path"] == "eager"
    assert set(hwgolden.VERSION_FIELDS) <= set(loaded["k1"]) and "mrays" not in loaded["k1"]
    assert loaded["k2"]["mrays"] == 2400.5
    assert loaded["k1"]["torch"] == hwgolden.versions()["torch"]
    assert not (tmp_path / "tests").exists()

    status, rec = hwgolden.check("k1", digest, loaded)
    assert status == "match" and rec["hash"] == digest
    status, rec = hwgolden.check("k1", "0" * 64, loaded)
    assert status == "mismatch"
    status, rec = hwgolden.check("nope", digest, loaded)
    assert status == "absent" and rec is None


def test_default_table_is_the_ports_own():
    assert hwgolden.DEFAULT_PATH.name == "cuda_hashes.json"
    assert hwgolden.DEFAULT_PATH.parent == jhw.DEFAULT_PATH.parent
    assert hwgolden.DEFAULT_PATH != jhw.DEFAULT_PATH


@pytest.mark.parametrize("field", ["torch", "cuda", "nvcc"])
def test_describe_verdicts(field):
    digest = "a" * 64
    now = hwgolden.versions()
    rec_same = {"hash": "b" * 64, **now}
    rec_other = {**rec_same, field: "0.0.1"}
    assert "no recorded hash" in hwgolden.describe("absent", "k", digest, None)
    assert "bitwise match" in hwgolden.describe("match", "k", digest, rec_same)
    same = hwgolden.describe("mismatch", "k", digest, rec_same)
    assert "MISMATCH" in same and "code change" in same and hwgolden.same_versions(rec_same)
    drift = hwgolden.describe("mismatch", "k", digest, rec_other)
    assert "MISMATCH" in drift and "compiler drift" in drift and f"{field} 0.0.1 ->" in drift
    assert not hwgolden.same_versions(rec_other)
