"""K2 (the extended pool) of paffy_tpu_torch against paffy_tpu on the CPU.

Inputs are numpy arrays from a seed, handed to both packages; the JAX
function runs on the CPU.  Byte outputs: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paffy_tpu.ops import mismatch as ref_mm
from paffy_tpu.ops.mismatch_device import build_ext_pool as ref_build_ext
from paffy_tpu_torch import kernels
from paffy_tpu_torch.ops import mismatch as port_mm
from paffy_tpu_torch.ops.mismatch_device import (build_ext_pool,
                                                 build_ext_pool_plain)
from ref_native import paffy_tpu_lib  # noqa: F401

IUPAC = b"ACGTNMKRYVBHDWSX"


def ref_ext(pool: np.ndarray) -> np.ndarray:
    return np.asarray(ref_build_ext(jnp.asarray(pool)))


def random_pool(seed, n, alphabet):
    rng = np.random.default_rng(seed)
    if alphabet == "any":
        return rng.integers(0, 256, n, dtype=np.uint8)
    letters = np.frombuffer(alphabet, dtype=np.uint8)
    pool = letters[rng.integers(0, len(letters), n)]
    lower = rng.random(n) < 0.3
    pool[lower] |= 0x20
    return pool


def test_plain_ext_all_byte_values():
    pool = np.concatenate([np.arange(256, dtype=np.uint8),
                           np.arange(255, -1, -1, dtype=np.uint8)])
    got = build_ext_pool_plain(torch.from_numpy(pool)).numpy()
    assert got.dtype == np.uint8 and got.shape == (2 * len(pool),)
    np.testing.assert_array_equal(got, ref_ext(pool))


@pytest.mark.parametrize("alphabet", [b"ACGT", IUPAC, "any"],
                         ids=["acgt", "iupac", "any"])
@pytest.mark.parametrize("n", [1, 7, 4099])
def test_plain_ext_random_pools(alphabet, n):
    pool = random_pool(n, n, alphabet)
    got = build_ext_pool_plain(torch.from_numpy(pool)).numpy()
    np.testing.assert_array_equal(got, ref_ext(pool))


def test_wrapper_on_cpu_runs_plain_without_launching():
    pool = torch.from_numpy(random_pool(3, 1000, IUPAC))
    before = dict(kernels.LAUNCHES)
    assert torch.equal(build_ext_pool(pool), build_ext_pool_plain(pool))
    assert kernels.LAUNCHES == before


def test_wrapper_rejects_non_u8_pools():
    with pytest.raises(ValueError):
        build_ext_pool(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        build_ext_pool(torch.zeros((2, 4), dtype=torch.uint8))


def test_kernels_run_on_cuda0_only(monkeypatch):
    # the kernels run on the CUDA devices of the process, cuda:0 to
    # cuda:n-1 (two here, counted by a stand-in), and on nothing else
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert kernels.check_device(torch.device("cuda", 0)) == 0
    assert kernels.check_device(torch.device("cuda")) == 0
    assert kernels.check_device(torch.device("cuda", 1)) == 1
    for dev in (torch.device("cuda", 2), torch.device("meta")):
        with pytest.raises(ValueError):
            kernels.check_device(dev)
    with pytest.raises(ValueError):
        build_ext_pool(torch.zeros(8, dtype=torch.uint8, device="meta"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for dev in (torch.device("cuda", 0), torch.device("cuda")):
        with pytest.raises(ValueError):
            kernels.check_device(dev)


def _seqs(seed, alphabet):
    out = {}
    for k, n in enumerate((300, 1, 5000)):
        out[f"s{k}"] = random_pool(seed + k, n, alphabet).tobytes().decode(
            "latin-1")
    return out


@pytest.mark.parametrize("alphabet", [b"ACGT", IUPAC, "any"],
                         ids=["acgt", "iupac", "any"])
def test_from_reference_ext_equals_tpu_ext(monkeypatch, alphabet):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")
    ref = ref_mm.SequencePool(_seqs(11, alphabet))
    g = ref._guard
    port = port_mm.SequencePool.from_arrays(ref.host_pool[g: g + ref._data_len],
                                            ref.index)
    assert port.index == ref.index and port.pool_len == ref.pool_len
    np.testing.assert_array_equal(port.host_pool, ref.host_pool)
    assert port.ext.device.type == "cpu"
    np.testing.assert_array_equal(port.ext.numpy(), np.asarray(ref.ext))
    np.testing.assert_array_equal(
        port.offsets_for(np.array(["s2", "s0"], dtype=object), "query"),
        ref.offsets_for(np.array(["s2", "s0"], dtype=object), "query"))


def test_port_pool_closes_jax_properties(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")
    port = port_mm.SequencePool({"a": "ACGT"})
    for name in ("pool", "packed", "packed2"):
        with pytest.raises(AttributeError):
            getattr(port, name)
