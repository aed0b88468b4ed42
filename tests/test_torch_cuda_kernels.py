"""The port's CUDA kernels against their plain PyTorch versions on a GPU, at
small shapes and at K1's edge cases (chip_smoke.k1_edge_cases, also held
against the C loop on the CPU by tests/test_torch_compare.py).

Needs a CUDA device and nvcc; skips without a device.  This file imports no
JAX and nothing of paffy_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from paffy_tpu_torch import kernels, native  # noqa: E402
from paffy_tpu_torch.core.pafio import parse_paf_text  # noqa: E402
from paffy_tpu_torch.ops import compare  # noqa: E402
from paffy_tpu_torch.ops import mismatch as port_mm  # noqa: E402
from paffy_tpu_torch.ops.mismatch_device import (build_ext_pool,  # noqa: E402
                                                 build_ext_pool_plain)

pytestmark = pytest.mark.needs_cuda
P = compare.PIECE_COLS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [1, 7, 256, 257, (1 << 20) + 3])
def test_ext_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    pool = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(cuda)
    pool[: min(n, 256)] = torch.arange(min(n, 256), dtype=torch.uint8)
    before = kernels.LAUNCHES["build_ext"]
    got = build_ext_pool(pool)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["build_ext"] == before + 1
    assert torch.equal(got, build_ext_pool_plain(pool))
    assert torch.equal(got.cpu(), build_ext_pool_plain(pool.cpu()))


def random_table(rng, lens, L, n_records):
    k = len(lens)
    rev = rng.random(k) < 0.5
    qpos0 = np.where(rev, rng.integers(lens.max(), L, k),
                     rng.integers(0, L - lens.max(), k))
    tpos0 = rng.integers(0, L - lens.max(), k)
    rec = np.sort(rng.integers(0, n_records, k))
    return compare.build_piece_table(lens, qpos0, tpos0, rev, rec, L,
                                     n_records)


@pytest.mark.parametrize("lens", [
    [1], [15], [16], [17], [511], [512], [513], [P - 1], [P], [P + 1],
    [2 * P + 1], [1, P - 1, P, P + 1, 0, 5], list(range(0, 3 * P, 97))],
    ids=lambda v: f"{len(v)}runs-max{max(v)}")
def test_piece_kernel_matches_plain(cuda, lens):
    rng = np.random.default_rng(len(lens) + max(lens))
    L = 50_000
    pool = torch.from_numpy(np.frombuffer(b"ACGTacgtN", dtype=np.uint8)[
        rng.integers(0, 9, L)].copy()).to(cuda)
    ext = build_ext_pool(pool)
    n_records = 7        # some records get no piece: their count stays 0
    table = torch.from_numpy(random_table(
        rng, np.array(lens, dtype=np.int64), L, n_records)).to(cuda)
    before = kernels.LAUNCHES["piece_compare"]
    got = compare.piece_match_counts(ext, table, n_records)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["piece_compare"] == before + (table.shape[1] > 0)
    assert torch.equal(got, compare.piece_match_counts_plain(ext, table,
                                                             n_records))
    assert torch.equal(got.cpu(), compare.piece_match_counts(
        ext.cpu(), table.cpu(), n_records))


@pytest.mark.parametrize("label", chip_smoke.K1_EDGE_LABELS)
def test_piece_kernel_edge_cases(cuda, label):
    c = chip_smoke.k1_edge_cases()[label]
    table = torch.from_numpy(compare.build_piece_table(
        c["lens"], c["qpos0"], c["tpos0"], c["rev"], c["rec"],
        len(c["pool"]), c["n_records"])).to(cuda)
    ext = build_ext_pool(torch.from_numpy(c["pool"]).to(cuda))
    got = compare.piece_match_counts(ext, table, c["n_records"])
    assert torch.equal(got, compare.piece_match_counts_plain(
        ext, table, c["n_records"]))
    m, _ = native.column_compare_counts(
        c["pool"], c["lens"], c["qpos0"], c["tpos0"], c["rev"], c["rec"],
        c["n_records"])
    np.testing.assert_array_equal(got.cpu().numpy(), m)


def test_piece_kernel_many_blocks_one_record(cuda):
    # one record spread over many warps and blocks: the per-warp atomics
    # must sum up
    rng = np.random.default_rng(1)
    L = 1 << 24
    pool = torch.from_numpy(rng.integers(0, 4, L, dtype=np.uint8)).to(cuda)
    ext = build_ext_pool(pool)
    lens = np.full(3, L // 4, dtype=np.int64)
    table = torch.from_numpy(compare.build_piece_table(
        lens, [0, L - 1, 7], [5, 9, L // 2], [False, True, False],
        [0, 0, 0], L, 1)).to(cuda)
    assert table.shape[1] > 32 * 8 * 4
    assert torch.equal(compare.piece_match_counts(ext, table, 1),
                       compare.piece_match_counts_plain(ext, table, 1))


def test_column_counts_cuda_equal_cpu(cuda, monkeypatch):
    rng = np.random.default_rng(3)
    n = 6 * P
    q = np.frombuffer(b"ACGTNMKRYVBHDWS", dtype=np.uint8)[
        rng.integers(0, 15, n)].copy()
    t = q.copy()
    t[rng.random(n) < 0.2] = ord("A")
    q[rng.random(n) < 0.3] |= 0x20
    seqs = {"q": q.tobytes().decode(), "t": t.tobytes().decode()}
    lines = []
    for ln in (1, 15, 16, 17, P - 1, P, P + 1, 2 * P + 1):
        for strand in "+-":
            lines.append(f"q\t{n}\t3\t{3 + ln + 9}\t{strand}\tt\t{n}\t1\t"
                         f"{1 + ln + 8}\t{ln}\t{ln}\t60\tcg:Z:3M2I{ln}M1D4M")
    lines.append(f"q\t{n}\t0\t10\t+\tt\t{n}\t0\t10\t10\t10\t60")
    lines.append(f"q\t{n}\t0\t5\t+\tt\t{n}\t7\t7\t0\t5\t60\tcg:Z:5I")
    tab = parse_paf_text("\n".join(lines) + "\n")
    monkeypatch.delenv("PAFFY_TPU_PLATFORM", raising=False)
    gpu = port_mm.column_match_counts(tab, port_mm.SequencePool(seqs))
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")
    cpu = port_mm.column_match_counts(tab, port_mm.SequencePool(seqs))
    np.testing.assert_array_equal(gpu[0], cpu[0])
    np.testing.assert_array_equal(gpu[1], cpu[1])


def test_wrappers_reject_mixed_devices_and_types(cuda):
    ext = torch.zeros(16, dtype=torch.uint8, device=cuda)
    table = torch.zeros((4, 1), dtype=torch.int64)
    with pytest.raises(ValueError):
        compare.piece_match_counts(ext, table, 1)
    with pytest.raises(ValueError):
        compare.piece_match_counts(ext, table.to(cuda, torch.int32), 1)
    with pytest.raises(ValueError):
        compare.piece_match_counts(torch.zeros(40, dtype=torch.uint8,
                                               device=cuda)[8:],
                                   table.to(cuda), 1)
    with pytest.raises(ValueError):
        build_ext_pool(ext.to(torch.int16))
