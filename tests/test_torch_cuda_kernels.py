"""The port's CUDA kernels against their plain PyTorch versions on a GPU, at
small shapes and at the edge cases of K1 (chip_smoke.k1_edge_cases, also
held against the C loop on the CPU by tests/test_torch_compare.py), K4
(chip_smoke.k4_edge_cases) and K6 (chip_smoke.k6_edge_cases); K4, K5 and
K6 also against the C passes, K7 with its tables cut into seq ranges, a
whole chaining on the card against the same on the CPU, the device check
of the kernel library, and, on a machine with two cards or more, the mesh
path with slots on two cards against one card.

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
from paffy_tpu_torch import devconf, kernels, native  # noqa: E402
from paffy_tpu_torch.core.pafio import (parse_paf_text,  # noqa: E402
                                        serialize_paf_bytes)
from paffy_tpu_torch.ops import compare, mismatch_device  # noqa: E402
from paffy_tpu_torch.ops import chain, chain_device  # noqa: E402
from paffy_tpu_torch.ops import group_stats  # noqa: E402
from paffy_tpu_torch.ops import runs, tile_device  # noqa: E402
from paffy_tpu_torch.ops import mismatch as port_mm  # noqa: E402
from paffy_tpu_torch.ops.mismatch_device import (build_ext_pool,  # noqa: E402
                                                 build_ext_pool_plain)
from paffy_tpu_torch.parallel import pipeline, runner  # noqa: E402

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


def random_runs(rng, lens, L):
    """M runs of the lengths given over a pool of length L, on both
    strands: (lens, qpos0, tpos0, rev)."""
    lens = np.asarray(lens, dtype=np.int64)
    k = len(lens)
    top = int(lens.max(initial=0))
    rev = rng.random(k) < 0.5
    qpos0 = np.where(rev, rng.integers(top, L, k),
                     rng.integers(0, L - top, k))
    tpos0 = rng.integers(0, L - top, k)
    return lens, qpos0, tpos0, rev


@pytest.mark.parametrize("lens", [
    [1], [15], [16], [17], [511], [512], [513], [P - 1], [P], [P + 1],
    [2 * P + 1], [1, P - 1, P, P + 1, 0, 5], list(range(0, 3 * P, 97))],
    ids=lambda v: f"{len(v)}runs-max{max(v)}")
def test_run_kernels_match_plain_and_c(cuda, lens):
    rng = np.random.default_rng(len(lens) + max(lens) + 1)
    L = 50_000
    pool = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)[
        rng.integers(0, 9, L)].copy()
    before = dict(kernels.LAUNCHES)
    *_, n_runs, err = chip_smoke.k4_check(
        torch, devconf, native, runs, mismatch_device, pool,
        *random_runs(rng, lens, L))
    torch.cuda.synchronize()
    assert err == 0 and n_runs >= sum(1 for n in lens if n)
    assert kernels.LAUNCHES["run_counts"] == before["run_counts"] + 1
    assert kernels.LAUNCHES["run_fill"] == before["run_fill"] + (n_runs > 0)


@pytest.mark.parametrize("label", chip_smoke.K4_EDGE_LABELS)
def test_run_kernels_edge_cases(cuda, label):
    c = chip_smoke.k4_edge_cases()[label]
    *_, n_runs, err = chip_smoke.k4_check(
        torch, devconf, native, runs, mismatch_device, c["pool"], c["lens"],
        c["qpos0"], c["tpos0"], c["rev"])
    assert err == 0 and n_runs > len(c["lens"])


def tile_case(rng, n_seqs, n_records, seq_len, max_iv):
    """A random tile sweep input: records on n_seqs query sequences, each
    with up to max_iv disjoint sorted intervals; (order, arena_off,
    run_off, istart, iend, total)."""
    seq = rng.integers(0, n_seqs, n_records)
    arena_off = seq * seq_len
    n_iv = rng.integers(0, max_iv + 1, n_records)
    istart, iend = [], []
    for i in range(n_records):
        cuts = np.sort(rng.choice(seq_len, 2 * n_iv[i], replace=False))
        istart.append(cuts[0::2])
        iend.append(cuts[1::2])
    run_off = np.concatenate([[0], np.cumsum(n_iv)]).astype(np.int64)
    order = rng.permutation(n_records).astype(np.int64)
    return (order, arena_off.astype(np.int64), run_off,
            np.concatenate(istart).astype(np.int64),
            np.concatenate(iend).astype(np.int64), n_seqs * seq_len)


@pytest.mark.parametrize("n_seqs,n_records,max_iv,cap", [
    (1, 40, 30, tile_device.SATURATION), (3, 120, 2500, tile_device.SATURATION),
    (2, 60, 5, 3), (1, 1, 0, tile_device.SATURATION)],
    ids=["one-seq", "many-intervals", "saturating", "empty"])
def test_tile_kernel_matches_plain_and_c(cuda, n_seqs, n_records, max_iv,
                                         cap):
    rng = np.random.default_rng(n_records + max_iv)
    *args, total = tile_case(rng, n_seqs, n_records, 20_000, max_iv)
    dargs = [torch.from_numpy(a).to(cuda) for a in args]
    arena = torch.zeros(total, dtype=torch.int16, device=cuda)
    before = kernels.LAUNCHES["tile_sweep"]
    got = tile_device.tile_sweep(*dargs, arena, cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tile_sweep"] == before + 1
    arena_p = torch.zeros_like(arena)
    assert torch.equal(got, tile_device.tile_sweep_plain(*dargs, arena_p,
                                                         cap))
    assert torch.equal(arena, arena_p)
    arena_c = np.zeros(total, dtype=np.uint16)
    levels_c = np.full(n_records, 32767, dtype=np.int64)
    native.tile_sweep(*args, arena_c, cap, levels_c)
    np.testing.assert_array_equal(got.cpu().numpy(), levels_c)
    np.testing.assert_array_equal(arena.cpu().numpy().view(np.uint16),
                                  arena_c)


def test_run_and_tile_wrappers_refuse_bad_inputs(cuda):
    ext = torch.zeros(64, dtype=torch.uint8, device=cuda)
    table = torch.zeros((5, 1), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        runs.run_counts(ext, table.cpu())
    with pytest.raises(ValueError):
        runs.run_counts(ext, table.to(torch.int32))
    with pytest.raises(ValueError):
        runs.run_counts(ext[8:40], table)
    with pytest.raises(ValueError):
        runs.run_fill(ext, table, torch.zeros(1, dtype=torch.int32,
                                              device=cuda), 1)
    idx = torch.zeros(1, dtype=torch.int64, device=cuda)
    two = torch.zeros(2, dtype=torch.int64, device=cuda)
    arena = torch.zeros(8, dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        tile_device.tile_sweep(idx, idx, two, idx, idx, arena.cpu())
    with pytest.raises(ValueError):
        tile_device.tile_sweep(idx, idx, two, idx, idx, arena.to(torch.int32))
    with pytest.raises(ValueError):
        tile_device.tile_sweep(idx.int(), idx, two, idx, idx, arena)
    with pytest.raises(ValueError):
        tile_device.tile_sweep(idx, idx, two, idx, idx, arena, cap=0)


@pytest.mark.parametrize("label", chip_smoke.K6_EDGE_LABELS)
def test_chain_kernel_edge_cases(cuda, label):
    groups, costs = chip_smoke.k6_edge_cases()[label]
    before = kernels.LAUNCHES["chain_dp"]
    *_, err = chip_smoke.k6_check(devconf, native, chain, chain_device,
                                  groups, costs)
    torch.cuda.synchronize()
    assert err == 0 and kernels.LAUNCHES["chain_dp"] == before + 1


def test_chain_on_cuda_equals_cpu(cuda, monkeypatch, tmp_path):
    # the whole chaining of a small chip_smoke synthesis, shattered
    _, _, w = chip_smoke.build_files(str(tmp_path), native, seq_len=400_000,
                                     n_records=12, m_columns=300_000)
    tab = parse_paf_text(chip_smoke.chain_input(w, seq_len=400_000).decode())
    monkeypatch.delenv("PAFFY_TPU_PLATFORM", raising=False)
    before = kernels.LAUNCHES["chain_dp"]
    gpu, gpu_perm = chain.paf_chain_order(tab)
    assert kernels.LAUNCHES["chain_dp"] == before + 2     # one per strand set
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")
    cpu, cpu_perm = chain.paf_chain_order(tab)
    np.testing.assert_array_equal(gpu_perm, cpu_perm)
    np.testing.assert_array_equal(gpu.chain_id, cpu.chain_id)
    np.testing.assert_array_equal(gpu.chain_score, cpu.chain_score)


def test_chain_wrapper_refuses_bad_inputs(cuda):
    groups, costs = chip_smoke.k6_edge_cases(scale=0.01)["wide windows"]
    args = [torch.from_numpy(a).to(cuda)
            for a in chain.dp_arguments(groups, costs[2])]
    with pytest.raises(ValueError):
        chain_device.chain_dp_groups(args[0].cpu(), *args[1:], *costs)
    with pytest.raises(ValueError):
        chain_device.chain_dp_groups(*args[:4], args[4].int(), *args[5:],
                                     *costs)
    with pytest.raises(ValueError):
        chain_device.chain_dp_groups(*args[:9], args[9][:-1], *costs)


@pytest.mark.parametrize(
    "lens", [[1], [17, 513, P + 1, 5], list(range(1, 3 * P, 97))],
    ids=lambda v: f"{len(v)}runs-max{max(v)}")
def test_group_stats_kernel_matches_plain(cuda, lens):
    rng = np.random.default_rng(len(lens) + 7)
    L = 50_000
    pool = torch.from_numpy(np.frombuffer(b"ACGTacgtN", dtype=np.uint8)[
        rng.integers(0, 9, L)].copy()).to(cuda)
    ext = build_ext_pool(pool)
    n_slots = 7
    table = random_table(rng, np.array(lens, dtype=np.int64), L, n_slots)
    before = kernels.LAUNCHES["group_stats"]
    *got, straddles, err = chip_smoke.k7_check(
        torch, devconf, group_stats, pipeline, ext, table, n_slots)
    torch.cuda.synchronize()
    n_ranges = sum(hi > lo for lo, hi in pipeline.seq_ranges(
        table[2], chip_smoke.K7_SEQ_RANGES))
    assert err == 0 and kernels.LAUNCHES["group_stats"] == before + n_ranges
    m = compare.piece_match_counts_plain(ext, torch.from_numpy(table).to(
        cuda), n_slots).cpu().numpy()
    cols = np.bincount(table[3], weights=table[2],
                       minlength=n_slots).astype(np.int64)
    np.testing.assert_array_equal(got[0], m)
    np.testing.assert_array_equal(got[1], cols)
    assert got[2].tolist() == [m.sum(), cols.sum() - m.sum()]


@pytest.mark.parametrize("label", chip_smoke.K1_EDGE_LABELS)
def test_group_stats_kernel_edge_cases(cuda, label):
    c = chip_smoke.k1_edge_cases()[label]
    table = compare.build_piece_table(
        c["lens"], c["qpos0"], c["tpos0"], c["rev"], c["rec"],
        len(c["pool"]), c["n_records"])
    ext = build_ext_pool(torch.from_numpy(c["pool"]).to(cuda))
    m, cols, totals, _, err = chip_smoke.k7_check(
        torch, devconf, group_stats, pipeline, ext, table, c["n_records"])
    want, x = native.column_compare_counts(
        c["pool"], c["lens"], c["qpos0"], c["tpos0"], c["rev"], c["rec"],
        c["n_records"])
    assert err == 0
    np.testing.assert_array_equal(m, want)
    np.testing.assert_array_equal(cols, want + x)
    assert totals.tolist() == [want.sum(), x.sum()]


def test_group_stats_wrapper_refuses_bad_inputs(cuda):
    ext = torch.zeros(64, dtype=torch.uint8, device=cuda)
    table = torch.zeros((4, 1), dtype=torch.int64, device=cuda)
    outs = [torch.zeros(k, dtype=torch.int64, device=cuda) for k in (2, 2, 2)]
    with pytest.raises(ValueError):
        group_stats.group_stats(ext, table.cpu(), *outs)
    with pytest.raises(ValueError):
        group_stats.group_stats(ext, table, outs[0].cpu(), *outs[1:])
    with pytest.raises(ValueError):
        group_stats.group_stats(ext[8:40], table, *outs)
    with pytest.raises(ValueError):
        group_stats.group_stats(ext, table, outs[0][::2], *outs[1:])


def test_check_device_takes_the_cards_of_this_process(cuda):
    n = torch.cuda.device_count()
    assert kernels.check_device(torch.device("cuda", 0)) == 0
    assert kernels.check_device(torch.device("cuda", n - 1)) == n - 1
    for bad in (torch.device("cuda", n), torch.device("cpu")):
        with pytest.raises(ValueError):
            kernels.check_device(bad)
    # a launch on the last card leaves PyTorch's current device as it was
    before = torch.cuda.current_device()
    build_ext_pool(torch.zeros(64, dtype=torch.uint8,
                               device=torch.device("cuda", n - 1)))
    torch.cuda.synchronize(n - 1)
    assert torch.cuda.current_device() == before


def test_mesh_on_two_cards_equals_one_card(cuda, monkeypatch, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    monkeypatch.delenv("PAFFY_TPU_PLATFORM", raising=False)
    fa, paf, w = chip_smoke.build_files(str(tmp_path), native,
                                        seq_len=400_000, n_records=12,
                                        m_columns=300_000)
    t = parse_paf_text(pathlib.Path(paf).read_text())
    pool = port_mm.SequencePool.from_fasta_files([fa])
    chained = parse_paf_text(chip_smoke.chain_input(
        w, seq_len=400_000).decode())
    results = []
    for slots in ([torch.device("cuda", i % 2) for i in range(8)],
                  [torch.device("cuda", 0)] * 8):
        mesh = pipeline.make_mesh(slots, dp=4, sp=2)
        m, x, totals = pipeline.column_counts_multichip(t, pool, mesh)
        staged = runner.sharded_pipeline_stage(chained, pool, mesh)
        results.append((m.tolist(), x.tolist(), totals.tolist(),
                        bytes(serialize_paf_bytes(staged))))
    assert results[0] == results[1]
    assert pool.ext_on(torch.device("cuda", 1)).device == \
        torch.device("cuda", 1)
    # launches on cuda:1 leave PyTorch's current device as it was
    assert torch.cuda.current_device() == 0
