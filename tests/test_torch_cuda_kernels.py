"""The port's CUDA kernels against their plain PyTorch versions on a GPU, at
small shapes and at the edge cases of K1 (chip_smoke.k1_edge_cases, also
held against the C loop on the CPU by tests/test_torch_compare.py), K4
(chip_smoke.k4_edge_cases), K5 (chip_smoke.k5_edge_cases, at two tiles,
and in several batches of rows with its counts carried between them)
and K6 (chip_smoke.k6_edge_cases, at two counts of recent candidates); K4,
K5 and K6 also against the C passes, K7 with its tables cut into seq
ranges, a
whole chaining on the card against the same on the CPU, the device check
of the kernel library, run_pipeline's worker threads on streams of their
own against its serial run, its spans and the counters of its waits and
copies under a profiler, the pool's pinned host bytes uploaded in place,
and, on a machine with two cards or more, the
mesh path with slots on two cards against one card.

Needs a CUDA device and nvcc; skips without a device.  This file imports no
JAX and nothing of paffy_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import pathlib
import sys
import threading

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
    assert kernels.LAUNCHES["run_fill_cigar"] == (
        before["run_fill_cigar"] + (n_runs > 0))


@pytest.mark.parametrize("label", chip_smoke.K4_EDGE_LABELS)
def test_run_kernels_edge_cases(cuda, label):
    c = chip_smoke.k4_edge_cases()[label]
    *_, n_runs, err = chip_smoke.k4_check(
        torch, devconf, native, runs, mismatch_device, c["pool"], c["lens"],
        c["qpos0"], c["tpos0"], c["rev"], c.get("ops"), c.get("op_lens"))
    assert err == 0 and n_runs >= np.count_nonzero(c["lens"])
    if label in chip_smoke.K4_EDGE_LABELS[:4]:  # flips inside the runs
        assert n_runs > len(c["lens"])


def test_encode_mismatches_launches_each_k4_kernel_once(cuda, monkeypatch):
    c = chip_smoke.k4_edge_cases()[chip_smoke.K4_EDGE_LABELS[5]]
    tab = parse_paf_text(chip_smoke.k4_paf(c))
    index = {"s": (0, len(c["pool"]))}
    monkeypatch.delenv("PAFFY_TPU_PLATFORM", raising=False)
    before = dict(kernels.LAUNCHES)
    gpu = port_mm.encode_mismatches(
        tab, port_mm.SequencePool.from_arrays(c["pool"], index))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["run_counts"] == before["run_counts"] + 1
    assert kernels.LAUNCHES["run_fill_cigar"] == before["run_fill_cigar"] + 1
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")
    cpu = port_mm.encode_mismatches(
        tab, port_mm.SequencePool.from_arrays(c["pool"], index))
    for name in ("ops", "lens", "off"):
        np.testing.assert_array_equal(getattr(gpu, name), getattr(cpu, name))


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


@pytest.mark.parametrize("tile", [64, tile_device.TILE])
@pytest.mark.parametrize("n_seqs,n_records,max_iv,cap", [
    (1, 40, 30, tile_device.SATURATION), (3, 120, 2500, tile_device.SATURATION),
    (2, 60, 5, 3), (1, 1, 0, tile_device.SATURATION)],
    ids=["one-seq", "many-intervals", "saturating", "empty"])
def test_tile_kernel_matches_plain_and_c(cuda, n_seqs, n_records, max_iv,
                                         cap, tile):
    rng = np.random.default_rng(n_records + max_iv)
    *args, total = tile_case(rng, n_seqs, n_records, 20_000, max_iv)
    before = kernels.LAUNCHES["tile_sweep"]
    _, got, err = chip_smoke.k5_check(torch, devconf, native, tile_device,
                                      args, cap, tile)
    torch.cuda.synchronize()
    assert err == 0 and kernels.LAUNCHES["tile_sweep"] == before + 1
    np.testing.assert_array_equal(got, tile_device.tile_sweep_tiled_plain(
        *(torch.from_numpy(a) for a in args), cap, tile).numpy())


@pytest.mark.parametrize("tile", [chip_smoke.K5_EDGE_TILE, tile_device.TILE])
@pytest.mark.parametrize("label", chip_smoke.K5_EDGE_LABELS)
def test_tile_kernel_edge_cases(cuda, label, tile):
    *host, cap, _ = chip_smoke.k5_edge_cases()[label]
    *_, err = chip_smoke.k5_check(torch, devconf, native, tile_device, host,
                                  cap, tile)
    assert err == 0


@pytest.mark.parametrize("tile", [64, tile_device.TILE])
def test_tile_kernel_carries_counts_between_batches(cuda, tile):
    # 40 records over the same 3,000 bases of one sequence, many intervals
    # each: every tile's counts cross every batch
    rng = np.random.default_rng(tile)
    *args, total = tile_case(rng, 1, 40, 3_000, 200)
    batches, budget, err = chip_smoke.k5_batched_check(
        torch, devconf, native, kernels, tile_device, args,
        tile_device.SATURATION, tile)
    torch.cuda.synchronize()
    assert err == 0 and batches >= 3 and budget < tile_device.HIST_BUDGET
    got = tile_device.tile_sweep(*(devconf.upload(a, cuda) for a in args),
                                 tile=tile)
    np.testing.assert_array_equal(devconf.to_host_i64(got), tile_device.
                                  tile_sweep_tiled_plain(*(torch.from_numpy(a)
                                                           for a in args),
                                                         tile=tile).numpy())


def test_run_and_tile_wrappers_refuse_bad_inputs(cuda):
    ext = torch.zeros(64, dtype=torch.uint8, device=cuda)
    table = torch.zeros((5, 1), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        runs.run_counts(ext, table.cpu())
    with pytest.raises(ValueError):
        runs.run_counts(ext, table.to(torch.int32))
    with pytest.raises(ValueError):
        runs.run_counts(ext[8:40], table)
    ops = torch.zeros(4, dtype=torch.uint8, device=cuda)
    lens = torch.zeros(4, dtype=torch.int64, device=cuda)
    dest = torch.zeros(1, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        runs.run_fill_cigar(ext, table, dest.int(), ops, lens)
    with pytest.raises(ValueError):
        runs.run_fill_cigar(ext, table, dest, ops, lens.cpu())
    with pytest.raises(ValueError):
        runs.run_fill_cigar(ext, table, dest, ops, lens[::2])
    with pytest.raises(ValueError):
        runs.run_fill_cigar(ext, table, dest, ops[::2], lens[::2])
    idx = torch.zeros(1, dtype=torch.int64, device=cuda)
    two = torch.zeros(2, dtype=torch.int64, device=cuda)
    arena = torch.zeros(8, dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        tile_device.tile_sweep(idx, idx, two.cpu(), idx, idx)
    with pytest.raises(ValueError):
        tile_device.tile_sweep(idx, idx, two, idx, idx.int())
    with pytest.raises(ValueError):
        tile_device.tile_sweep(idx.int(), idx, two, idx, idx)
    with pytest.raises(ValueError):
        tile_device.tile_sweep(idx, idx, two, idx, idx, cap=0)
    with pytest.raises(ValueError):
        tile_device.tile_sweep(idx, idx, two, idx, idx,
                               tile=tile_device.MAX_TILE + 1)
    with pytest.raises(ValueError, match="distinct records"):
        tile_device.tile_sweep(idx + 1, idx, two, idx, idx)


@pytest.mark.parametrize("k", [2, chain_device.K6_RECENT])
@pytest.mark.parametrize("label", chip_smoke.K6_EDGE_LABELS)
def test_chain_kernel_edge_cases(cuda, label, k):
    groups, costs = chip_smoke.k6_edge_cases()[label]
    before = kernels.LAUNCHES["chain_dp"]
    *_, err = chip_smoke.k6_check(devconf, native, chain, chain_device,
                                  groups, costs, k=k)
    torch.cuda.synchronize()
    assert err == 0 and kernels.LAUNCHES["chain_dp"] == before + 1


@pytest.mark.parametrize("threads", [64, 512])
@pytest.mark.parametrize("k", [1, chain_device.K6_MAX_RECENT])
def test_chain_kernel_block_and_recent_bounds(cuda, k, threads):
    # one helper warp, and 15; a single recent candidate, and the most
    groups, costs = chip_smoke.k6_edge_cases(scale=0.3)[
        "many groups and a large one"]
    args = [torch.from_numpy(a).to(cuda)
            for a in chain.dp_arguments(groups, costs[2])]
    got = chain_device.chain_dp_groups(*args, *costs, k=k, threads=threads)
    want = chain_device.chain_dp_groups_plain(*args, *costs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_chain_on_cuda_equals_cpu(cuda, monkeypatch, tmp_path):
    # the whole chaining of a small chip_smoke synthesis, shattered
    _, _, w = chip_smoke.build_files(str(tmp_path), native, seq_len=400_000,
                                     n_records=12, m_columns=300_000)
    tab = parse_paf_text(chip_smoke.chain_input(w, seq_len=400_000).decode())
    monkeypatch.delenv("PAFFY_TPU_PLATFORM", raising=False)
    before = kernels.LAUNCHES["chain_dp"]
    gpu, gpu_perm = chain.paf_chain_order(tab)
    assert kernels.LAUNCHES["chain_dp"] == before + 1     # both strand sets
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
    with pytest.raises(ValueError):
        chain_device.chain_dp_groups(*args, *costs, k=0)
    with pytest.raises(ValueError):
        chain_device.chain_dp_groups(*args, *costs, threads=32)


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


def test_threaded_run_pipeline_on_worker_streams(cuda, monkeypatch,
                                                 tmp_path):
    """run_pipeline on chip_smoke's genome in 4 worker threads equals its
    serial run on the card; each worker runs its groups on one stream of
    its own, none the default stream, and every kernel but K2 (the
    caller's, once) launches on a worker stream."""
    monkeypatch.delenv("PAFFY_TPU_PLATFORM", raising=False)
    fa, paf, lens, _ = chip_smoke.build_genome(
        str(tmp_path), native, n_contigs=8, seq_len=400_000, n_records=12,
        m_columns=300_000)
    t = parse_paf_text(pathlib.Path(paf).read_text())
    outs, seen, used = [], [], []
    stage, stream_of = runner.sharded_pipeline_stage, kernels.stream_of

    def spy(*args):
        seen.append((threading.get_ident(), torch.cuda.current_stream()))
        return stage(*args)

    def spy_stream(x):
        used.append(stream_of(x))
        return used[-1]
    for n_workers in (1, 4):
        monkeypatch.setenv("PAFFY_TPU_PIPELINE_THREADS", str(n_workers))
        if n_workers > 1:
            monkeypatch.setattr(runner, "sharded_pipeline_stage", spy)
            monkeypatch.setattr(kernels, "stream_of", spy_stream)
        kernels.reset_launch_counts()
        outs.append(bytes(serialize_paf_bytes(runner.run_pipeline(
            t, port_mm.SequencePool.from_fasta_files([fa])))))
        counts = dict(kernels.LAUNCHES)
        assert counts["build_ext"] == 1
        for k in ("run_counts", "run_fill_cigar", "chain_dp", "tile_sweep"):
            assert counts[k] == len(lens)
    assert outs[0] == outs[1]
    default = torch.cuda.default_stream(cuda)
    streams = {}
    for tid, s in seen:
        streams.setdefault(tid, set()).add(s.cuda_stream)
    assert 1 < len(streams) <= 4
    assert all(len(s) == 1 for s in streams.values())
    worker = {h for s in streams.values() for h in s}
    assert len(worker) == len(streams) and default.cuda_stream not in worker
    # K2 on the caller's stream, the other 4 kernels per group on workers'
    assert used.count(default.cuda_stream) == 1
    assert set(used) - {default.cuda_stream} == worker


def test_run_pipeline_spans_count_the_card(cuda, monkeypatch, tmp_path):
    """Under a torch.profiler run, run_pipeline on the card at 4 workers
    records each worker's spans under its group's span, which lies under
    run_pipeline; the pool's upload counts the pool's bytes and its
    synchronize as a wait; each group's K5 plan and K6 readbacks count
    waits and bytes down; the seconds of the phase spans equal SECONDS."""
    from torch.profiler import ProfilerActivity, profile

    from paffy_tpu_torch import phases
    monkeypatch.delenv("PAFFY_TPU_PLATFORM", raising=False)
    monkeypatch.setenv("PAFFY_TPU_PIPELINE_THREADS", "4")
    fa, paf, lens, _ = chip_smoke.build_genome(
        str(tmp_path), native, n_contigs=8, seq_len=400_000, n_records=12,
        m_columns=300_000)
    t = parse_paf_text(pathlib.Path(paf).read_text())
    pool = port_mm.SequencePool.from_fasta_files([fa])
    want = bytes(serialize_paf_bytes(runner.run_pipeline(t, pool)))
    pool = port_mm.SequencePool.from_fasta_files([fa])
    phases.SPANS.clear()
    phases.reset()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        got = bytes(serialize_paf_bytes(runner.run_pipeline(t, pool)))
    finally:
        prof.stop()
    spans, seconds = list(phases.SPANS), dict(phases.SECONDS)
    phases.SPANS.clear()
    assert got == want

    def up(s, name):
        while s is not None and s.name != name:
            s = s.parent
        return s
    top, = [s for s in spans if s.name == "run_pipeline"]
    groups = [s for s in spans if s.name == "group"]
    assert len(groups) == len(lens)
    assert all(up(g, "run_pipeline") is top for g in groups)
    sums, per = {}, {}
    for s in spans:
        if s.parent is not None:
            assert s.parent.start <= s.start and s.end <= s.parent.end
        if s.phase:
            sums[s.name] = sums.get(s.name, 0.0) + s.end - s.start
        if s.name in ("K5 tiles", "K6", "K4 count"):
            g = up(s, "group")
            assert g is not None and g.thread == s.thread
            c = per.setdefault((g.ids["group"], s.name), {})
            for k, v in s.counts.items():
                c[k] = c.get(k, 0) + v
    assert len(per) == 3 * len(lens)
    for c in per.values():
        assert c["waits"] >= 1 and c["wait_s"] > 0 and c["bytes_down"] > 0
    assert sums.keys() == seconds.keys()
    assert all(sums[k] == pytest.approx(v, rel=1e-9)
               for k, v in seconds.items())
    assert len({g.thread for g in groups} - {top.thread}) == 4
    pu, = [s for s in spans if s.name == "pool upload"]
    assert pu.counts["bytes_up"] == pool.pool_len
    assert pu.counts["waits"] == 1 and up(pu, "group") is None
    assert sum(s.counts.get("waits", 0) for s in spans
               if s.name == "K5 tiles") >= 2 * len(lens)


def test_pool_is_pinned_and_uploads_in_place(cuda, monkeypatch, tmp_path):
    """On the card the pool's host bytes are a pinned block: the traced
    upload counts pool_direct 1 and the pool's bytes, and ext equals that
    of a pool made by from_arrays over the same bytes."""
    from torch.profiler import ProfilerActivity, profile

    from paffy_tpu_torch import phases
    monkeypatch.delenv("PAFFY_TPU_PLATFORM", raising=False)
    fa, _, _ = chip_smoke.build_files(str(tmp_path), native,
                                      seq_len=400_000, n_records=12,
                                      m_columns=300_000)
    pool = port_mm.SequencePool.from_fasta_files([fa])
    assert torch.from_numpy(pool.host_pool).is_pinned()
    phases.SPANS.clear()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        ext = pool.ext
    finally:
        prof.stop()
    pu, = [s for s in phases.SPANS if s.name == "pool upload"]
    phases.SPANS.clear()
    assert pu.counts["pool_direct"] == 1
    assert pu.counts["bytes_up"] == pool.pool_len
    g = pool._guard
    other = port_mm.SequencePool.from_arrays(
        pool.host_pool[g: g + pool._data_len].copy(), pool.index)
    assert torch.equal(ext, other.ext)
