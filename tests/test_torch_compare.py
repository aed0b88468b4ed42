"""K1 (the piece compare) and the per-record counts of paffy_tpu_torch against
paffy_tpu on the CPU: the interpret-mode Pallas kernel, the JAX tiled kernels
(TILED_THRESHOLD=1, FORCE_DEVICE) and the native C loop.

Inputs are made from a seed with numpy and handed to both packages; the
port runs its plain PyTorch versions (PAFFY_TPU_PLATFORM=cpu).  Counts are
integers: exact equality everywhere."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from paffy_tpu import native
from paffy_tpu.core.pafio import parse_paf_text
from paffy_tpu.ops import mismatch as ref_mm
from paffy_tpu.ops.segments import build_m_column_batch
from paffy_tpu_torch import kernels
from paffy_tpu_torch.ops import compare
from paffy_tpu_torch.ops import mismatch as port_mm
from paffy_tpu_torch.ops import mismatch_device as port_md
from synthdata import make_workload

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

P = compare.PIECE_COLS
IUPAC = b"ACGTNMKRYVBHDWS"


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


def mutate(seqs, seed, alphabet, lower):
    """Re-draw ~10% of each sequence's bytes from ``alphabet`` ("any" for
    every byte value) and lowercase ~30% of the bytes when ``lower``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in seqs.items():
        a = np.frombuffer(s.encode("latin-1"), dtype=np.uint8).copy()
        hit = rng.random(len(a)) < 0.1
        if alphabet == "any":
            a[hit] = rng.integers(0, 256, int(hit.sum()), dtype=np.uint8)
        else:
            letters = np.frombuffer(alphabet, dtype=np.uint8)
            a[hit] = letters[rng.integers(0, len(letters), int(hit.sum()))]
        if lower:
            a[rng.random(len(a)) < 0.3] |= 0x20
        out[name] = a.tobytes().decode("latin-1")
    return out


def batch_of(t, pool):
    return build_m_column_batch(t, pool.offsets_for(t.qname, "query"),
                                pool.offsets_for(t.tname, "target"))


def native_counts(t, pool):
    b = batch_of(t, pool)
    k = b.n_mops
    return native.column_compare_counts(
        pool.host_pool, b.lens[:k], b.qpos0[:k], b.tpos0[:k], b.rev[:k],
        b.rec[:k], len(t))


def jax_tiled_counts(t, pool):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_mm, "TILED_THRESHOLD", 1)
        mp.setattr(ref_mm, "FORCE_DEVICE", True)
        return ref_mm.column_match_counts(t, pool)


def port_pool(ref_pool):
    """The port's pool over the bytes and index of a paffy_tpu pool."""
    g = ref_pool._guard
    return port_mm.SequencePool.from_arrays(
        ref_pool.host_pool[g: g + ref_pool._data_len], ref_pool.index)


def port_counts(t, ref_pool):
    return port_mm.column_match_counts(t, port_pool(ref_pool))


def assert_counts_equal(a, b):
    assert a[0].dtype == np.int64 and a[1].dtype == np.int64
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_counts_match_pallas_interpret():
    # the workload of tests/test_mismatch.py::test_pallas_piece_kernel_interpret
    from paffy_tpu.ops.pallas_compare import pallas_match_counts
    seqs, lines = make_workload(seed=31, length=20000, n_windows=30,
                                window=2500, step=600)
    t = parse_paf_text("\n".join(lines) + "\n")
    ref = ref_mm.SequencePool(seqs)
    want = pallas_match_counts(ref.pool, batch_of(t, ref), len(t),
                               interpret=True)
    assert_counts_equal(port_counts(t, ref), want)


WORKLOADS = [(b"ACGT", False), (b"ACGT", True), (IUPAC, False),
             (IUPAC, True), ("any", True)]
WORKLOAD_IDS = ["acgt", "acgt-lower", "iupac15", "iupac15-lower",
                "anybyte-lower"]


@pytest.fixture(params=WORKLOADS, ids=WORKLOAD_IDS)
def workload(request):
    alphabet, lower = request.param
    seqs, lines = make_workload(seed=41, length=9000, n_windows=14,
                                window=1100, step=640)
    t = parse_paf_text("\n".join(lines) + "\n")
    assert (~t.strand).any() and t.strand.any()
    return t, ref_mm.SequencePool(mutate(seqs, 5, alphabet, lower))


def test_counts_match_jax_tiled(workload):
    t, ref = workload
    assert_counts_equal(port_counts(t, ref), jax_tiled_counts(t, ref))


def test_counts_match_native_c_loop(workload):
    t, ref = workload
    assert_counts_equal(port_counts(t, ref), native_counts(t, ref))


def edge_table_and_pool(alphabet):
    """Records whose M runs end on and around piece edges (1, P-1, P, P+1,
    2P+1 columns) on both strands, runs split by indels, an empty record
    (no cigar) and records with no M op."""
    rng = np.random.default_rng(7)
    n = 6 * P
    letters = np.frombuffer(alphabet, dtype=np.uint8)
    q = letters[rng.integers(0, len(letters), n)]
    tt = q.copy()
    flip = rng.random(n) < 0.2
    tt[flip] = letters[rng.integers(0, len(letters), int(flip.sum()))]
    q[rng.random(n) < 0.3] |= 0x20
    seqs = {"q": q.tobytes().decode("latin-1"),
            "t": tt.tobytes().decode("latin-1")}
    lines = []
    for ln in (1, P - 1, P, P + 1, 2 * P + 1):
        for strand in "+-":
            lines.append(f"q\t{n}\t5\t{5 + ln}\t{strand}\tt\t{n}\t9\t{9 + ln}"
                         f"\t{ln}\t{ln}\t60\tcg:Z:{ln}M")
            lines.append(f"q\t{n}\t3\t{3 + ln + 9}\t{strand}\tt\t{n}\t1\t"
                         f"{1 + ln + 8}\t{ln}\t{ln}\t60"
                         f"\tcg:Z:3M2I{ln}M1D4M")
    lines.append(f"q\t{n}\t0\t10\t+\tt\t{n}\t0\t10\t10\t10\t60")
    lines.append(f"q\t{n}\t0\t5\t+\tt\t{n}\t7\t7\t0\t5\t60\tcg:Z:5I")
    lines.append(f"q\t{n}\t4\t4\t-\tt\t{n}\t7\t11\t0\t4\t60\tcg:Z:4D")
    t = parse_paf_text("\n".join(lines) + "\n")
    return t, ref_mm.SequencePool(seqs)


@pytest.mark.parametrize("alphabet", [b"ACGT", IUPAC], ids=["acgt", "iupac15"])
def test_piece_edges_empty_and_m_free_records(alphabet):
    t, ref = edge_table_and_pool(alphabet)
    got = port_counts(t, ref)
    assert_counts_equal(got, native_counts(t, ref))
    assert_counts_equal(got, jax_tiled_counts(t, ref))
    assert got[0][-3:].tolist() == [0, 0, 0] == got[1][-3:].tolist()


def reference_pieces(lens, qpos0, tpos0, rev, rec, L):
    """The piece table on Python integers, one (qsrc, tsrc, n, rec) per
    piece: a run is cut where its target position reaches a PIECE_COLS-byte
    boundary counted from the run's first aligned 16-byte target word."""
    out = []
    for ln, q, t, r, k in zip(lens, qpos0, tpos0, rev, rec):
        ln, q, t = int(ln), int(q), int(t)
        head = t % 16
        cuts = ([0] + [c for c in range(1, ln) if (c + head) % P == 0]
                + [ln] if ln else [])
        for c0, c1 in zip(cuts, cuts[1:]):
            qs = 2 * L - 1 - (q - c0) if r else q + c0
            out.append((qs, t + c0, c1 - c0, int(k)))
    return out


def test_piece_table_int64_offsets_past_2_31():
    # offsets and pool lengths beyond int32: no pool is allocated, the table
    # is held against the same arithmetic on Python integers
    L = 5 * 2**31 + 16 * 1000
    lens = np.array([1, P - 1, P, P + 1, 2 * P + 5, 0], dtype=np.int64)
    qpos0 = np.array([2**31 + 3, 2**32 + 9, L - 1, 2**31 + P + 1,
                      2**33 - 1, 2**31], dtype=np.int64)
    tpos0 = np.array([2**32, 5, 2**31 - 1, L - P - 1, 2**33 + 7, 2**32],
                     dtype=np.int64)
    rev = np.array([False, True, True, False, True, False])
    rec = np.array([0, 0, 1, 2, 2, 3], dtype=np.int64)
    table = compare.build_piece_table(lens, qpos0, tpos0, rev, rec, L, 4)
    want = reference_pieces(lens, qpos0, tpos0, rev, rec, L)
    assert table.dtype == np.int64 and table.shape == (4, len(want))
    assert [tuple(int(v) for v in col) for col in table.T] == want
    assert table[0].max() > 2**33
    # every piece's target bytes lie in the PIECE_COLS bytes from its first
    # aligned word
    t_word = table[1] - table[1] % 16
    assert np.all(table[1] + table[2] <= t_word + P)


@pytest.mark.parametrize("ln", [1, 15, 16, 17, 511, 512, 513, 1100, P - 1,
                                P, P + 1, 9000])
def test_piece_table_cuts_at_every_residue(ln):
    # target and query starts at every residue mod 16, both strands
    L = 1 << 16
    head = np.arange(32) % 16
    tpos0 = 4096 + 16 * np.arange(32) * 40 + head
    rev = np.arange(32) >= 16
    qpos0 = np.where(rev, 30000 + ln + 3 * head, 9000 + 5 * head)
    rec = np.arange(32) // 4
    lens = np.full(32, ln)
    table = compare.build_piece_table(lens, qpos0, tpos0, rev, rec, L, 8)
    assert ([tuple(int(v) for v in col) for col in table.T]
            == reference_pieces(lens, qpos0, tpos0, rev, rec, L))
    # a piece after a run's first starts 16-aligned
    first = np.r_[True, np.diff(np.repeat(np.arange(32), -(-(ln + head)
                                                         // P))) != 0]
    assert np.all(table[1][~first] % 16 == 0)


def residue_table_and_pool(diff_parity):
    """Records of one M run of 1, 15, 16, 17, 511, 512 or 513 columns on
    both strands, whose target starts take every residue mod 16 and whose
    query starts take every residue mod 16, with the query-target offset
    odd (``diff_parity`` 1) or even (0); then an empty record and records
    without an M op."""
    rng = np.random.default_rng(11 + diff_parity)
    n = 1 << 14
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = letters[rng.integers(0, 4, n)]
    tt = q.copy()
    flip = rng.random(n) < 0.2
    tt[flip] = letters[rng.integers(0, 4, int(flip.sum()))]
    q[rng.random(n) < 0.3] |= 0x20
    seqs = {"q": q.tobytes().decode(), "t": tt.tobytes().decode()}
    lines = []
    for ln in (1, 15, 16, 17, 511, 512, 513):
        for strand in "+-":
            for r in range(16):
                ts = 16 * int(rng.integers(0, (n - 600) // 16)) + r
                qs = (16 * int(rng.integers(0, (n - 600) // 16))
                      + (3 * r + 1 - diff_parity) % 16)
                lines.append(f"q\t{n}\t{qs}\t{qs + ln}\t{strand}\tt\t{n}"
                             f"\t{ts}\t{ts + ln}\t{ln}\t{ln}\t60"
                             f"\tcg:Z:{ln}M")
    lines.append(f"q\t{n}\t0\t10\t+\tt\t{n}\t0\t10\t10\t10\t60")
    lines.append(f"q\t{n}\t0\t5\t+\tt\t{n}\t7\t7\t0\t5\t60\tcg:Z:5I")
    lines.append(f"q\t{n}\t4\t4\t-\tt\t{n}\t7\t11\t0\t4\t60\tcg:Z:4D")
    return parse_paf_text("\n".join(lines) + "\n"), ref_mm.SequencePool(seqs)


@pytest.mark.parametrize("diff_parity", [1, 0], ids=["odd-offset",
                                                     "even-offset"])
def test_counts_at_every_residue_match_pallas_tiled_and_c_loop(diff_parity):
    from paffy_tpu.ops.pallas_compare import pallas_match_counts
    t, ref = residue_table_and_pool(diff_parity)
    b = batch_of(t, ref)
    k = b.n_mops
    assert set((b.tpos0[:k] % 16).tolist()) == set(range(16))
    assert set((b.qpos0[:k] % 16).tolist()) == set(range(16))
    got = port_counts(t, ref)
    assert_counts_equal(got, native_counts(t, ref))
    assert_counts_equal(got, jax_tiled_counts(t, ref))
    assert_counts_equal(got, pallas_match_counts(ref.pool, b, len(t),
                                                 interpret=True))
    assert got[0][-3:].tolist() == [0, 0, 0] == got[1][-3:].tolist()


@pytest.mark.parametrize("label", chip_smoke.K1_EDGE_LABELS)
def test_k1_edge_cases_match_c_loop(label):
    # chip_smoke.py's K1 edge cases (every residue mod 16 of target and
    # query starts, reverse runs that read the last byte of ext, records
    # without runs), which it and tests/test_torch_cuda_kernels.py run
    # through the kernel on the card
    c = chip_smoke.k1_edge_cases()[label]
    table = compare.build_piece_table(c["lens"], c["qpos0"], c["tpos0"],
                                      c["rev"], c["rec"], len(c["pool"]),
                                      c["n_records"])
    ext = port_md.build_ext_pool(torch.from_numpy(c["pool"]))
    got = compare.piece_match_counts(ext, torch.from_numpy(table),
                                     c["n_records"])
    m, _ = native.column_compare_counts(c["pool"], c["lens"], c["qpos0"],
                                        c["tpos0"], c["rev"], c["rec"],
                                        c["n_records"])
    np.testing.assert_array_equal(got.numpy(), m)
    if label == "both ends of ext":
        assert (table[0] + table[2]).max() == 2 * len(c["pool"])
        assert (table[1] + table[2]).max() == len(c["pool"])
    else:
        assert set((c["tpos0"] % 16).tolist()) == set(range(16))
        assert (c["n_records"] - len(np.unique(c["rec"]))) > 2


def test_piece_wrapper_rejects_unaligned_ext_length():
    table = torch.from_numpy(compare.build_piece_table(
        [4], [0], [0], [False], [0], 8, 1))
    with pytest.raises(ValueError, match="multiple of 16"):
        compare.piece_match_counts(torch.zeros(24, dtype=torch.uint8),
                                   table, 1)


@pytest.mark.parametrize("field,value", [("qpos0", -1), ("tpos0", 10**6),
                                         ("rev", True), ("rec", 5)])
def test_piece_table_rejects_reads_outside_the_pool(field, value):
    args = dict(lens=np.array([10]), qpos0=np.array([0]),
                tpos0=np.array([0]), rev=np.array([False]),
                rec=np.array([0]))
    args[field] = np.array([value])
    with pytest.raises(ValueError):
        compare.build_piece_table(**args, pool_len=1000, n_records=2)


def test_piece_wrapper_on_cpu_runs_plain_without_launching():
    rng = np.random.default_rng(2)
    ext = torch.from_numpy(rng.integers(0, 4, 10_000, dtype=np.uint8))
    lens = rng.integers(0, 3 * compare.WINDOW, 40)
    table = compare.build_piece_table(
        lens, rng.integers(0, 1000, 40), rng.integers(0, 1000, 40),
        np.zeros(40, dtype=bool), np.sort(rng.integers(0, 9, 40)), 5000, 9)
    tt = torch.from_numpy(table)
    before = dict(kernels.LAUNCHES)
    got = compare.piece_match_counts(ext, tt, 9)
    assert kernels.LAUNCHES == before
    e = ext.numpy()
    want = np.zeros(9, dtype=np.int64)
    for qs, ts, n, r in table.T:
        want[r] += int(np.sum(e[qs: qs + n] == e[ts: ts + n]))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        compare.piece_match_counts(ext, tt.to(torch.int32), 9)
