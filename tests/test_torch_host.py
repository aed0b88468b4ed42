"""The port's own host layer (paffy_tpu_torch.native, core with segsum,
ops.segments, ops.transforms, ops.tailtrim, ops.mismatch's pool,
commands.common) against paffy_tpu's,
on the same seeded inputs: equal arrays, equal bytes.  Also chip_smoke.py's
synthesis at a small scale through both packages' native libraries.

Run as a script, this file prints the digests that chip_smoke.py pins
(chromosome scale, a few minutes and ~3 GB of memory; ``genome`` after
``--pins``: only those of the many-contig genome; ``deep``: only those of
the deep tile input made on it):

    PAFFY_TPU_PLATFORM=cpu python tests/test_torch_host.py --pins [genome|deep]
"""

import dataclasses
import hashlib
import os
import pathlib
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from paffy_tpu import native as ref_native  # noqa: E402
from paffy_tpu.cli import faffy_main as ref_faffy  # noqa: E402
from paffy_tpu.cli import paffy_main as ref_main  # noqa: E402
from paffy_tpu.core import pafio as ref_pafio  # noqa: E402
from paffy_tpu.ops import mismatch as ref_mm  # noqa: E402
from paffy_tpu.ops import segments as ref_segments  # noqa: E402
from paffy_tpu.ops import transforms as ref_transforms  # noqa: E402
from paffy_tpu_torch import native  # noqa: E402
from paffy_tpu_torch.cli import faffy_main as port_faffy  # noqa: E402
from paffy_tpu_torch.cli import paffy_main as port_main  # noqa: E402
from paffy_tpu_torch.core import pafio  # noqa: E402
from paffy_tpu_torch.ops import mismatch as port_mm  # noqa: E402
from paffy_tpu_torch.ops import segments, transforms  # noqa: E402
from ref_native import paffy_tpu_lib, ref_lib  # noqa: E402,F401
from synthdata import make_workload  # noqa: E402

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


def test_ref_lib_loads_after_a_failed_build(monkeypatch):
    # paffy_tpu's sticky flag, as a process whose build lost a race to
    # another's leaves it: get_lib gives up, ref_lib clears it and loads
    monkeypatch.setattr(ref_native, "_failed", True)
    monkeypatch.setattr(ref_native, "_lib", None)
    assert ref_native.get_lib() is None
    lib = ref_lib()
    assert lib is not None and not ref_native._failed
    assert ref_native.get_lib() is lib


def workload_text(seed):
    _, lines = make_workload(seed=seed, length=6000, n_windows=12,
                             window=900, step=400)
    return "\n".join(lines) + "\n"


TAGGED = ("a\t100\t0\t10\t+\tb\t90\t5\t15\t8\t10\t60\ttp:A:S\tAS:i:-4\t"
          "tl:i:2\tcn:i:7\ts1:i:99\tzz:Z:dropped\tcg:Z:3M1I2M1D4M\n"
          "b\t90\t2\t6\t-\ta\t100\t0\t4\t4\t4\t0\tcg:Z:4M\n"
          "c\t9\t0\t9\t+\tc\t9\t0\t9\t9\t9\t255\n"
          "a\t100\t1\t4\t+\tb\t90\t1\t4\t3\t3\t1\tcg:Z:03M\n")
PAF_INPUTS = {
    "workload": (workload_text(3).encode(), {}),
    "tags": (TAGGED.encode(), {}),
    "raw": (workload_text(4).encode(), dict(parse_cigars=False)),
    "raw-validated-noncanon": (TAGGED.encode(),
                               dict(parse_cigars=False, validate_cigars=True)),
}


def assert_tables_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "raw_cg":
            assert (x is None) == (y is None)
            if x is not None:
                assert x[0] == y[0]
                np.testing.assert_array_equal(x[1], y[1])
                np.testing.assert_array_equal(x[2], y[2])
            continue
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("name", list(PAF_INPUTS))
def test_paf_table_fields_after_parse(name):
    data, kw = PAF_INPUTS[name]
    assert_tables_equal(pafio.parse_paf_data(data, **kw),
                        ref_pafio.parse_paf_data(data, **kw))


@pytest.mark.parametrize("bad", [
    "q\t10\t0\t5\t*\tt\t10\t0\t5\t5\t5\t60\n",
    "q\t10\t0\t5\t+\tt\t10\t0\t5\t5\t5\t60\tcg:Z:5Q\n",
    "q\t10\t0\t5\t+\tt\t10\n",
], ids=["strand", "cigar", "fields"])
def test_parse_errors_carry_the_same_line(bad):
    data = (workload_text(5) + bad).encode()
    with pytest.raises(ValueError) as want:
        ref_pafio.parse_paf_data(data)
    with pytest.raises(pafio.PafFormatError) as got:
        pafio.parse_paf_data(data)
    assert got.value.line_no == want.value.line_no


def test_native_build_failure_raises(monkeypatch, tmp_path):
    # no second, numpy path: a host library that does not build is an error
    class Failed:
        returncode, stdout, stderr = 1, "", "cc1plus: fatal error"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libpaffy_io_x.so")
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **k: Failed())
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pafio.parse_paf_data(TAGGED.encode())


def test_take_and_record_ops():
    data = workload_text(7).encode()
    t, r = pafio.parse_paf_data(data), ref_pafio.parse_paf_data(data)
    for idx in (np.array([5, 0, 3, 3]), np.arange(len(t)) % 3 == 1,
                np.ones(len(t), dtype=bool)):
        assert_tables_equal(t.take(idx), r.take(idx))


CHECK_CASES = {
    "clean": TAGGED.replace("03M", "3M"),
    "qstart": "q\t10\t-1\t5\t+\tt\t10\t0\t5\t5\t5\t60\n",
    "tend": "q\t10\t0\t5\t+\tt\t4\t0\t5\t5\t5\t60\tcg:Z:5M\n",
    "qspan": "q\t10\t0\t5\t+\tt\t10\t0\t5\t5\t5\t60\tcg:Z:4M\n",
    "tspan": "q\t10\t0\t5\t+\tt\t10\t0\t5\t5\t5\t60\tcg:Z:5M1D\n",
}


@pytest.mark.parametrize("case", list(CHECK_CASES))
def test_paf_check(case):
    text = workload_text(8) + CHECK_CASES[case]
    t, r = pafio.parse_paf_text(text), ref_pafio.parse_paf_text(text)
    try:
        ref_pafio.paf_check(r)
        want = None
    except ref_pafio.PafCheckError as e:
        want = (str(e), e.record_index)
    try:
        pafio.paf_check(t)
        got = None
    except pafio.PafCheckError as e:
        got = (str(e), e.record_index)
    assert got == want
    assert (want is None) == (case == "clean")
    # a subset of the records (dedupe -a's check), the bad one in or out
    for idx in (np.arange(0, len(t), 2), np.arange(1, len(t), 2),
                np.arange(len(t) - 1), np.zeros(0, dtype=np.int64)):
        outcomes = []
        for mod, tab in ((pafio, t), (ref_pafio, r)):
            try:
                mod.paf_check(tab, idx=idx)
                outcomes.append(None)
            except mod.PafCheckError as e:
                outcomes.append((str(e), e.record_index))
        assert outcomes[0] == outcomes[1]


FASTAS = {
    "wrapped-lowercase": ">s1 desc\nACGTacgt\nNNNN\n>s2\nGGGG\n\n>s3\n",
    "duplicates-whitespace": "junk\n>a  \nAC GT\n>b\nTT\n>a\nCCCC  \n",
    "iupac": ">x\nACGTNMKRYVBHDWSX\n>y\nacgtnmkryvbhdwsx\n",
    # the threaded pack's chunk cuts, at 2 and 7 threads, fall inside a
    # long header, inside the content before the first header, and inside
    # a record longer than a chunk
    "cut-in-header": ">" + "h" * 150 + " \t\nACGT\nac\n>b\nGG\n",
    "cut-in-leading-junk": "junk line, > no header\n" * 12 + "ACGT\n>a\nCA\n",
    "crlf": ">a desc\r\nACGT\r\n\r\n acgt \r\n>b\r\nNN\r\n" * 4,
    "no-final-newline": ">a\nACGT\n>b\nAC\nGT",
    "header-last-line": ">a\nACGT\n>b\nGG\n>last \t",
    "empty-file": "",
    "record-longer-than-chunk": ">long\n" + ("ACGTNacgtn" * 8 + "\n") * 30
                                + ">short\nT\n",
    # z twice here and once more in the second file
    "duplicate-in-and-across-files": ">z\nCCCC\n>y\nG\n>z\nA\n>w\nTT\n",
}
POOL_THREADS = [1, 2, 7]


def assert_pools_equal(got, want):
    """Index, guarded length and every host byte (guards and padded tail
    included) equal."""
    assert got.index == want.index and got.pool_len == want.pool_len
    assert list(got.index) == list(want.index)
    np.testing.assert_array_equal(got.host_pool, want.host_pool)
    names = np.array(list(want.index), dtype=object)
    assert got.offsets_for(names, "query").tolist() == \
        want.offsets_for(names, "query").tolist()


@pytest.mark.parametrize("n_threads", POOL_THREADS)
@pytest.mark.parametrize("name", list(FASTAS))
def test_fasta_pool_bytes_and_index(name, n_threads, tmp_path):
    paths = []
    for k in range(2):
        p = tmp_path / f"{k}.fa"
        p.write_bytes((FASTAS[name] if k == 0 else ">z\nTTAA\n").encode())
        paths.append(str(p))
    want = ref_mm.SequencePool.from_fasta_files(paths)
    got = port_mm.SequencePool.from_fasta_files(paths, n_threads=n_threads)
    assert_pools_equal(got, want)
    data = pathlib.Path(paths[0]).read_bytes()
    assert native.fasta_headers(data) == ref_native.fasta_headers(data)


@pytest.mark.parametrize("n_threads", POOL_THREADS)
def test_fasta_pool_through_fifo(n_threads, tmp_path):
    """A FIFO, which cannot be mapped, is read into bytes: the pool of a
    FIFO and a regular file equals paffy_tpu's of the same bytes."""
    import threading
    data = (FASTAS["duplicates-whitespace"]
            + FASTAS["record-longer-than-chunk"]).encode()
    fifo, reg, other = (tmp_path / n for n in ("in.fifo", "in.fa", "z.fa"))
    os.mkfifo(fifo)
    reg.write_bytes(data)
    other.write_bytes(b">z\nTTAA\n")

    def feed():
        with open(fifo, "wb") as fh:
            fh.write(data)
    writer = threading.Thread(target=feed)
    writer.start()
    try:
        got = port_mm.SequencePool.from_fasta_files([str(fifo), str(other)],
                                                    n_threads=n_threads)
    finally:
        writer.join(timeout=30)
    assert not writer.is_alive()
    assert_pools_equal(got, ref_mm.SequencePool.from_fasta_files(
        [str(reg), str(other)]))


def random_fasta(rng) -> bytes:
    """FASTA-like bytes with every case the pack distinguishes: headers
    with trailing whitespace, wrapped and ragged sequence lines with
    whitespace at both ends and inside, empty lines, CR line ends, content
    before the first header, lines that start with '>' after a space."""
    pieces = []
    for _ in range(int(rng.integers(0, 40))):
        kind = rng.integers(0, 8)
        if kind == 0:
            pieces.append(">" + "n" * int(rng.integers(0, 30))
                          + " \t\r"[int(rng.integers(0, 3))]
                          * int(rng.integers(0, 3)))
        elif kind == 1:
            pieces.append("")
        elif kind == 2:
            pieces.append(" >x " + "A" * int(rng.integers(0, 5)))
        else:
            line = "".join(rng.choice(list("ACGTNacgt \t\r\x0b\x0c"),
                                      int(rng.integers(0, 90))))
            pieces.append(line)
    text = "\n".join(pieces)
    return (text + "\n" if rng.random() < 0.7 else text).encode("latin-1")


@pytest.mark.parametrize("seed", range(4))
def test_fasta_pack_threads_equal_paffy_tpu(seed):
    """At every thread count, the threaded pack of random FASTA-like bytes
    in one to three files equals paffy_tpu's pool of the same files."""
    from paffy_tpu.core.fasta import fasta_pool_from_bytes as ref_pool
    from paffy_tpu_torch.core.fasta import fasta_pool_from_bytes
    rng = np.random.default_rng(seed)
    for _ in range(20):
        datas = [random_fasta(rng) for _ in range(int(rng.integers(1, 4)))]
        want_pool, want_index = ref_pool(datas)
        for n_threads in (1, 2, 3, 5, 8, 16):
            pool, index = fasta_pool_from_bytes(datas, n_threads=n_threads)
            np.testing.assert_array_equal(pool, want_pool)
            assert index == want_index and list(index) == list(want_index)
        for data in datas:
            pool, records = native.fasta_pack_bytes(data, n_threads=4)
            want = ref_native.fasta_pack_bytes(data)
            np.testing.assert_array_equal(pool, want[0])
            assert records == want[1]


def pools_and_table(seed):
    seqs, lines = make_workload(seed=seed, length=7000, n_windows=10,
                                window=900, step=500)
    t = pafio.parse_paf_text("\n".join(lines) + "\n")
    ref = ref_mm.SequencePool(seqs)
    g = ref._guard
    port = port_mm.SequencePool.from_arrays(ref.host_pool[g: g + ref._data_len],
                                            ref.index)
    return t, ref_pafio.parse_paf_text("\n".join(lines) + "\n"), port, ref


def test_build_m_column_batch_arrays():
    t, r, port, ref = pools_and_table(9)
    want = ref_segments.build_m_column_batch(
        r, ref.offsets_for(r.qname, "query"), ref.offsets_for(r.tname, "target"))
    got = segments.build_m_column_batch(
        t, port.offsets_for(t.qname, "query"),
        port.offsets_for(t.tname, "target"))
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("mode", ["parsed", "raw"])
def test_stats_calc_with_m(mode):
    data = (workload_text(10) + TAGGED.replace("03M", "3M")).encode()
    kw = dict(parse_cigars=False) if mode == "raw" else {}
    want = ref_transforms.stats_calc_with_m(ref_pafio.parse_paf_data(data, **kw))
    t = pafio.parse_paf_data(data, **kw)
    got = transforms.stats_calc_with_m(t)
    assert list(got[0]) == list(want[0])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", [11, 12])
def test_view_stats_lines_bytes(seed):
    rng = np.random.default_rng(seed)
    n = 50
    names = np.array([f"chr{k}" for k in rng.integers(0, 4, n)], dtype=object)
    vals = rng.integers(0, 10**9, (n, 12))
    vals[: n // 5, 6:8] = 0       # 0/0 identities print -nan
    got = native.view_stats_lines(names, names[::-1].copy(), vals)
    assert got == ref_native.view_stats_lines(names, names[::-1].copy(), vals)
    assert got.count(b"\n") == n and b"-nan" in got


@pytest.mark.parametrize("seed", [13, 14])
def test_column_compare_counts(seed):
    t, r, port, ref = pools_and_table(seed)
    b = segments.build_m_column_batch(
        t, port.offsets_for(t.qname, "query"),
        port.offsets_for(t.tname, "target"))
    k = b.n_mops
    args = (b.lens[:k], b.qpos0[:k], b.tpos0[:k], b.rev[:k], b.rec[:k],
            len(t))
    got = native.column_compare_counts(port.host_pool, *args)
    want = ref_native.column_compare_counts(ref.host_pool, *args)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_pack_ints13_and_copy_op_ranges():
    rng = np.random.default_rng(15)
    cols = [rng.integers(-5, 10**12, 77) for _ in range(13)]
    np.testing.assert_array_equal(native.pack_ints13(cols),
                                  ref_native.pack_ints13(cols))
    ops = rng.integers(0, 5, 300).astype(np.uint8)
    lens = rng.integers(1, 99, 300)
    a = np.sort(rng.integers(0, 300, 20))
    bnd = np.minimum(a + rng.integers(0, 30, 20), 300)
    off = np.concatenate([[0], np.cumsum(bnd - a)])
    for x, y in zip(native.copy_op_ranges(a, bnd, off, ops, lens),
                    ref_native.copy_op_ranges(a, bnd, off, ops, lens)):
        np.testing.assert_array_equal(x, y)


# (record, query name, target name) put into the table; None keeps a name
MISSING = {
    "query": [(3, "zz", None)],
    "target": [(5, None, "yy")],
    "none": [],
    "both-on-one-record": [(4, "zz", "yy")],
    "recurring": [(2, None, "yy"), (6, "yy", None), (7, None, "yy")],
    "at-record-0": [(0, None, "yy")],
    "at-last-record": [(-1, "zz", None)],
}


@pytest.mark.parametrize("case", list(MISSING))
def test_first_missing_seq_matches_paffy_tpu(case):
    from paffy_tpu.commands.simple import _first_missing_seq
    t, r, port, ref = pools_and_table(16)
    for tab in (t, r):
        tab.qname = tab.qname.copy()
        tab.tname = tab.tname.copy()
        for at, qn, tn in MISSING[case]:
            if qn:
                tab.qname[at] = qn
            if tn:
                tab.tname[at] = tn
    got = port.first_missing_seq(t)
    assert got == _first_missing_seq(ref, r)
    assert (got[0] == -1) == (case == "none")


def test_offsets_for_names_the_first_missing_record_as_paffy_tpu():
    t, r, port, ref = pools_and_table(16)
    names = t.qname.copy()
    names[len(names) // 2] = "zz"
    names[-1] = "yy"
    with pytest.raises(KeyError) as got:
        port.offsets_for(names, "query")
    with pytest.raises(KeyError) as want:
        ref.offsets_for(names, "query")
    assert str(got.value) == str(want.value) == \
        repr("No query sequence named: zz found")


def _shuffled_24(n=400):
    rng = np.random.default_rng(24)
    return [np.array([f"chr{k}" for k in rng.integers(0, 24, n)],
                     dtype=object)]


def _distinct_objects():
    # equal strings built at run time, so no two rows share one object
    col = np.array(["".join(["s", str(k // 3 % 2)]) for k in range(12)],
                   dtype=object)
    assert col[0] is not col[1] and col[0] == col[1]
    return [col]


FIRST_SEEN = {
    "empty": lambda: [np.array([], dtype=object)],
    "one-name": lambda: [np.array(["a"] * 7, dtype=object)],
    "long-runs": lambda: [np.array(["b"] * 50 + ["a"] * 30 + ["b"] * 20
                                   + ["c"] * 40, dtype=object)],
    "alternating": lambda: [np.array(["x", "y"] * 25, dtype=object)],
    "shuffled-24": _shuffled_24,
    "equal-strings-distinct-objects": _distinct_objects,
    "two-columns-runs-break-apart": lambda: [
        np.array(["q1"] * 6 + ["q2"] * 6 + ["q1"] * 3, dtype=object),
        np.array(["t1"] * 4 + ["t2"] * 5 + ["t1"] * 6, dtype=object)],
    "latin-1": lambda: [np.array(["\xe9chr1", "\xe9chr1", "chr\xff",
                                  "\xe9chr1", "chr\xff|12|0"],
                                 dtype=object)],
}


@pytest.mark.parametrize("case", list(FIRST_SEEN))
def test_first_seen_ids(case):
    cols = FIRST_SEEN[case]()
    rows = [r if len(cols) > 1 else r[0]
            for r in zip(*(c.tolist() for c in cols))]
    keys = list(dict.fromkeys(rows))
    want_ids = [keys.index(r) for r in rows]
    want_runs = sum(1 for i, r in enumerate(rows)
                    if i == 0 or r != rows[i - 1])
    ids, got_keys, n_runs = native.first_seen_ids(*cols)
    assert ids.dtype == np.int64
    assert ids.tolist() == want_ids
    assert got_keys == keys
    assert n_runs == want_runs
    assert native.first_rows(ids).tolist() == [rows.index(k) for k in keys]
    perm, goff = native.id_groups(ids, len(keys))
    assert [perm[a:b].tolist() for a, b in zip(goff[:-1], goff[1:])] == \
        [[i for i, r in enumerate(rows) if r == k] for k in keys]


@pytest.mark.parametrize("seed", [17, 18])
def test_segsum(seed):
    from paffy_tpu.core import segsum as ref_segsum
    from paffy_tpu_torch.core import segsum
    rng = np.random.default_rng(seed)
    off = np.concatenate([[0], np.cumsum(rng.integers(0, 4, 30))])
    vals = rng.integers(-50, 50, int(off[-1]))
    for v in (vals, vals > 0, vals[:0]):
        o = off if len(v) else np.zeros(5, dtype=np.int64)
        got = segsum.segment_sums_by_offsets(v, o)
        want = ref_segsum.segment_sums_by_offsets(v, o)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(segsum.segment_ids_from_offsets(off),
                                  ref_segsum.segment_ids_from_offsets(off))


@pytest.mark.parametrize("pct", [0.0, 0.15, 0.5, 1.0])
def test_fixed_trim_transforms(pct):
    data = (workload_text(19) + TAGGED.replace("03M", "3M")).encode()
    t, r = pafio.parse_paf_data(data), ref_pafio.parse_paf_data(data)
    assert_tables_equal(transforms.trim_end_fraction(t, pct),
                        ref_transforms.trim_end_fraction(r, pct))
    np.testing.assert_array_equal(transforms.aligned_base_counts(t),
                                  ref_transforms.aligned_base_counts(r))
    for a, b in zip(transforms._reverse_csr(t.ops, t.lens, t.off),
                    ref_transforms._reverse_csr(r.ops, r.lens, r.off)):
        np.testing.assert_array_equal(a, b)
    for k, v in ref_transforms.stats_calc(r).items():
        np.testing.assert_array_equal(transforms.stats_calc(t)[k], v)
    with pytest.raises(AssertionError):
        transforms.trim_end_fraction(t, 1.5)


@pytest.mark.parametrize("mode", ["parsed", "raw"])
def test_tailtrim_and_its_native_passes(mode):
    from paffy_tpu.ops import tailtrim as ref_tailtrim
    from paffy_tpu_torch.ops import tailtrim
    data = (workload_text(20) + TAGGED.replace("03M", "3M")).encode()
    kw = dict(parse_cigars=False) if mode == "raw" else {}
    t, r = pafio.parse_paf_data(data, **kw), ref_pafio.parse_paf_data(data, **kw)
    for fr in ((0.05, 1.0), (0.4, 0.5)):
        assert_tables_equal(tailtrim.trim_unreliable_tails(t, *fr),
                            ref_tailtrim.trim_unreliable_tails(r, *fr))
        if mode == "raw":
            got = native.trim_tails_raw(t, *fr)
            want = ref_native.trim_tails_raw(r, *fr)
        else:
            got = native.trim_tails_apply(t.off, t.ops, t.lens, t.strand, *fr)
            want = ref_native.trim_tails_apply(r.off, r.ops, r.lens, r.strand,
                                               *fr)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_native_chain_dp():
    from paffy_tpu.ops.chain import _window_bounds
    rng = np.random.default_rng(21)
    n = 300
    qs = np.sort(rng.integers(0, 3000, n))
    qe = qs + rng.integers(1, 40, n)
    ts = qs + rng.integers(-20, 20, n)
    te = ts + rng.integers(1, 40, n)
    score = rng.integers(1, 500, n)
    win = _window_bounds(qs, qe, 200)
    got = native.chain_dp(qs, qe, ts, te, score, *win, 50, 1, 200)
    want = ref_native.chain_dp(qs, qe, ts, te, score, *win, 50, 1, 200)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (got[1] >= 0).any()


@pytest.mark.parametrize("label", chip_smoke.K5_EDGE_LABELS)
def test_native_tile_sweep(label):
    # the port's C sweep against paffy_tpu's: counts and levels
    *host, cap, _ = chip_smoke.k5_edge_cases(scale=0.2)[label]
    size = int(host[1].max()) + int(host[4].max())
    out = []
    for mod in (native, ref_native):
        arena = np.zeros(size, dtype=np.uint16)
        levels = np.full(len(host[2]) - 1, 32767, dtype=np.int64)
        mod.tile_sweep(*host, arena, cap, levels)
        out.append((arena, levels))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert (out[0][1] < 32767).any() and out[0][0].any()


@pytest.mark.parametrize("case", list(CHECK_CASES))
def test_paf_check_of_raw_spans(case):
    text = workload_text(8) + CHECK_CASES[case]
    outcomes = []
    for mod in (pafio, ref_pafio):
        t = mod.parse_paf_data(text.encode(), parse_cigars=False)
        for spans in (False, True):
            try:
                mod.paf_check(t, check_raw_spans=spans)
                outcomes.append(None)
            except mod.PafCheckError as e:
                outcomes.append((str(e), e.record_index))
    assert outcomes[:2] == outcomes[2:]
    assert (outcomes[1] is None) == (case == "clean")
    assert (outcomes[0] is None) == (case in ("clean", "qspan", "tspan"))


def test_read_table_and_stream_transform_flags(tmp_path):
    import argparse
    from paffy_tpu.commands import common as ref_common
    from paffy_tpu_torch.commands import common
    path = tmp_path / "in.paf"
    path.write_bytes((workload_text(22) + TAGGED).encode())
    for parse in (True, False):
        args = argparse.Namespace(inputFile=str(path), outputFile=None)
        assert_tables_equal(common.read_table(args, parse_cigars=parse),
                            ref_common.read_table(args, parse_cigars=parse))
    for kw in ({}, dict(parse_cigars=False),
               dict(parse_cigars=False, validate_cigars=True)):
        seen = {}
        for tag, mod in (("port", common), ("ref", ref_common)):
            out = tmp_path / f"{tag}.paf"
            args = argparse.Namespace(inputFile=str(path),
                                      outputFile=str(out))
            batches = []

            def fn(t, batches=batches):
                batches.append(t.raw_cg is not None)
                return t
            mod.stream_transform(args, fn, **kw)
            seen[tag] = (batches, out.read_bytes())
        assert seen["port"] == seen["ref"]


SHATTER_CASES = {
    "clean": "",
    "eq-op": "q\t10\t0\t5\t+\tt\t10\t0\t5\t5\t5\t60\tcg:Z:2=3X\n",
    "zero-op": "q\t10\t0\t5\t+\tt\t10\t0\t5\t5\t5\t60\tcg:Z:0I5M\n",
    "walk": "q\t10\t0\t6\t-\tt\t10\t0\t5\t5\t5\t60\tcg:Z:5M\n",
    "shard": "q\t4\t0\t5\t+\tt\t10\t0\t5\t5\t5\t60\tcg:Z:5M\n",
}


def shatter_table(case, mod):
    text = workload_text(23) + SHATTER_CASES[case] + workload_text(24)
    return mod.parse_paf_text(text)


@pytest.mark.parametrize("case", list(SHATTER_CASES))
def test_shatter_violation_and_its_native_pass(case):
    t, r = shatter_table(case, pafio), shatter_table(case, ref_pafio)
    want = ref_transforms.shatter_violation(r)
    assert transforms.shatter_violation(t) == want
    assert native.shatter_violation(t) == ref_native.shatter_violation(r)
    assert (want[0] is None) == (case == "clean")
    assert want[0] in (None, "check" if case == "shard" else "abort")


@pytest.mark.parametrize("seed", [25, 26])
def test_shatter_and_its_native_passes(seed):
    data = workload_text(seed).encode()
    t, r = pafio.parse_paf_data(data), ref_pafio.parse_paf_data(data)
    assert_tables_equal(transforms.shatter(t), ref_transforms.shatter(r))
    m_base = np.concatenate([[0], np.cumsum(
        [np.count_nonzero(t.ops[a:b] == 0) for a, b in zip(t.off, t.off[1:])])])
    args = (t.off, t.ops, t.lens, t.qstart, t.qend, t.tstart, t.strand,
            m_base[:-1], int(m_base[-1]))
    for a, b in zip(native.shatter_walk(*args), ref_native.shatter_walk(*args)):
        np.testing.assert_array_equal(a, b)
    want = bytes(ref_native.shatter_serialize(r))
    assert want == bytes(ref_pafio.serialize_paf_bytes(ref_transforms.shatter(r)))
    for nt in (1, 3, 8):      # the bytes do not depend on the threads
        assert bytes(native.shatter_serialize(t, n_threads=nt)) == want
    enc = pafio.parse_paf_data(data.replace(b"M", b"="))
    with pytest.raises(ValueError, match="M-encoded"):
        transforms.shatter(enc)
    assert transforms.shatter(t.take(np.zeros(0, dtype=np.int64))).qname.size == 0


@pytest.mark.parametrize("mode", ["parsed", "raw"])
def test_invert_and_its_native_passes(mode):
    data = (workload_text(27) + TAGGED.replace("03M", "3M")).encode()
    kw = dict(parse_cigars=False) if mode == "raw" else {}
    t, r = pafio.parse_paf_data(data, **kw), ref_pafio.parse_paf_data(data, **kw)
    if mode == "parsed":
        assert_tables_equal(transforms.invert(t), ref_transforms.invert(r))
        for a, b in zip(native.invert_ops(t.off, t.ops, t.lens, ~t.strand),
                        ref_native.invert_ops(r.off, r.ops, r.lens, ~r.strand)):
            np.testing.assert_array_equal(a, b)
        return
    want = bytes(ref_native.invert_serialize(r))
    for nt in (1, 3, 8):
        assert bytes(native.invert_serialize(t, n_threads=nt)) == want


class Sink:
    def __init__(self):
        self.data = b""

    def write(self, b):
        self.data += bytes(b)


@pytest.mark.parametrize("chunk", [64, 1000, 1 << 25])
def test_streamed_serializers_and_a_span_failure(monkeypatch, chunk):
    # slices of the reused fill buffer, one record larger than a slice,
    # and the bytes before a record whose cigar span fails
    monkeypatch.setattr(native, "_STREAM_CHUNK", chunk)
    monkeypatch.setattr(ref_native, "_STREAM_CHUNK", chunk)
    bad = "q\t10\t0\t5\t+\tt\t10\t0\t5\t5\t5\t60\tcg:Z:4M\n"
    for text in (workload_text(28), workload_text(28) + bad
                 + workload_text(29)):
        outs = []
        for mod, pio in ((native, pafio), (ref_native, ref_pafio)):
            t = pio.parse_paf_data(text.encode(), parse_cigars=False)
            sink = Sink()
            try:
                res = mod.invert_serialize(t, fh=sink)
            except pio.PafCheckError as e:
                res = str(e)
            outs.append((res, sink.data))
            sink = Sink()
            tp = pio.parse_paf_data(workload_text(30).encode())
            assert mod.shatter_serialize(tp, fh=sink) is True
            outs.append(sink.data)
        assert outs[:2] == outs[2:]
        assert outs[0][1]


@pytest.mark.parametrize("binary", [False, True])
def test_coverage_map_and_run_length_rows(binary):
    from paffy_tpu.ops import coverage as ref_coverage
    from paffy_tpu_torch.ops import coverage
    maps = [coverage.CoverageMap(), ref_coverage.CoverageMap()]
    data = workload_text(31).encode()
    tt, rr = pafio.parse_paf_data(data), ref_pafio.parse_paf_data(data)
    half = len(tt) // 2
    for rows in (np.arange(half), np.arange(half, len(tt))):   # two batches
        t, r = tt.take(rows), rr.take(rows)
        names = np.column_stack([t.qname, t.tname]).ravel()
        lens = np.column_stack([t.qlen, t.tlen]).ravel()
        np.testing.assert_array_equal(maps[0].register_batch(names, lens),
                                      maps[1].register_batch(names, lens))
        maps[0].add(t)
        maps[1].add(r)
        maps[0].add(transforms.invert(t))
        maps[1].add(ref_transforms.invert(r))
    assert maps[0].names == maps[1].names and maps[0].lengths == maps[1].lengths
    for name in maps[1].names:
        got, want = maps[0].counts(name), maps[1].counts(name)
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
        for a, b in zip(coverage.run_length_rows(got, binary),
                        ref_coverage.run_length_rows(want, binary)):
            np.testing.assert_array_equal(a, b)
    for m in maps:
        with pytest.raises(ValueError, match="inconsistent lengths"):
            m.register_batch(np.array([maps[1].names[0]], dtype=object),
                             np.array([7]))
    empty = np.zeros(0, dtype=np.uint16)
    for a, b in zip(coverage.run_length_rows(empty, binary),
                    ref_coverage.run_length_rows(empty, binary)):
        np.testing.assert_array_equal(a, b)


def test_native_coverage_passes():
    rng = np.random.default_rng(33)
    n = 5000
    starts = rng.integers(0, n, 3000)
    ends = np.minimum(starts + rng.integers(0, 400, 3000), n)
    diffs = [np.zeros(n + 1, dtype=np.int32) for _ in range(2)]
    native.coverage_add(diffs[0], starts, ends)
    assert ref_native.coverage_add(diffs[1], starts, ends)
    np.testing.assert_array_equal(diffs[0], diffs[1])
    for d in (diffs[0][:-1], diffs[0][:-1].astype(np.int64)):
        for sat in (3, 32766):
            np.testing.assert_array_equal(native.coverage_counts(d, sat),
                                          ref_native.coverage_counts(d, sat))
    counts = native.coverage_counts(diffs[0][:-1], 5)
    for binary in (False, True):
        for a, b in zip(native.rle_u16(counts, binary),
                        ref_native.rle_u16(counts, binary)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        native.coverage_add(diffs[0].astype(np.int64), starts, ends)


@pytest.mark.parametrize("header", [
    "n|20x|5", "a|b|100| 7", "t|30|+2", "chr1|1000|-3", "x|1|2|3",
    "x|1", "n|20|x", "plain"])
def test_header_codec(header):
    from paffy_tpu.core import fasta as ref_fasta
    from paffy_tpu_torch.core import fasta
    try:
        want = ref_fasta.decode_header(header)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fasta.decode_header(header)
        assert str(got.value) == str(e)
        return
    got = fasta.decode_header(header)
    assert (got.name, got.start, got.end, got.length) == (
        want.name, want.start, want.end, want.length)
    assert fasta.encode_header(got.name, got.length, got.start) == \
        ref_fasta.encode_header(want.name, want.length, want.start)


@pytest.mark.parametrize("name", list(FASTAS))
def test_fasta_text_readers_and_writers(name):
    import io
    from paffy_tpu.core import fasta as ref_fasta
    from paffy_tpu_torch.core import fasta
    text = FASTAS[name]
    assert fasta.read_fasta_list(io.StringIO(text)) == \
        ref_fasta.read_fasta_list(io.StringIO(text))
    assert list(fasta.read_fasta(io.StringIO(text)).items()) == \
        list(ref_fasta.read_fasta(io.StringIO(text)).items())
    for width in (0, 1, 3, 80):
        outs = []
        for mod in (fasta, ref_fasta):
            fh = io.StringIO()
            for header, seq in mod.read_fasta_list(io.StringIO(text)):
                mod.write_fasta_record(fh, header, seq, width)
            w = mod.SequenceLineWriter(fh, width)
            for piece in ("ACG", "", "T" * 7, "GG"):
                w.piece(piece)
            w.end()
            w.end()
            outs.append(fh.getvalue())
        assert outs[0] == outs[1]


def smoke_files(d, ref: bool, **sizes):
    """chip_smoke.py's synthesis through paffy_tpu's native library (ref)
    or the port's."""
    os.makedirs(d, exist_ok=True)
    return chip_smoke.build_files(str(d), ref_native if ref else native,
                                  **sizes)


SMALL = dict(seq_len=400_000, n_records=12, m_columns=300_000)


def test_smoke_synthesis_byte_equal_and_view(tmp_path):
    fa_r, paf_r, _ = smoke_files(tmp_path / "ref", True, **SMALL)
    fa_p, paf_p, w = smoke_files(tmp_path / "port", False, **SMALL)
    for a, b in ((fa_r, fa_p), (paf_r, paf_p)):
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
    assert int(w["runs"].sum()) >= SMALL["m_columns"]
    for flags in (["-s"], ["-s", "-t"]):
        outs = []
        for main, tag in ((ref_main, "ref"), (port_main, "port")):
            o = tmp_path / f"{tag}.txt"
            assert main(["view", "-i", paf_p, *flags, "-o", str(o), fa_p]) == 0
            outs.append(o.read_bytes())
        assert outs[0] == outs[1]


def test_smoke_chain_input_is_paffy_tpus_shatter(tmp_path):
    fa, paf, w = smoke_files(tmp_path, True, **SMALL)
    out = tmp_path / "shattered.paf"
    assert ref_main(["shatter", "-i", paf, "-o", str(out)]) == 0
    got = chip_smoke.chain_input(w, seq_len=SMALL["seq_len"])
    assert got == out.read_bytes()
    assert got.count(b"\n") == len(w["runs"]) and b"\t-\t" in got


def pipeline_pins(d, fa, chain_paf) -> dict:
    """paffy_tpu's chain on chip_smoke.chain_input, its add_mismatches,
    chain, tile and trim one after another from that input, and its
    run_pipeline (one shard) on it, as digests (its host routes)."""
    from paffy_tpu.core.fasta import read_fasta
    from paffy_tpu.parallel.runner import run_pipeline
    pins = {}
    out = os.path.join(d, "chained.paf")
    assert ref_main(["chain", "-i", chain_paf, "-o", out]) == 0
    pins["chain"] = chip_smoke.sha256_file(out)
    src = chain_paf
    for cmd, extra in (("add_mismatches", [fa]), ("chain", []), ("tile", []),
                       ("trim", [])):
        out = os.path.join(d, f"pipe_{cmd}.paf")
        assert ref_main([cmd, "-i", src, *extra, "-o", out]) == 0
        pins[f"pipeline {cmd}"] = chip_smoke.sha256_file(out)
        src = out
    t = ref_pafio.parse_paf_data(pathlib.Path(chain_paf).read_bytes())
    out = os.path.join(d, "run_pipeline.paf")
    pathlib.Path(out).write_bytes(bytes(ref_pafio.serialize_paf_bytes(
        run_pipeline(t, read_fasta(fa), n_shards=1))))
    pins["run_pipeline"] = chip_smoke.sha256_file(out)
    return pins


def deep_pins(d, works, lens) -> dict:
    """chip_smoke.deep_tile_input on build_genome's genome and paffy_tpu's
    tile on it, as digests; prints the seconds the tile took."""
    import time
    paf, out = os.path.join(d, "deep.paf"), os.path.join(d, "deep_tiled.paf")
    pathlib.Path(paf).write_bytes(chip_smoke.deep_tile_input(works, lens))
    t0 = time.perf_counter()
    assert ref_main(["tile", "-i", paf, "-o", out]) == 0
    print(f"paffy_tpu tile of deep.paf: {time.perf_counter() - t0:.1f} s "
          f"on the host")
    return {"deep.paf": chip_smoke.sha256_file(paf),
            "deep tile": chip_smoke.sha256_file(out)}


def genome_pins(d, deep_only=False) -> dict:
    """chip_smoke.build_genome at full size through paffy_tpu's native
    library, paffy_tpu's run_pipeline on it (one shard, its own worker
    threads), its view -s of genome.paf's lines repeated
    (chip_smoke.repeat_lines) past BIG_BATCHES - 1 full batches, and
    deep_pins, as digests; only deep_pins when ``deep_only``."""
    from paffy_tpu.core.fasta import read_fasta
    from paffy_tpu.parallel.runner import run_pipeline
    os.environ["PAFFY_TPU_PLATFORM"] = "cpu"
    fa, paf, lens, works = chip_smoke.build_genome(d, ref_native)
    if deep_only:
        return deep_pins(d, works, lens)
    t = ref_pafio.parse_paf_data(pathlib.Path(paf).read_bytes())
    out = os.path.join(d, "run_pipeline_genome.paf")
    pathlib.Path(out).write_bytes(bytes(ref_pafio.serialize_paf_bytes(
        run_pipeline(t, read_fasta(fa), n_shards=1))))
    pins = {"genome.fa": chip_smoke.sha256_file(fa),
            "genome.paf": chip_smoke.sha256_file(paf),
            "run_pipeline genome": chip_smoke.sha256_file(out)}
    big = os.path.join(d, "genome_repeated.paf")
    chip_smoke.repeat_lines(paf, big, (chip_smoke.BIG_BATCHES - 1)
                            * chip_smoke.FULL_BATCH_BYTES)
    out = os.path.join(d, "big_view.txt")
    assert ref_main(["view", "-i", big, "-s", fa, "-o", out]) == 0
    pins["view -s genome repeated"] = chip_smoke.sha256_file(out)
    pins.update(deep_pins(d, works, lens))
    return pins


def make_pins(d) -> dict:
    """The digests chip_smoke.py pins: its chromosome-scale synthesis
    through paffy_tpu's native library; paffy_tpu's view -s and
    view -s -t, view -a of chip_smoke.render_input, add_mismatches, and
    add_mismatches -a on that output, on those files (its host routes);
    chip_smoke.tile_input made from that output, and paffy_tpu's tile on
    it; paffy_tpu's shatter of in.paf (which chip_smoke.chain_input
    writes itself) and pipeline_pins on it; chip_smoke.host_phase through
    paffy_tpu's commands."""
    os.environ["PAFFY_TPU_PLATFORM"] = "cpu"
    fa, paf, w = smoke_files(d, True)
    pins = {"seqs.fa": chip_smoke.sha256_file(fa),
            "in.paf": chip_smoke.sha256_file(paf)}
    for tag, flags in (("view -s", ["-s"]), ("view -s -t", ["-s", "-t"])):
        out = os.path.join(d, "out.txt")
        assert ref_main(["view", "-i", paf, *flags, "-o", out, fa]) == 0
        pins[tag] = chip_smoke.sha256_file(out)
        print(tag, open(out, "rb").read().splitlines()[-1].decode())
    rpaf, out = os.path.join(d, "render.paf"), os.path.join(d, "out.txt")
    pathlib.Path(rpaf).write_bytes(chip_smoke.render_input(
        pathlib.Path(paf).read_bytes(),
        (chip_smoke.RENDER_SLICES - 1) * chip_smoke.RENDER_SLICE_BYTES))
    assert ref_main(["view", "-a", "-i", rpaf, fa, "-o", out]) == 0
    pins["view -a"] = chip_smoke.sha256_file(out)
    am, tpaf = os.path.join(d, "am.paf"), os.path.join(d, "tile.paf")
    runs = {"add_mismatches": (["add_mismatches", "-i", paf, fa], am),
            "add_mismatches -a": (["add_mismatches", "-a", "-i", am],
                                  os.path.join(d, "am_a.paf")),
            "tile": (["tile", "-i", tpaf], os.path.join(d, "tiled.paf"))}
    for tag, (argv, out) in runs.items():
        if tag == "tile":
            pathlib.Path(tpaf).write_bytes(
                chip_smoke.tile_input(pathlib.Path(am).read_bytes()))
            pins["tile.paf"] = chip_smoke.sha256_file(tpaf)
        assert ref_main([*argv, "-o", out]) == 0
        pins[tag] = chip_smoke.sha256_file(out)
    cpaf = os.path.join(d, "chain.paf")
    assert ref_main(["shatter", "-i", paf, "-o", cpaf]) == 0
    assert pathlib.Path(cpaf).read_bytes() == chip_smoke.chain_input(w)
    pins["chain.paf"] = chip_smoke.sha256_file(cpaf)
    pins.update(pipeline_pins(d, fa, cpaf))
    hd = os.path.join(d, "host")
    os.makedirs(hd)
    digests, walls = chip_smoke.host_phase(
        hd, paf, fa, cpaf, tpaf, os.path.join(d, "pipe_tile.paf"), ref_main,
        ref_faffy)
    for tag, sec in walls.items():
        print(f"paffy_tpu {tag}: {sec:.2f} s on the host")
    assert digests["dechunk"] == pins["in.paf"]
    pins.update(digests)
    pins.update(genome_pins(d))
    return pins


HOST_PINS = ("invert in.paf", "invert chain.paf", "dedupe -a", "filter -w 1",
             "filter -u 0.97", "to_bed", "to_bed -b -n", "to_bed -e -m 100",
             "split_file -q -m", "faffy chunk", "faffy merge",
             "faffy extract", "upconvert", "dechunk")


def test_smoke_host_phase_equals_paffy_tpus(tmp_path):
    """chip_smoke.host_phase at a small size: the port's commands give
    paffy_tpu's digests, one for each pin of the phase."""
    fa, paf, w = smoke_files(tmp_path / "in", True, **SMALL)
    cpaf, tpaf = str(tmp_path / "chain.paf"), str(tmp_path / "tile.paf")
    pathlib.Path(cpaf).write_bytes(chip_smoke.chain_input(
        w, seq_len=SMALL["seq_len"]))
    am = tmp_path / "am.paf"
    assert ref_main(["add_mismatches", "-i", paf, fa, "-o", str(am)]) == 0
    pathlib.Path(tpaf).write_bytes(chip_smoke.tile_input(am.read_bytes()))
    pipe_tile = str(tmp_path / "pipe_tile.paf")
    assert ref_main(["tile", "-i", str(am), "-o", pipe_tile]) == 0
    got = []
    for tag, mains in (("ref", (ref_main, ref_faffy)),
                       ("port", (port_main, port_faffy))):
        os.makedirs(tmp_path / tag)
        got.append(chip_smoke.host_phase(str(tmp_path / tag), paf, fa, cpaf,
                                         tpaf, pipe_tile, *mains)[0])
    assert got[0] == got[1]
    assert sorted(got[0]) == sorted(HOST_PINS)
    assert got[0]["dechunk"] == chip_smoke.sha256_file(paf)


def test_pins_are_digests():
    assert set(chip_smoke.PINS) == {
        "seqs.fa", "in.paf", "view -s", "view -s -t", "add_mismatches",
        "add_mismatches -a", "tile.paf", "tile", "chain.paf", "chain",
        "pipeline add_mismatches", "pipeline chain", "pipeline tile",
        "pipeline trim", "run_pipeline", *HOST_PINS, "genome.fa",
        "genome.paf", "run_pipeline genome", "view -a",
        "view -s genome repeated", "deep.paf", "deep tile"}
    for v in chip_smoke.PINS.values():
        assert len(v) == 64 and int(v, 16) >= 0
    assert hashlib.sha256(b"").hexdigest() not in chip_smoke.PINS.values()


if __name__ == "__main__" and "--pins" in sys.argv:
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        if "deep" in sys.argv:
            pins = genome_pins(tmp, deep_only=True)
        else:
            pins = (genome_pins if "genome" in sys.argv else make_pins)(tmp)
        for k, v in pins.items():
            print(f'    "{k}": "{v}",')
