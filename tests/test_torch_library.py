"""The library surface of paffy_tpu_torch against paffy_tpu's, on the CPU:
the package's exports (``PafTable``, ``pafio``, ``fasta``, as
paffy_tpu/__init__.py:25-26 exports them), the model's op constants and
``PafTable.n_ops``, ``build``, ``copy``, ``record_ops`` and ``name_ids``;
pafio's ``parse_cigar_string``, ``serialize_paf``, ``read_paf_file`` and
``write_paf_file``; fasta's complement tables, ``reverse_complement``,
``load_sequences`` and ``seq_to_bytes``; and the writers' ``flush``.  Inputs
are made from a numpy seed and parsed by both packages; every comparison is
exact (values, dtypes, shapes, exception class and message, bytes).
Importing the package loads no torch, no JAX and nothing of paffy_tpu."""

import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import paffy_tpu_torch as pt
from paffy_tpu.cli import paffy_main as ref_main
from paffy_tpu.commands import common as ref_common
from paffy_tpu.core import fasta as ref_fasta
from paffy_tpu.core import model as ref_model
from paffy_tpu.core import pafio as ref_pafio
from paffy_tpu_torch.cli import paffy_main as port_main
from paffy_tpu_torch.commands import common
from paffy_tpu_torch.core import model
from ref_native import paffy_tpu_lib  # noqa: F401
from synthdata import make_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("chr1", "chr2", "scaffold_3", "q.ctg|10|0", "t")


def paf_text(seed, n=60) -> str:
    """``n`` seeded PAF lines: names from NAMES, either strand, every
    optional tag now and then, cigars of every op (some records without
    one)."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        q, t = rng.choice(NAMES, 2)
        n_ops = int(rng.integers(1, 9))
        ops = rng.integers(0, 5, n_ops)
        lens = rng.integers(1, 400, n_ops)
        qspan = int(lens[ops != 2].sum())
        tspan = int(lens[ops != 1].sum())
        qs, ts = (int(v) for v in rng.integers(0, 5000, 2))
        f = [q, str(qs + qspan + 9), str(qs), str(qs + qspan),
             "+" if rng.random() < 0.6 else "-", t, str(ts + tspan + 3),
             str(ts), str(ts + tspan), str(int(rng.integers(0, qspan + 1))),
             str(max(qspan, tspan)), str(int(rng.integers(0, 256)))]
        if rng.random() < 0.3:
            f.append("tp:A:" + "PSI"[int(rng.integers(0, 3))])
        if rng.random() < 0.5:
            f.append(f"AS:i:{int(rng.integers(-50, 10**6))}")
        for tag in ("tl", "cn", "s1"):
            if rng.random() < 0.3:
                f.append(f"{tag}:i:{int(rng.integers(0, 9))}")
        if rng.random() < 0.85:
            f.append("cg:Z:" + "".join(f"{int(ln)}{'MID=X'[int(o)]}"
                                       for o, ln in zip(ops, lens)))
        lines.append("\t".join(f) + "\n")
    return "".join(lines)


def both_tables(seed, raw=False):
    """(port's table, paffy_tpu's table) of paf_text(seed)."""
    data = paf_text(seed).encode()
    return (pt.pafio.parse_paf_data(data, parse_cigars=not raw),
            ref_pafio.parse_paf_data(data, parse_cigars=not raw))


def assert_same_table(got, want):
    """Every field equal in value, dtype and shape (raw cigars too)."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "raw_cg":
            assert (a is None) == (b is None)
            if b is not None:
                assert bytes(a[0]) == bytes(b[0])
                for x, y in zip(a[1:], b[1:]):
                    assert x.dtype == y.dtype and np.array_equal(x, y)
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.tolist() == b.tolist(), f.name


def rows_of(seed, cigars=True, fields=True):
    """Seeded per-record dicts for ``PafTable.build``."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(25):
        r = {"qname": str(rng.choice(NAMES)), "tname": str(rng.choice(NAMES))}
        if fields:
            r.update(qlen=int(rng.integers(1, 10**6)), qstart=i,
                     qend=i + 100, strand=bool(rng.random() < 0.5),
                     tlen=int(rng.integers(1, 10**6)), tstart=2 * i,
                     tend=2 * i + 90, num_matches=80, num_bases=100,
                     mapq=int(rng.integers(0, 256)),
                     score=int(rng.integers(0, 10**4)))
            if i % 3 == 0:
                r.update(tile_level=1 + i % 4, chain_id=i, chain_score=7 * i,
                         type="PSI"[i % 3])
        if cigars:
            n = int(rng.integers(0, 6))
            r["cigar"] = [(int(o), int(ln)) for o, ln in
                          zip(rng.integers(0, 5, n), rng.integers(1, 99, n))]
        rows.append(r)
    return rows


@pytest.mark.parametrize("module,name", [
    ("model", "OP_CHARS"), ("model", "CHAR_TO_OP"), ("model", "ALIGNED_OPS"),
    ("fasta", "COMPLEMENT_TABLE"), ("fasta", "UPPER_TABLE")])
def test_constants_equal_paffy_tpus(module, name):
    got = getattr(model if module == "model" else pt.fasta, name)
    want = getattr(ref_model if module == "model" else ref_fasta, name)
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("case", ["with cigars", "without cigars",
                                  "default fields", "empty and None cigars",
                                  "no rows"])
def test_build_equals_paffy_tpus(case):
    rows = {"with cigars": rows_of(1),
            "without cigars": rows_of(2, cigars=False),
            "default fields": rows_of(3, fields=False),
            "empty and None cigars": [dict(r, cigar=[] if i % 2 else None)
                                      for i, r in enumerate(rows_of(4))],
            "no rows": []}[case]
    got, want = pt.PafTable.build(rows), ref_model.PafTable.build(rows)
    assert_same_table(got, want)
    assert bytes(pt.pafio.serialize_paf_bytes(got)) == \
        bytes(ref_pafio.serialize_paf_bytes(want))
    if case == "default fields":
        assert got.mapq.tolist() == [255] * len(rows)
        assert (got.tile_level == -1).all() and got.strand.all()
        assert (got.type == 0).all() and (got.score == 0).all()
    if case == "empty and None cigars":
        assert not got.has_cigar.any() and len(got.ops) == 0


@pytest.mark.parametrize("raw", [False, True], ids=["parsed", "raw"])
def test_copy_is_deep_as_paffy_tpus(raw):
    t, r = both_tables(5, raw)
    c, rc = t.copy(), r.copy()
    assert_same_table(c, rc)
    assert_same_table(c, t)
    for f in dataclasses.fields(t):
        a, b = getattr(c, f.name), getattr(t, f.name)
        if f.name == "raw_cg":
            if raw:
                assert a[0] is b[0]           # the input bytes, immutable
                assert not np.shares_memory(a[1], b[1])
                assert not np.shares_memory(a[2], b[2])
            continue
        assert a is not b and (a.size == 0 or not np.shares_memory(a, b))
    c.qstart += 1
    c.qname[0] = "changed"
    assert_same_table(t, r)


@pytest.mark.parametrize("seed", [6, 7])
def test_record_ops_are_views_and_n_ops(seed):
    t, r = both_tables(seed)
    assert t.n_ops.dtype == r.n_ops.dtype
    assert t.n_ops.tolist() == r.n_ops.tolist()
    for i in range(len(t)):
        ops, lens = t.record_ops(i)
        want_ops, want_lens = r.record_ops(i)
        assert ops.dtype == want_ops.dtype and lens.dtype == want_lens.dtype
        assert ops.tolist() == want_ops.tolist()
        assert lens.tolist() == want_lens.tolist()
        assert len(ops) == t.n_ops[i]
        if len(ops):
            assert np.shares_memory(ops, t.ops)
            assert np.shares_memory(lens, t.lens)


def name_rows(pattern):
    rng = np.random.default_rng(8)
    if pattern == "repeated":
        pairs = [("a", "b")] * 30
    elif pattern == "interleaved":
        pairs = [tuple(rng.choice(["x", "y", "z", "w"], 2)) for _ in range(40)]
    elif pattern == "self":
        pairs = [(n, n) for n in rng.choice(["s1", "s2", "s3"], 20)]
    elif pattern == "target first seen":
        pairs = [("q1", "t1"), ("t1", "q2"), ("q2", "q1"), ("t2", "t2")]
    else:
        pairs = []
    return [{"qname": q, "tname": t} for q, t in pairs]


@pytest.mark.parametrize("pattern", ["repeated", "interleaved", "self",
                                     "target first seen", "empty"])
def test_name_ids_equal_paffy_tpus(pattern):
    rows = name_rows(pattern)
    got = pt.PafTable.build(rows).name_ids()
    want = ref_model.PafTable.build(rows).name_ids()
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and a.tolist() == b.tolist()
    assert got[2] == want[2]


def test_name_ids_on_parsed_tables_equal_paffy_tpus():
    t, r = both_tables(9)
    got, want = t.name_ids(), r.name_ids()
    assert got[0].tolist() == want[0].tolist()
    assert got[1].tolist() == want[1].tolist() and got[2] == want[2]


def seeded_cigar(seed=10, n=500):
    rng = np.random.default_rng(seed)
    return "".join(f"{int(ln)}{'MID=X'[int(o)]}" for o, ln in
                   zip(rng.integers(0, 5, n), rng.integers(1, 10**6, n)))


@pytest.mark.parametrize("s", ["", "10M", "5M2I3D4=1X", "007M0I",
                               seeded_cigar()],
                         ids=["empty", "one", "every-op", "zeros", "seeded"])
def test_parse_cigar_string_equals_paffy_tpus(s):
    got = pt.pafio.parse_cigar_string(s)
    assert got == ref_pafio.parse_cigar_string(s)
    assert all(type(o) is int and type(n) is int for o, n in got)


@pytest.mark.parametrize("s", ["10", "M", "10Q", "5M 3I", "3M-2D", "4S",
                               seeded_cigar(11, 50) + "7N"],
                         ids=["no-op", "no-length", "bad-op", "space",
                              "sign", "soft-clip", "seeded-tail"])
def test_parse_cigar_string_rejects_as_paffy_tpu(s):
    with pytest.raises(ValueError) as got:
        pt.pafio.parse_cigar_string(s)
    with pytest.raises(ValueError) as want:
        ref_pafio.parse_cigar_string(s)
    assert got.type is pt.pafio.PafFormatError
    assert got.type.__name__ == want.type.__name__ == "PafFormatError"
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(
        "Got an unexpected character in paf cigar string: ")


@pytest.mark.parametrize("seed,raw", [(12, False), (13, False), (14, True)],
                         ids=["parsed", "parsed-2", "raw"])
def test_serialize_paf_equals_paffy_tpus(seed, raw):
    t, r = both_tables(seed, raw)
    got = pt.pafio.serialize_paf(t)
    assert type(got) is str
    assert got == ref_pafio.serialize_paf(r)
    assert got.count("\n") == len(t) and got.startswith(paf_text(seed)[:4])
    assert pt.pafio.serialize_paf(pt.PafTable.empty()) == ""


@pytest.mark.parametrize("how", ["path", "file object"])
def test_read_and_write_paf_file_equal_paffy_tpus(tmp_path, how):
    text = paf_text(15)
    src = tmp_path / "in.paf"
    src.write_text(text)
    tables = []
    for mod in (pt.pafio, ref_pafio):
        if how == "path":
            tables.append(mod.read_paf_file(str(src)))
        else:
            with open(src) as fh:
                tables.append(mod.read_paf_file(fh))
    assert_same_table(*tables)
    outs = []
    for tag, mod, t in (("port", pt.pafio, tables[0]),
                        ("ref", ref_pafio, tables[1])):
        if how == "path":
            mod.write_paf_file(t, str(tmp_path / f"{tag}.paf"))
            outs.append((tmp_path / f"{tag}.paf").read_bytes())
        else:
            buf = io.StringIO()
            mod.write_paf_file(t, buf)
            outs.append(buf.getvalue().encode())
    assert outs[0] == outs[1]
    assert outs[0].decode() == pt.pafio.serialize_paf(tables[0])


IUPAC = "ACGTMRWSYKVHDBNXacgtmrwsykvhdbnx"


@pytest.mark.parametrize("s", ["".join(map(chr, range(256))), IUPAC,
                               "".join(np.random.default_rng(16).choice(
                                   list(IUPAC + "-.*"), 3000))],
                         ids=["every-byte", "iupac", "seeded"])
def test_reverse_complement_equals_paffy_tpus(s):
    got = pt.fasta.reverse_complement(s)
    assert got == ref_fasta.reverse_complement(s)
    assert pt.fasta.reverse_complement(got) == s


def test_reverse_complement_char_and_tables_on_every_byte():
    for i in range(256):
        c = chr(i)
        assert pt.fasta.reverse_complement_char(c) == \
            ref_fasta.reverse_complement_char(c)
        assert pt.fasta.COMPLEMENT_TABLE[i] == \
            ord(pt.fasta.reverse_complement_char(c))
    assert pt.fasta.reverse_complement_char("R") == "Y"
    assert bytes(pt.fasta.UPPER_TABLE[np.frombuffer(b"acgtNx", np.uint8)]) \
        == b"ACGTNX"


@pytest.mark.parametrize("newline,width", [("\n", 60), ("\r\n", 7)],
                         ids=["lf-60", "crlf-7"])
def test_load_sequences_later_files_win(tmp_path, newline, width):
    rng = np.random.default_rng(17)

    def seq(n):
        return "".join(rng.choice(list("ACGTNacgt"), n))
    files = [{"a": seq(130), "dup": seq(90), "b": seq(5)},
             {"c": seq(61), "dup": seq(44)}]
    paths = []
    for i, recs in enumerate(files):
        p = tmp_path / f"f{i}.fa"
        with open(p, "w", newline="") as fh:
            for name, s in recs.items():
                fh.write(f">{name}  {newline}")
                for j in range(0, len(s), width):
                    fh.write(s[j: j + width] + newline)
                fh.write(newline)
        paths.append(str(p))
    got = pt.fasta.load_sequences(paths)
    want = ref_fasta.load_sequences(paths)
    assert list(got.items()) == list(want.items())
    assert got["dup"] == files[1]["dup"] and list(got) == ["a", "dup", "b",
                                                           "c"]


@pytest.mark.parametrize("s", ["", "ACGTNacgtn" * 7, "".join(map(
    chr, np.random.default_rng(18).integers(0, 256, 500)))],
    ids=["empty", "bases", "seeded-latin-1"])
def test_seq_to_bytes_equals_paffy_tpus(s):
    got, want = pt.fasta.seq_to_bytes(s), ref_fasta.seq_to_bytes(s)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.fixture(scope="module")
def workload_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("library_flush")
    seqs, lines = make_workload(seed=19)
    with open(d / "seqs.fa", "w") as fh:
        for name, s in seqs.items():
            fh.write(f">{name}\n{s}\n")
    (d / "in.paf").write_text("\n".join(lines) + "\n")
    return d


@pytest.mark.parametrize("argv", [
    ["view", "-s"], ["view", "-s", "-u", "0.9999"], ["add_mismatches"],
    ["to_bed"]], ids=["view", "view-u-fails", "add_mismatches", "to_bed"])
def test_flush_keeps_bytes_and_exit_code(workload_files, tmp_path,
                                         monkeypatch, argv):
    """Every write followed by flush() on both writers gives the bytes and
    exit code of a run without, and of paffy_tpu's run."""
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")
    d = workload_files
    fa = [] if argv[0] == "to_bed" else [str(d / "seqs.fa")]

    def run(main, tag):
        out = tmp_path / f"{tag}.out"
        rc = main([*argv, "-i", str(d / "in.paf"), *fa, "-o", str(out)])
        return rc, out.read_bytes()
    plain = run(port_main, "plain")
    want = run(ref_main, "ref")
    flushes = []
    for cls in (common.GlibcWriter, common._TextGlibcFacade):
        write = cls.write

        def flushing(self, data, write=write):
            n = write(self, data)
            self.flush()
            flushes.append(type(self).__name__)
            return n
        monkeypatch.setattr(cls, "write", flushing)
    flushed = run(port_main, "flushed")
    assert flushed == plain == want
    assert "GlibcWriter" in flushes
    assert ("_TextGlibcFacade" in flushes) == (argv[0] != "add_mismatches")
    assert (plain[0] == 0) == (argv[-1] != "0.9999")


@pytest.mark.parametrize("sizes", [[10], [4000, 200], [4096, 1, 9000]],
                         ids=["under-a-block", "across-a-block", "blocks"])
def test_flush_stages_the_tail_as_paffy_tpus(sizes):
    """flush() writes nothing through: the sub-block tail stays staged
    until close, in both packages' writers."""
    seen = []
    for mod in (common, ref_common):
        buf = io.BytesIO()
        w = mod._TextGlibcFacade(mod.GlibcWriter(buf, owns=False))
        after = []
        for i, n in enumerate(sizes):
            w.write("ACGT"[i] * n)
            assert w.flush() is None and w._w.flush() is None
            after.append(len(buf.getvalue()))
        w.close()
        seen.append((after, buf.getvalue()))
    assert seen[0] == seen[1]
    assert seen[0][0][-1] == sum(sizes) // 4096 * 4096


_IMPORT_CHECK = """
import sys
import paffy_tpu_torch as pt
assert not [m for m in sys.modules if m.startswith("paffy_tpu_torch.")]
from paffy_tpu_torch.core import fasta, model, pafio
assert pt.PafTable is model.PafTable
assert pt.pafio is pafio and pt.fasta is fasta
t = pt.pafio.parse_paf_text("q\\t9\\t0\\t9\\t+\\tt\\t9\\t0\\t9\\t9\\t9\\t60"
                            "\\tcg:Z:9M\\n")
assert pt.pafio.serialize_paf(t).endswith("cg:Z:9M\\n")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("torch", "jax", "jaxlib", "paffy_tpu"))
assert not loaded, loaded
print("ok")
"""


@pytest.mark.parametrize("env", [{}, {
    "PAFFY_TPU_COORDINATOR": "localhost:1", "PAFFY_TPU_NUM_PROCESSES": "2",
    "PAFFY_TPU_PROCESS_ID": "1"}], ids=["plain", "multi-process-variables"])
def test_import_loads_no_torch_jax_or_paffy_tpu(env):
    """A fresh interpreter imports the package (which loads none of its
    modules until an export is used) and uses its exports without loading
    torch, JAX or paffy_tpu; with the multi-process variables set
    (which paffy_tpu's import acts on) it starts no process group either:
    no torch.distributed, and no wait for the other process."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO,
                       env=dict(os.environ, **env), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_exports_are_the_core_modules():
    from paffy_tpu_torch.core import fasta, pafio
    assert pt.PafTable is model.PafTable
    assert pt.pafio is pafio and pt.fasta is fasta
    assert sorted(pt.__all__) == ["PafTable", "fasta", "pafio"]
    with pytest.raises(AttributeError, match="no attribute 'nothing'"):
        pt.nothing


def test_smoke_library_phase_equals_paffy_tpus(tmp_path, monkeypatch):
    """chip_smoke.library_phase at a small size on the CPU: the counts,
    the encoded file and the pipeline's text of the port's library path
    are paffy_tpu's through its own library surface."""
    import chip_smoke
    from paffy_tpu.ops.mismatch import (SequencePool, column_match_counts,
                                        encode_mismatches)
    from paffy_tpu.ops.transforms import shatter
    from paffy_tpu.parallel.runner import pipeline_stage
    from test_torch_host import SMALL, smoke_files
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")
    fa, paf, w = smoke_files(tmp_path / "in", True, **SMALL)
    got, walls, launches = chip_smoke.library_phase(paf, fa, str(tmp_path))
    assert got["device"] == "cpu" and set(walls) == set(launches)
    t = ref_pafio.read_paf_file(paf)
    pool = SequencePool(ref_fasta.load_sequences([fa]))
    m, x = column_match_counts(t, pool)
    assert got["matches"].tolist() == m.tolist()
    assert got["mismatches"].tolist() == x.tolist()
    ref_pafio.write_paf_file(encode_mismatches(t, pool), tmp_path / "r.paf")
    with open(got["add_mismatches"], "rb") as fh:
        assert fh.read() == (tmp_path / "r.paf").read_bytes()
    assert got["pipeline"] == ref_pafio.serialize_paf(
        pipeline_stage(shatter(t), pool))
    n = len(w["runs"])
    assert got["shattered"] == {
        "records": n, "ops": n, "ops per record": [1],
        "names": ["q_chr", "t_chr"], "query ids": [0], "target ids": [1],
        "last record's ops": ([0], [int(w["runs"][-1])])}


def test_smoke_render_input_is_cut_into_slices(tmp_path, monkeypatch):
    """chip_smoke.render_input's records, rendered by the port's view -a in
    slices of a small size (as the card's run cuts them at 64 MiB): more
    slices than the bound's multiple, and paffy_tpu's bytes."""
    import chip_smoke
    from paffy_tpu_torch import native
    from paffy_tpu_torch.commands import view
    from test_torch_host import SMALL, smoke_files
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")
    fa, paf, _ = smoke_files(tmp_path / "in", True, **SMALL)
    slice_bytes = 200_000
    data = chip_smoke.render_input(open(paf, "rb").read(), 2 * slice_bytes)
    lines = data.splitlines(keepends=True)
    assert data == b"".join(open(paf, "rb").readlines()[:len(lines)])
    rpaf = tmp_path / "render.paf"
    rpaf.write_bytes(data)
    monkeypatch.setattr(view._render_sliced, "__defaults__", (slice_bytes,))
    sliced, render = [], native.view_render_batch
    monkeypatch.setattr(native, "view_render_batch",
                        lambda sl, *a: sliced.append(len(sl)) or render(sl,
                                                                        *a))
    outs = []
    for tag, main in (("port", port_main), ("ref", ref_main)):
        o = tmp_path / f"{tag}.txt"
        assert main(["view", "-a", "-i", str(rpaf), fa, "-o", str(o)]) == 0
        outs.append(o.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 2 * slice_bytes
    assert len(sliced) >= 3 and sum(sliced) == len(lines)
    with pytest.raises(ValueError):
        chip_smoke.render_input(data, 10**12)


@pytest.mark.parametrize("min_bytes", [0, 999, 10_000])
def test_smoke_repeat_lines(tmp_path, min_bytes):
    import chip_smoke
    src = tmp_path / "src.paf"
    src.write_text(paf_text(20, n=5))
    dst = tmp_path / "dst.paf"
    copies = chip_smoke.repeat_lines(str(src), str(dst), min_bytes)
    size = src.stat().st_size
    assert dst.read_bytes() == src.read_bytes() * copies
    assert copies * size > min_bytes >= (copies - 1) * size
