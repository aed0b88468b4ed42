"""faffy ``chunk``, ``merge`` and ``extract`` of paffy_tpu_torch against
paffy_tpu's, on the CPU, through both packages' ``faffy_main`` in process
(the harness of tests/test_torch_commands.py): the same exit code or
exception, the same bytes in every file written and on stdout (chunk's
listing, its directory written as "{d}"), the same stderr.

Inputs: tests/synthdata.make_workload's sequences, chip_smoke.build_files'
at a small size (soft-masked, with runs of N), and sequences wrapped at
60 columns.  Cases: chunk sizes, overlaps and line widths, its directory
errors (not empty, a file, created), degenerate sizes, a non-ACGTN base
in the middle (the listing's and the open chunk's stdio tails lost);
merge of chunk listings back into the sequences, from a file and from
stdin, at several line widths, and of a listing with a chunk missing;
extract of each record's intervals with flanks and coalescing, -f, -m,
--lineWidth, -n over a missing sequence and its failure without -n, BED
fields read as C's atol reads them, an interval past the sequence's end
(only full stdio blocks written)."""

import contextlib
import io
import os

import pytest

from paffy_tpu import native as ref_native
from paffy_tpu.cli import faffy_main as ref_faffy
from paffy_tpu_torch.cli import faffy_main as port_faffy
from paffy_tpu_torch.core.fasta import read_fasta
from ref_native import paffy_tpu_lib  # noqa: F401
from synthdata import make_workload
from test_torch_commands import SMALL, both, check, run_one

import chip_smoke

FAFFY = (ref_faffy, port_faffy)


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def fw(tmp_path_factory):
    """s.fa and in.paf (a workload), sm.fa and sm.paf (chip_smoke's
    synthesis, small), w.fa (s.fa wrapped at 60), iupac.fa (an R in the
    middle of the second sequence), and chunk listings made by
    paffy_tpu."""
    d = tmp_path_factory.mktemp("torch_fasta")
    seqs, lines = make_workload(seed=5, length=24000, n_windows=20,
                                window=2000, step=900)
    (d / "in.paf").write_text("\n".join(lines) + "\n")
    (d / "s.fa").write_text("".join(f">{k}\n{v}\n" for k, v in seqs.items()))
    (d / "w.fa").write_text("".join(
        f">{k} some description\n" + "".join(
            v[i: i + 60] + "\n" for i in range(0, len(v), 60))
        for k, v in seqs.items()))
    (d / "smoke").mkdir()
    fa, paf, _ = chip_smoke.build_files(str(d / "smoke"), ref_native,
                                        **SMALL)
    os.replace(fa, d / "sm.fa")
    os.replace(paf, d / "sm.paf")
    (d / "iupac.fa").write_text(">s1\n" + "ACGT" * 1500 + "\n>s2\n"
                                + "ACGT" * 2000 + "R" + "ACGT" * 100 + "\n")
    (d / "empty.fa").write_text("")
    for fa, flags in (("s.fa", ["-c", "5000", "-o", "300"]),
                      ("sm.fa", ["-c", "90000", "-o", "1000"])):
        listing = io.TextIOWrapper(io.BytesIO(), encoding="latin-1",
                                   write_through=True)
        with contextlib.redirect_stdout(listing):
            assert ref_faffy(["chunk", "-d", str(d / f"chunks_{fa}"),
                              *flags, str(d / fa)]) == 0
        (d / f"{fa}.list").write_bytes(listing.buffer.getvalue())
    return d


# -------------------------------------------------------------------- chunk

@pytest.mark.parametrize("flags", [
    ["-c", "5000", "-o", "300"], ["-c", "5000", "-o", "0"],
    ["-c", "3000", "-o", "250", "--lineWidth", "60"],
    ["-c", "7", "-o", "3", "--lineWidth", "5"], [],
    ["-c", "4096", "-o", "4095", "-l", "debug"]],
    ids=["c-o", "o0", "linewidth", "tiny", "defaults", "debug"])
@pytest.mark.parametrize("fa", ["s.fa", "w.fa", "sm.fa"])
def test_chunk_matches_paffy_tpu(fw, tmp_path, flags, fa):
    if fa == "sm.fa" and flags[:2] == ["-c", "7"]:
        flags = ["-c", "20000", "-o", "3", "--lineWidth", "77"]
    ref, port = both(tmp_path, ["chunk", "-d", "{d}/chunks", *flags,
                                str(fw / fa)], out=False, mains=FAFFY)
    check(ref, port)
    listing = ref[2].decode().split()
    assert listing and all(p.startswith("{d}/chunks/") for p in listing)
    assert sorted(ref[1]) == sorted(f"chunks/{k}.fa"
                                    for k in range(len(listing)))


@pytest.mark.parametrize("case", ["not-empty", "a-file", "created"])
def test_chunk_directory_cases_match_paffy_tpu(fw, tmp_path, case):
    argv = ["chunk", "-d", "{d}/out", "-c", "5000", "-o", "10",
            str(fw / "s.fa")]
    if case == "created":
        argv[2] = "{d}/new/deeper"
    res = []
    for tag, main in zip(("ref", "port"), FAFFY):
        d = tmp_path / tag
        d.mkdir()
        if case == "not-empty":
            (d / "out").mkdir()
            (d / "out" / "x").write_text("x")
        elif case == "a-file":
            (d / "out").write_text("x")
        rc, stdout, stderr = run_one(main, [a.replace("{d}", str(d))
                                            for a in argv])
        files = {str(p.relative_to(d)): p.read_bytes()
                 for p in sorted(d.rglob("*")) if p.is_file()}
        res.append((rc, files, stdout.replace(str(d).encode(), b"{d}"),
                    stderr.replace(str(d), "{d}")))
    assert res[1] == res[0]
    assert res[0][0] == (0 if case == "created" else 1)
    if case == "created":
        assert "Output directory does not exist" in res[0][3]


@pytest.mark.parametrize("fa,flags,rc", [
    ("iupac.fa", ["-c", "3000", "-o", "100"], "ValueError: non-ACGTN"),
    ("s.fa", ["-c", "8", "-o", "8"], "AssertionError"),
    ("empty.fa", ["-c", "4", "-o", "8"], 0)],
    ids=["non-acgtn", "degenerate", "degenerate-empty"])
def test_chunk_failures_match_paffy_tpu(fw, tmp_path, fa, flags, rc):
    ref, port = both(tmp_path, ["chunk", "-d", "{d}/chunks", *flags,
                                str(fw / fa)], out=False, mains=FAFFY)
    check(ref, port, rc)
    if fa == "iupac.fa":
        # s1's chunks were closed (flushed); the listing on stdout and the
        # open chunk's tail were lost with the abort
        assert ref[1]["chunks/0.fa"].startswith(b">s1|6000|0\n")
        assert len(ref[2]) % 4096 == 0


# -------------------------------------------------------------------- merge

@pytest.mark.parametrize("width", ["0", "60", "7"])
@pytest.mark.parametrize("fa", ["s.fa", "sm.fa"])
def test_merge_matches_paffy_tpu(fw, tmp_path, fa, width):
    ref, port = both(tmp_path, ["merge", "-i", str(fw / f"{fa}.list"),
                                "--lineWidth", width], mains=FAFFY)
    check(ref, port)
    if width == "0":
        # the chunks merged back are the sequences, one line each
        assert read_fasta(io.StringIO(ref[1]["out"].decode())) == \
            read_fasta(str(fw / fa))


def test_merge_from_stdin_matches_paffy_tpu(fw, tmp_path, monkeypatch):
    listing = (fw / "s.fa.list").read_text()
    res = []
    for tag, main in zip(("ref", "port"), FAFFY):
        monkeypatch.setattr("sys.stdin", io.StringIO(listing))
        out = tmp_path / f"{tag}.fa"
        assert main(["merge", "-o", str(out), "-l", "debug"]) == 0
        res.append(out.read_bytes())
    assert res[0] == res[1] and res[0].startswith(b">anc.chr1\n")


def test_merge_of_a_gap_matches_paffy_tpu(fw, tmp_path):
    # a listing with a chunk left out: the next chunk does not overlap
    paths = (fw / "s.fa.list").read_text().split()
    (tmp_path / "gap.list").write_text("\n".join(paths[:1] + paths[2:]) + "\n")
    ref, port = both(tmp_path, ["merge", "-i", str(tmp_path / "gap.list")],
                     mains=FAFFY)
    check(ref, port, "AssertionError")


# ------------------------------------------------------------------ extract

@pytest.mark.parametrize("flags", [
    [], ["-f", "0", "-m", "1"], ["-f", "500"], ["--lineWidth", "50"],
    ["-m", "3000"], ["-l", "info"]],
    ids=["defaults", "f0-m1", "f500", "linewidth", "m-skips", "info"])
@pytest.mark.parametrize("src", ["in", "sm"])
def test_extract_matches_paffy_tpu(fw, tmp_path, flags, src):
    bed = tmp_path / "rec.bed"
    bed.write_text(chip_smoke.record_bed((fw / f"{src}.paf").read_bytes()))
    fa = fw / ("s.fa" if src == "in" else "sm.fa")
    ref, port = both(tmp_path, ["extract", "-i", str(bed), str(fa), *flags],
                     mains=FAFFY)
    check(ref, port)
    if flags != ["-m", "3000"] or src == "sm":
        assert ref[1]["out"].count(b">") >= 2


@pytest.mark.parametrize("case", ["missing", "missing-n", "past-end",
                                  "atol", "stdin"])
def test_extract_edges_match_paffy_tpu(fw, tmp_path, monkeypatch, case):
    rows = [f"anc.chr1\t{k * 1000}\t{k * 1000 + 700}" for k in range(20)]
    flags = ["-f", "0", "-m", "1"]
    if case.startswith("missing"):
        rows.insert(7, "no_such_seq\t0\t500")
        if case == "missing-n":
            flags.append("-n")
    elif case == "past-end":
        rows.append("der.rc0\t100\t999999")
    elif case == "atol":
        rows += ["anc.chr1\t12x\t200", "anc.chr1\tabc\t100",
                 "der.chr1\t+40\t 900"]
    bed = tmp_path / "edge.bed"
    bed.write_text("\n".join(rows) + "\n\n")
    argv = ["extract", str(fw / "s.fa"), *flags]
    if case == "stdin":
        res = []
        for tag, main in zip(("ref", "port"), FAFFY):
            monkeypatch.setattr("sys.stdin", io.StringIO(bed.read_text()))
            out = tmp_path / f"{tag}.fa"
            assert main([*argv, "-o", str(out)]) == 0
            res.append(out.read_bytes())
        assert res[0] == res[1] and res[0].count(b">") == 20
        return
    ref, port = both(tmp_path, [*argv, "-i", str(bed)], mains=FAFFY)
    rc = 1 if case in ("missing", "past-end") else 0
    check(ref, port, rc)
    if case == "missing":
        assert ref[3].startswith("Missing sequence: no_such_seq")
    if case == "past-end":
        # the abort: the intervals before it keep only full stdio blocks
        assert len(ref[1]["out"]) % 4096 == 0 and ref[1]["out"]
