"""The host-only paffy commands of paffy_tpu_torch against paffy_tpu's, on
the CPU: ``invert``, ``shatter``, ``dedupe``, ``filter``, ``to_bed``,
``dechunk``, ``upconvert`` and ``split_file``.  Each case runs both
packages' ``paffy_main`` in process on the same seeded inputs
(tests/synthdata.make_workload, and chip_smoke.build_files at a small
size) and compares the exit code or the exception (its type and message,
the last line of the traceback on stderr), every byte written to the
output, stdout and stderr, and, for split_file, every file and its name.
The streaming commands run at the default batch size and with batches of
a few kilobytes, so records, duplicates and contigs span batches.

Failures: a bad record in the middle of a batch (the records before it are
written), shatter's assert against its shard check (the stdio tail lost or
flushed), ``dedupe -a``'s inverse twins across batches and its paf_check
of exactly the records whose direct probe missed, to_bed's walk asserts,
upconvert's fragment crossing, split_file's bin packing.  Also the command
line (every command listed, unknown names) and the profiler hook."""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from paffy_tpu import native as ref_native
from paffy_tpu.cli import faffy_main as ref_faffy
from paffy_tpu.cli import paffy_main as ref_main
from paffy_tpu.commands import common as ref_common
from paffy_tpu.utils import logging as ref_logging
from paffy_tpu_torch.cli import faffy_main as port_faffy
from paffy_tpu_torch.cli import paffy_main as port_main
from paffy_tpu_torch.commands import common
from paffy_tpu_torch.utils import logging as port_logging
from ref_native import paffy_tpu_lib  # noqa: F401
from synthdata import make_workload

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(seq_len=400_000, n_records=12, m_columns=300_000)
BATCHES = [None, 3000]     # the default (256 MB), and a few kilobytes
UPCONVERTED = {"in.paf": "up.paf", "sm.paf": "sm_up.paf"}   # see work


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


def edit(rows, i, fn):
    rows = list(rows)
    rows[i] = fn(rows[i])
    return rows


def field(k, fn):
    """A row edit that replaces tab field ``k`` by fn(its value)."""
    def apply(row):
        f = row.split("\t")
        f[k] = str(fn(f[k]))
        return "\t".join(f)
    return apply


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Inputs of every case, written by paffy_tpu where a command makes
    them: a workload (in.paf, s.fa), its add_mismatches and tile outputs,
    chip_smoke's synthesis at a small size (sm.paf, sm.fa) with its
    chain_input (sm_chain.paf) and that file followed by its inversion
    (twins.paf), upconverted records on extracted fragments, and the
    failing variants."""
    d = tmp_path_factory.mktemp("torch_commands")
    seqs, lines = make_workload(seed=11, length=30000, n_windows=40,
                                window=2500, step=700)
    # a few exact duplicates, so dedupe has work without -a
    lines = lines + lines[3:9]
    (d / "in.paf").write_text("\n".join(lines) + "\n")
    (d / "s.fa").write_text("".join(f">{k}\n{v}\n" for k, v in seqs.items()))

    def ref(*argv):
        assert ref_main(list(argv)) == 0

    ref("add_mismatches", "-i", str(d / "in.paf"), str(d / "s.fa"), "-o",
        str(d / "am.paf"))
    ref("tile", "-i", str(d / "am.paf"), "-o", str(d / "tile.paf"))
    (d / "smoke").mkdir()
    fa, paf, w = chip_smoke.build_files(str(d / "smoke"), ref_native, **SMALL)
    os.replace(fa, d / "sm.fa")
    os.replace(paf, d / "sm.paf")
    (d / "sm_chain.paf").write_bytes(
        chip_smoke.chain_input(w, seq_len=SMALL["seq_len"]))
    ref("invert", "-i", str(d / "sm_chain.paf"), "-o", str(d / "inv.paf"))
    (d / "twins.paf").write_bytes((d / "sm_chain.paf").read_bytes()
                                  + (d / "inv.paf").read_bytes())
    ref("add_mismatches", "-i", str(d / "sm.paf"), str(d / "sm.fa"), "-o",
        str(d / "sm_am.paf"))
    (d / "sm_tile.paf").write_bytes(
        chip_smoke.tile_input((d / "sm_am.paf").read_bytes()))
    # extract's fragments of each record's intervals, and the records
    # upconverted onto them (the workload's overlapping records coalesce
    # into one fragment per sequence, the smoke records do not)
    for paf, fa, stem in (("in.paf", "s.fa", ""), ("sm.paf", "sm.fa", "sm_")):
        bed = d / f"{stem}rec.bed"
        bed.write_text(chip_smoke.record_bed((d / paf).read_bytes()))
        assert ref_faffy(["extract", "-i", str(bed), str(d / fa), "-o",
                          str(d / f"{stem}frag.fa")]) == 0
        ref("upconvert", "-i", str(d / paf), str(d / f"{stem}frag.fa"), "-o",
            str(d / f"{stem}up.paf"))

    paf_rows = (d / "in.paf").read_text().splitlines()
    am_rows = (d / "am.paf").read_text().splitlines()
    tile_rows = (d / "tile.paf").read_text().splitlines()
    mid = len(paf_rows) // 2
    variants = {
        # bounds: qend past qlen, in the middle
        "bad_bounds.paf": edit(paf_rows, mid, field(3, lambda v: 10**9)),
        # a cigar whose query span is one short of qend - qstart
        "bad_span.paf": edit(paf_rows, mid, field(3, lambda v: int(v) + 1)),
        # a cigar length with a leading zero: the raw reader hands the
        # batch to the full parser
        "noncanon.paf": edit(paf_rows, 2,
                             lambda r: r.replace("cg:Z:", "cg:Z:0", 1)),
        # a record of fewer than 12 fields: the reference's SIGSEGV
        "short.paf": edit(paf_rows, mid, lambda r: "\t".join(
            r.split("\t")[:7])),
        # shatter: an =/X op (an assert), a zero-length op (an assert), a
        # walk that misses qend (an assert), a shard past qlen (a check)
        "shatter_eq.paf": paf_rows[:mid] + [am_rows[mid]] + paf_rows[mid:],
        "shatter_zero.paf": edit(paf_rows, mid, lambda r: r.replace(
            "cg:Z:", "cg:Z:0I", 1)),
        "shatter_walk.paf": edit(paf_rows, mid, field(3, lambda v:
                                                      int(v) - 1)),
        "shatter_check.paf": edit(paf_rows, mid, field(
            1, lambda v: int(paf_rows[mid].split("\t")[3]) - 1)),
        # to_bed: a query walk past qend, and, with -n, a target walk past
        # tend (the inverted record's query walk)
        "walk_q.paf": edit(tile_rows, len(tile_rows) // 2,
                           field(3, lambda v: int(v) - 1)),
        "walk_t.paf": edit(tile_rows, len(tile_rows) // 2,
                           field(8, lambda v: int(v) - 1)),
        # dedupe -a: the first copy of an out-of-bounds record is checked
        # (its direct probe misses), after the duplicates before it
        "dup_bad.paf": paf_rows + [edit(paf_rows, 4, field(
            3, lambda v: 10**9))[4]] * 2 + paf_rows[:5],
    }
    # upconvert: a record that starts in a fragment and ends past it (the
    # smoke record with the widest gap after it on the query, 50 longer)
    sm_rows = (d / "sm.paf").read_text().splitlines()
    qs = np.array([int(r.split("\t")[2]) for r in sm_rows])
    qe = np.array([int(r.split("\t")[3]) for r in sm_rows])
    order = np.argsort(qs)
    widest = int(order[np.argmax(qs[order][1:] - qe[order][:-1])])
    variants["cross.paf"] = edit(sm_rows, widest,
                                 field(3, lambda v: int(v) + 50))
    for name, rows in variants.items():
        (d / name).write_text("\n".join(rows) + "\n")
    # upconverted records with a bad span, for dechunk's span check
    up_rows = (d / "up.paf").read_text().splitlines()
    (d / "up_bad.paf").write_text("\n".join(edit(
        up_rows, len(up_rows) // 2, field(3, lambda v: int(v) + 1))) + "\n")
    return d


@contextlib.contextmanager
def captured():
    """stdout (bytes) and stderr of both packages, their loggers' lines
    included."""
    out = io.TextIOWrapper(io.BytesIO(), encoding="latin-1",
                           write_through=True)
    err = io.StringIO()
    handlers = (ref_logging._handler, port_logging._handler)
    old = [h.setStream(err) for h in handlers]
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            yield out, err
    finally:
        for h, s in zip(handlers, old):
            h.setStream(s)


def run_one(main, argv):
    """(rc or "Type: message", stdout bytes, stderr) of one command."""
    with captured() as (out, err):
        try:
            res = main(argv)
        except Exception as e:           # the command's own failure
            res = f"{type(e).__name__}: {e}"
    return res, out.buffer.getvalue(), err.getvalue()


def both(tmp_path, argv, out=True, mains=(ref_main, port_main)):
    """paffy_tpu's and the port's (result, output file, stdout, stderr);
    ``argv`` may hold "{d}", replaced by each run's own directory (files
    the command writes), which is then named "{d}" in their outputs."""
    res = []
    for tag, main in zip(("ref", "port"), mains):
        d = tmp_path / tag
        d.mkdir()
        args = [a.replace("{d}", str(d)) for a in argv]
        o = d / "out"
        if out:
            args += ["-o", str(o)]
        rc, stdout, stderr = run_one(main, args)
        files = {str(p.relative_to(d)): p.read_bytes()
                 for p in sorted(d.rglob("*")) if p.is_file()}
        res.append((rc, files, stdout.replace(str(d).encode(), b"{d}"),
                    stderr.replace(str(d), "{d}")))
    return res


@pytest.fixture
def batch(request, monkeypatch):
    """Both packages' streaming batch size."""
    if request.param is not None:
        monkeypatch.setattr(ref_common, "BATCH_BYTES", request.param)
        monkeypatch.setattr(common, "BATCH_BYTES", request.param)
    return request.param


def check(ref, port, rc=0):
    assert port == ref
    assert ref[0] == rc if isinstance(rc, int) else ref[0].startswith(rc)


# ------------------------------------------------------------------- invert

@pytest.mark.parametrize("batch", BATCHES, indirect=True)
@pytest.mark.parametrize("paf,rc", [
    ("in.paf", 0), ("am.paf", 0), ("sm_chain.paf", 0), ("noncanon.paf", 0),
    ("bad_bounds.paf", "PafCheckError: Paf query end"),
    ("bad_span.paf", "PafCheckError: Paf cigar alignment does not match"),
    ("short.paf", "PafFormatError")])
def test_invert_matches_paffy_tpu(work, tmp_path, batch, paf, rc):
    ref, port = both(tmp_path, ["invert", "-i", str(work / paf)])
    check(ref, port, rc)
    if rc != 0 and rc.startswith("PafCheckError"):
        # the inverted records before the bad one were written
        assert ref[1]["out"]


# ------------------------------------------------------------------ shatter

@pytest.mark.parametrize("batch", BATCHES, indirect=True)
@pytest.mark.parametrize("paf,rc", [
    ("in.paf", 0), ("sm.paf", 0), ("sm_chain.paf", 0),
    ("shatter_eq.paf", "PafCheckError: shatter: invalid record"),
    ("shatter_zero.paf", "PafCheckError: shatter: invalid record"),
    ("shatter_walk.paf", "PafCheckError: shatter: invalid record"),
    ("shatter_check.paf", "PafCheckError: shatter: invalid record")])
def test_shatter_matches_paffy_tpu(work, tmp_path, batch, paf, rc):
    ref, port = both(tmp_path, ["shatter", "-i", str(work / paf)])
    check(ref, port, rc)
    if paf == "sm.paf":
        assert ref[1]["out"] == (work / "sm_chain.paf").read_bytes()
    if rc != 0:
        written = len(ref[1]["out"])
        assert written > 4096
        # an assert loses the sub-block tail; a shard check flushes it
        assert (written % 4096 == 0) == (paf != "shatter_check.paf")


# ------------------------------------------------------------------- dedupe

@pytest.mark.parametrize("batch", BATCHES, indirect=True)
@pytest.mark.parametrize("flags", [[], ["-a"], ["-a", "-l", "debug"]],
                         ids=["plain", "a", "a-debug"])
@pytest.mark.parametrize("paf", ["in.paf", "twins.paf", "dup_bad.paf"])
def test_dedupe_matches_paffy_tpu(work, tmp_path, batch, flags, paf):
    ref, port = both(tmp_path, ["dedupe", "-i", str(work / paf), *flags])
    bad = paf == "dup_bad.paf" and "-a" in flags
    check(ref, port, "PafCheckError: Paf query end" if bad else 0)
    out = ref[1]["out"]
    if paf == "twins.paf" and not bad:
        # -a drops every inverse twin: the file's first half remains
        chain = (work / "sm_chain.paf").read_bytes()
        assert out == (chain if "-a" in flags
                       else (work / "twins.paf").read_bytes())
    if "debug" in flags and paf == "in.paf":
        assert "Got duplicate pafs:" in ref[3]


# ------------------------------------------------------------------- filter

@pytest.mark.parametrize("batch", BATCHES, indirect=True)
@pytest.mark.parametrize("flags", [
    ["-w", "1"], ["-u", "0.97"], ["-u", "0.97", "-x"], ["-v", "0.9"],
    ["-t", "2000", "-s", "-1"], ["-w", "2", "-l", "debug"]],
    ids=["w", "u", "u-x", "v", "t-s", "w-debug"])
@pytest.mark.parametrize("paf", ["tile.paf", "am.paf"])
def test_filter_matches_paffy_tpu(work, tmp_path, batch, flags, paf):
    ref, port = both(tmp_path, ["filter", "-i", str(work / paf), *flags])
    check(ref, port)
    if "debug" in flags and paf == "tile.paf":
        assert "Filtering alignment with matches:" in ref[3]


@pytest.mark.parametrize("paf,rc", [("noncanon.paf", 0),
                                    ("short.paf", "PafFormatError")])
def test_filter_of_odd_input_matches_paffy_tpu(work, tmp_path, paf, rc):
    ref, port = both(tmp_path, ["filter", "-i", str(work / paf), "-u",
                                "0.5"])
    check(ref, port, rc)


# ------------------------------------------------------------------- to_bed

@pytest.mark.parametrize("batch", BATCHES, indirect=True)
@pytest.mark.parametrize("flags", [
    [], ["-b"], ["-b", "-n"], ["-n"], ["-e", "-m", "100"], ["-f"],
    ["-f", "-q", "{fa}"]],
    ids=["plain", "b", "b-n", "n", "e-m", "f", "f-q"])
@pytest.mark.parametrize("paf,fa", [("tile.paf", "s.fa"),
                                    ("sm_tile.paf", "sm.fa")],
                         ids=["workload", "smoke"])
def test_to_bed_matches_paffy_tpu(work, tmp_path, batch, flags, paf, fa):
    flags = [f.replace("{fa}", str(work / fa)) for f in flags]
    ref, port = both(tmp_path, ["to_bed", "-i", str(work / paf), *flags])
    check(ref, port)
    assert ref[1]["out"].count(b"\n") > 3


@pytest.mark.parametrize("paf,flags", [
    ("walk_q.paf", []), ("walk_t.paf", ["-n"]), ("walk_t.paf", [])],
    ids=["query-walk", "target-walk-n", "target-walk-ignored"])
def test_to_bed_walk_asserts_match_paffy_tpu(work, tmp_path, paf, flags):
    ref, port = both(tmp_path, ["to_bed", "-i", str(work / paf), *flags])
    fails = paf == "walk_q.paf" or bool(flags)
    check(ref, port, "PafCheckError: to_bed: invalid" if fails else 0)
    if fails:       # the asserts come before write_bed opens the output
        assert "out" not in ref[1]


# ------------------------------------------------- dechunk and upconvert

@pytest.mark.parametrize("batch", BATCHES, indirect=True)
@pytest.mark.parametrize("flags", [[], ["-q"], ["-t"]])
@pytest.mark.parametrize("paf", ["up.paf", "sm_up.paf", "up_bad.paf",
                                 "in.paf"])
def test_dechunk_matches_paffy_tpu(work, tmp_path, batch, flags, paf):
    ref, port = both(tmp_path, ["dechunk", "-i", str(work / paf), *flags])
    if paf == "in.paf":      # names without |length|start: an error
        check(ref, port, "ValueError: fasta header lacks")
        return
    check(ref, port, "PafCheckError" if paf == "up_bad.paf" else 0)
    if not flags and paf in UPCONVERTED.values():
        # upconvert then dechunk gives the records back
        src = next(k for k, v in UPCONVERTED.items() if v == paf)
        assert ref[1]["out"] == (work / src).read_bytes()


@pytest.mark.parametrize("line,flags", [
    (b"n|20x|5\t15\t0\t10\t+\tt|30|2\t28\t0\t10\t10\t10\t60\tcg:Z:10M\n", []),
    (b"a|b|100| 7\t15\t0\t10\t-\tt|30|+2\t28\t0\t10\t10\t10\t60\n", ["-q"]),
    (b"n|20|x\t15\t0\t10\t+\tt\t28\t0\t10\t10\t10\t60\n", ["-q"]),
], ids=["trailing-junk", "signs-spaces", "no-digits"])
def test_dechunk_header_fields_match_paffy_tpu(tmp_path, line, flags):
    # decode_fasta_header's sscanf semantics (tests/test_parity_corners.py)
    (tmp_path / "in.paf").write_bytes(line)
    ref, port = both(tmp_path, ["dechunk", "-i", str(tmp_path / "in.paf"),
                                *flags])
    check(ref, port, "ValueError" if b"|x" in line else 0)


@pytest.mark.parametrize("batch", BATCHES, indirect=True)
@pytest.mark.parametrize("paf,frag,rc", [
    ("in.paf", "frag.fa", 0), ("sm.paf", "sm_frag.fa", 0),
    ("noncanon.paf", "frag.fa", 0),
    ("cross.paf", "sm_frag.fa", "PafCheckError: alignment crosses"),
    ("bad_bounds.paf", "frag.fa", "PafCheckError")])
def test_upconvert_matches_paffy_tpu(work, tmp_path, batch, paf, frag, rc):
    ref, port = both(tmp_path, ["upconvert", "-i", str(work / paf),
                                str(work / frag)])
    check(ref, port, rc)
    if paf in UPCONVERTED:
        assert ref[1]["out"] == (work / UPCONVERTED[paf]).read_bytes()


# --------------------------------------------------------------- split_file

@pytest.mark.parametrize("batch", BATCHES, indirect=True)
@pytest.mark.parametrize("flags", [
    [], ["-q"], ["-q", "-m", "500000"], ["-m", "1000000"], ["-m", "20000"],
    ["-q", "-m", "1", "-l", "info"]],
    ids=["target", "query", "q-m-packs", "m-all-small", "m-some", "q-m1-info"])
@pytest.mark.parametrize("paf", ["in.paf", "twins.paf"])
def test_split_file_matches_paffy_tpu(work, tmp_path, batch, flags, paf):
    ref, port = both(tmp_path, ["split_file", "-i", str(work / paf), "-p",
                                "{d}/part_", *flags], out=False)
    check(ref, port)
    files = ref[1]
    assert files and b"".join(files.values()).count(b"\n") == (
        work / paf).read_bytes().count(b"\n")
    if flags[:3] == ["-q", "-m", "500000"] and paf == "twins.paf":
        # two contigs of 400,000 bases: each opens its own small file
        assert sorted(files) == ["part_small_0.paf", "part_small_1.paf"]


def test_split_file_short_record_matches_paffy_tpu(work, tmp_path):
    ref, port = both(tmp_path, ["split_file", "-i", str(work / "short.paf"),
                                "-p", "{d}/part_"], out=False)
    check(ref, port, "PafFormatError")
    assert ref[1]     # the records before it were written


# ------------------------------------------------------------ command line

def cli(package, main, argv):
    """(exit code, stdout, stderr) of ``package``'s cli ``main`` in a
    fresh interpreter, as the launchers run it (the usage text goes to the
    stderr of the process)."""
    code = (f"import sys\nfrom {package}.cli import {main}\n"
            f"sys.exit({main}(sys.argv[1:]))\n")
    r = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO,
                       env=dict(os.environ, PAFFY_TPU_PLATFORM="cpu"),
                       capture_output=True, timeout=300)
    return r.returncode, r.stdout, r.stderr


@pytest.mark.parametrize("argv", [[], ["no_such_command"], ["chunk"],
                                  ["dedupe", "-h"]],
                         ids=["usage", "unknown", "faffy-name", "help"])
def test_paffy_command_line_matches_paffy_tpu(argv):
    ref = cli("paffy_tpu", "paffy_main", argv)
    assert cli("paffy_tpu_torch", "paffy_main", argv) == ref
    if argv[:1] in (["no_such_command"], ["chunk"]):
        assert ref[0] == 1
        assert ref[2].startswith(f"{argv[0]} is not a valid paffy "
                                 f"command\n".encode())
    if not argv:
        assert ref[0] == 0
        for cmd in ("dechunk", "dedupe", "filter", "invert", "shatter",
                    "to_bed", "upconvert", "split_file"):
            assert f"    {cmd} ".encode() in ref[2]


@pytest.mark.parametrize("argv", [[], ["view"], ["extract", "-h"]],
                         ids=["usage", "unknown", "help"])
def test_faffy_command_line_matches_paffy_tpu(argv):
    ref = cli("paffy_tpu", "faffy_main", argv)
    assert cli("paffy_tpu_torch", "faffy_main", argv) == ref
    if argv == ["view"]:
        assert ref[0] == 1
        assert ref[2].startswith(b"view is not a valid faffy command\n")


# ------------------------------------------------------------ the profiler

@pytest.mark.parametrize("argv", [
    ["view", "-i", "{in}", "-s", "{fa}"], ["shatter", "-i", "{in}"],
    ["to_bed", "-b", "-i", "{tile}"]], ids=["view-s", "shatter", "to_bed"])
def test_profiler_hook_writes_a_trace_and_the_same_bytes(work, tmp_path,
                                                         monkeypatch, argv):
    argv = [a.format_map({"in": str(work / "in.paf"), "fa": str(work / "s.fa"),
                          "tile": str(work / "tile.paf")})
            if a.startswith("{") else a for a in argv]
    plain, traced = tmp_path / "plain.out", tmp_path / "traced.out"
    assert port_main([*argv, "-o", str(plain)]) == 0
    trace_dir = tmp_path / "traces"
    monkeypatch.setenv("PAFFY_TPU_PROFILE", str(trace_dir))
    assert port_main([*argv, "-o", str(traced), "-l", "info"]) == 0
    assert traced.read_bytes() == plain.read_bytes()
    traces = list(trace_dir.iterdir())
    assert len(traces) == 1
    assert traces[0].name.endswith(f".{os.getpid()}.pt.trace.json")
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_profiler_is_not_started_without_the_variable(work, tmp_path,
                                                     monkeypatch):
    def fail():
        raise AssertionError("the profiler was started")
    monkeypatch.setattr(port_logging, "_start_profiler", fail)
    monkeypatch.delenv("PAFFY_TPU_PROFILE", raising=False)
    for argv in (["shatter", "-i", str(work / "in.paf")],
                 ["view", "-i", str(work / "in.paf"), "-s",
                  str(work / "s.fa")]):
        assert port_main([*argv, "-o", str(tmp_path / "o")]) == 0
