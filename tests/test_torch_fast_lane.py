"""The port's native fast lane: paffy_tpu_torch/native/paffy_fast.cpp, which
the dispatcher bin/paffy-torch execs for dedupe, split_file, invert,
filter, trim, dechunk and shatter.

Three lanes give the same stdout, ``-o`` file and split files, and the same
exit code: the port's binary (through the dispatcher), paffy_tpu's
bin/paffy, and the port's Python lane (``PAFFY_TPU_NO_FAST=1``).  The cases:
the workload and flag variants of tests/test_fast_lane.py (its ``CASES``
without ``chain``, plus ``split_file -q -m``); both error classes on outputs
of more than 4096 bytes (a blank or sub-12-token line loses the
sub-4096-byte tail, a bad strand or a paf_check failure flushes it); stdin
above ``PAFFY_TPU_FAST_MAX_BYTES``, replayed to the Python lane; cigars with
leading zeros, deferred to the Python lane; and a seeded differential over
random records.  What the binary does not model (``-h``, an unknown flag,
``PAFFY_TPU_PROFILE``) lands in the port's Python lane, never paffy_tpu's;
``chain`` and the other device commands reach the device rule through the
dispatcher; and the Python lane of every host command loads no torch.

The port's lanes run with ``PYTHONVERBOSE=1``, so their stderr shows
which Python modules, if any, a run imported.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from paffy_tpu.cli import faffy_main as ref_faffy
from paffy_tpu.cli import paffy_main as ref_main
from paffy_tpu_torch import native
from ref_native import paffy_tpu_lib  # noqa: F401
from test_torch_host import SMALL, smoke_files

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parent.parent
DISPATCHER = str(REPO / "bin" / "paffy-torch")
PAFFY_TPU = str(REPO / "bin" / "paffy")
ENV = {k: v for k, v in os.environ.items()
       if k not in ("PAFFY_TPU_NO_FAST", "PAFFY_TPU_PROFILE",
                    "PAFFY_TPU_FAST_MAX_BYTES", "PYTHONVERBOSE")}
ENV["PAFFY_TPU_PLATFORM"] = "cpu"
FAST_COMMANDS = ("dedupe", "split_file", "invert", "filter", "trim",
                 "dechunk", "shatter")
HOST_ONLY = {
    **{c: "paffy" for c in FAST_COMMANDS}, "to_bed": "paffy",
    "upconvert": "paffy", "chunk": "faffy", "merge": "faffy",
    "extract": "faffy"}
DEVICE_COMMANDS = ("view", "add_mismatches", "tile", "chain")

_PORT_IMPORT = re.compile(rb"^import 'paffy_tpu_torch[.']", re.M)
_PAFFY_TPU_IMPORT = re.compile(rb"^import 'paffy_tpu[.']", re.M)
_TORCH_IMPORT = re.compile(rb"^import 'torch[.']", re.M)


@pytest.fixture(scope="module", autouse=True)
def fast_binary():
    """The fast lane, built and fresh as bin/paffy-torch tests it."""
    binary = native.build_fast()
    assert native.fast_is_fresh(), "the fast lane is older than its sources"
    return binary


def test_build_fast_refreshes_after_a_source_is_touched():
    # a source newer than the binary: the dispatcher takes the Python lane
    # until build_fast, on the Python lane's first use of native, moves the
    # binary (the same sources, the same hash) past it
    src = REPO / "paffy_tpu_torch" / "native" / "paffy_fast.cpp"
    st = src.stat()
    try:
        os.utime(src, (st.st_atime + 2, native.fast_path().stat().st_mtime + 2))
        assert not native.fast_is_fresh()
        assert native.build_fast() == native.fast_path()
        assert native.fast_is_fresh()
    finally:
        os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert native.fast_is_fresh()
    assert os.readlink(native.FAST_LINK) == native.fast_path().name


def _rec(qn="q", ql=100, qs=0, qe=50, st="+", tn="t", tl=200, ts=10, te=60,
         nm=50, nb=50, mq=60, tags="cg:Z:50M"):
    base = (f"{qn}\t{ql}\t{qs}\t{qe}\t{st}\t{tn}\t{tl}\t{ts}\t{te}\t{nm}\t"
            f"{nb}\t{mq}")
    return base + ("\t" + tags if tags else "") + "\n"


# tests/test_fast_lane.py's workload
WORKLOAD = (
    _rec()
    + _rec(qn="a|1|2", tn="b|3|4", tags="cg:Z:20M5I20M5D5M")          # | names
    + _rec(st="-", tags="tp:A:S\tAS:i:77\tcg:Z:10M10I10M10D20M")      # tags
    + _rec(tags="tl:i:3\tcn:i:9\ts1:i:123\tcg:Z:50M")                 # more tags
    + _rec(qn="dotty.chr1.alt", tags="")                              # no cigar
    + _rec(qn="q", tags="cg:Z:50M")                                   # duplicate
    + _rec(qn="t", tn="q", ql=200, tl=100, qs=10, qe=60, ts=0, te=50,
           tags="cg:Z:50M")                                           # inverse dup
    + _rec(qn="z", st="-", qs=5, qe=55, tags="AS:i:0\tcg:Z:25M1X24M") # =X-free M
    + _rec(qn="w", tags="xx:i:1\tcg:Z:50M\tyy:Z:zzz")                 # unknown tags
    + _rec(qn="n|100|0", tn="m|200|0", tags="cg:Z:50M")               # provenance
    + _rec(qn="alli", qe=50, ts=10, te=10, nm=0, tags="cg:Z:50I")     # all-I
    + _rec(qn="alld", qs=0, qe=0, ts=10, te=60, nm=0, tags="cg:Z:50D")  # all-D
).encode()

# tests/test_fast_lane.py's CASES without chain (K6 on the card, never the
# fast lane's)
CASES = [
    ("dedupe", []),
    ("dedupe", ["-a"]),
    ("invert", []),
    ("filter", []),
    ("filter", ["-u", "0.5", "-x"]),
    ("filter", ["-s", "100", "-t", "10", "-w", "2"]),
    ("trim", []),
    ("trim", ["-r", "0.2", "-t", "0.4"]),
    ("shatter", []),
    ("dechunk", []),       # mixed provenance: aborts at first bare name
    ("dechunk", ["-q"]),
]
CASE_IDS = [" ".join([c, *f]) for c, f in CASES]


def _lanes():
    """(name, argv0, extra env) of the three lanes."""
    return (("paffy_tpu", PAFFY_TPU, {}),
            ("fast", DISPATCHER, {"PYTHONVERBOSE": "1"}),
            ("python", DISPATCHER, {"PAFFY_TPU_NO_FAST": "1",
                                    "PYTHONVERBOSE": "1"}))


def run_lanes(cmd, flags, payload, tmp_path, files=False, env=None):
    """Each lane's run of ``cmd flags`` on ``payload``: {lane: (exit code,
    output bytes, stderr)}.  Through stdin and stdout, or with ``files``
    through ``-i`` and ``-o``; split_file's output is its files, by name."""
    out = {}
    for lane, argv0, extra in _lanes():
        d = tmp_path / lane
        d.mkdir()
        argv = [argv0, cmd, *flags]
        stdin = payload
        if cmd == "split_file":
            (d / "in.paf").write_bytes(payload)
            argv += ["-i", str(d / "in.paf"), "-p", str(d / "s_")]
            stdin = None
        elif files:
            (d / "in.paf").write_bytes(payload)
            argv += ["-i", str(d / "in.paf"), "-o", str(d / "out.paf")]
            stdin = None
        r = subprocess.run(argv, input=stdin, capture_output=True,
                           timeout=300, env={**ENV, **(env or {}), **extra})
        if cmd == "split_file":
            got = {p.name: p.read_bytes() for p in sorted(d.glob("s_*"))}
        elif files:
            o = d / "out.paf"
            got = o.read_bytes() if o.exists() else None
        else:
            got = r.stdout
        out[lane] = (r.returncode, got, r.stderr)
    return out


def assert_same(res, fast_ran_python=False):
    """Equal exit codes and bytes in all three lanes; the fast lane ran the
    binary alone, or (``fast_ran_python``) deferred to the port's Python
    lane; the Python lane loaded no torch and nothing of paffy_tpu."""
    codes = {lane: r[0] for lane, r in res.items()}
    assert len(set(codes.values())) == 1, (
        codes, {lane: r[2][-300:] for lane, r in res.items()})
    assert res["fast"][1] == res["paffy_tpu"][1]
    assert res["python"][1] == res["paffy_tpu"][1]
    fast_err, py_err = res["fast"][2], res["python"][2]
    assert bool(_PORT_IMPORT.search(fast_err)) == fast_ran_python
    assert _PORT_IMPORT.search(py_err)
    for err in (fast_err, py_err):
        assert not _PAFFY_TPU_IMPORT.search(err)
        assert not _TORCH_IMPORT.search(err)


@pytest.mark.parametrize("files", [False, True], ids=["stdio", "files"])
@pytest.mark.parametrize("cmd,flags", CASES, ids=CASE_IDS)
def test_three_lanes_agree(tmp_path, cmd, flags, files):
    res = run_lanes(cmd, flags, WORKLOAD, tmp_path, files=files)
    assert_same(res)


def test_split_file_three_lanes_agree(tmp_path):
    res = run_lanes("split_file", ["-q", "-m", "150"], WORKLOAD, tmp_path)
    assert_same(res)
    assert res["fast"][0] == 0 and len(res["fast"][1]) > 1


def big_records(n=200):
    """``n`` valid records, ~80 bytes each, with provenance names (dechunk
    decodes them), so every command's output passes 4096 bytes."""
    return [_rec(qn=f"q{i % 7}|1000|0", ql=1000, qs=i, qe=i + 50,
                 tn="t|2000|0", tl=2000, ts=10 + i, te=60 + i,
                 tags="cg:Z:20M5I20M5D5M") for i in range(n)]


def error_input(kind):
    rows = big_records()
    k = 150
    if kind == "blank":
        rows.insert(k, "\n")
    elif kind == "short":
        rows.insert(k, "a\tb\tc\n")
    elif kind == "strand":
        rows[k] = rows[k].replace("\t+\t", "\t*\t")
    elif kind == "check":                       # qend beyond qlen
        rows[k] = rows[k].replace("\t1000\t150\t200\t", "\t1000\t150\t1200\t")
    return "".join(rows).encode()


ERROR_COMMANDS = [("dedupe", ["-a"]), ("split_file", []), ("invert", []),
                  ("filter", []), ("trim", []), ("dechunk", []),
                  ("shatter", [])]


@pytest.mark.parametrize("kind", ["blank", "short", "strand", "check"])
@pytest.mark.parametrize("cmd,flags", ERROR_COMMANDS,
                         ids=[c for c, _ in ERROR_COMMANDS])
def test_error_classes_agree(tmp_path, cmd, flags, kind):
    res = run_lanes(cmd, flags, error_input(kind), tmp_path)
    assert_same(res)
    rc, out, _ = res["fast"]
    sizes = ([len(v) for v in out.values()] if cmd == "split_file"
             else [len(out)])
    if kind in ("blank", "short"):             # SIGSEGV class: tail lost
        assert rc == 1 and sum(sizes) > 4096
        assert all(s % 4096 == 0 for s in sizes)
    elif kind == "strand" or cmd in ("dedupe", "invert", "trim", "dechunk"):
        assert rc == 1                          # errAbort class: flushed
        assert sum(sizes) > 4096 and any(s % 4096 for s in sizes)
    if kind == "check" and cmd in ("split_file", "filter"):
        assert rc == 0                          # no paf_check in these


@pytest.mark.parametrize("cmd", ["invert", "filter", "trim", "dechunk",
                                 "shatter"])
def test_stdin_above_max_bytes_is_replayed_to_the_python_lane(tmp_path, cmd):
    payload = "".join(big_records()).encode()
    res = run_lanes(cmd, [], payload, tmp_path,
                    env={"PAFFY_TPU_FAST_MAX_BYTES": "64"})
    assert_same(res, fast_ran_python=True)
    assert res["fast"][0] == 0 and len(res["fast"][1]) > 4096


NONCANON = (_rec(tags="cg:Z:020M5I020M5D05M")
            + _rec(qn="n|100|0", tn="m|200|0", st="-", tags="cg:Z:050M")
            + _rec(qn="w", tags="AS:i:3\tcg:Z:25M01X24M")).encode()


@pytest.mark.parametrize("cmd,flags,deferred", [
    ("dedupe", [], False), ("dedupe", ["-a"], False), ("invert", [], True),
    ("filter", [], True), ("trim", [], True), ("dechunk", ["-t"], True),
    ("shatter", [], False)],
    ids=["dedupe", "dedupe-a", "invert", "filter", "trim", "dechunk",
         "shatter"])
def test_leading_zero_cigars(tmp_path, cmd, flags, deferred):
    res = run_lanes(cmd, flags, NONCANON, tmp_path)
    assert_same(res, fast_ran_python=deferred)


@pytest.mark.parametrize("cmd,flags,env", [
    ("invert", ["-h"], {}), ("dedupe", ["--noSuchFlag"], {}),
    ("filter", ["-l", "debug"], {}), ("trim", [], {"profile": "ok"}),
    ("trim", [], {"profile": "failing"})],
    ids=["help", "unknown-flag", "debug-log", "profile", "profile-failing"])
def test_unmodelled_runs_land_in_the_port_python_lane(tmp_path, cmd, flags,
                                                      env):
    payload = "".join(big_records()).encode()
    env = dict(env)
    if env:
        # a profiled run that fails stops its profiler and keeps its exit
        # code (WORKLOAD's cigar-less record fails trim's NaN check)
        if env.pop("profile") == "failing":
            payload = WORKLOAD
        env["PAFFY_TPU_PROFILE"] = str(tmp_path / "traces")
    res = run_lanes(cmd, flags, payload, tmp_path, env=env)
    assert res["fast"][0] == res["python"][0] == res["paffy_tpu"][0]
    assert res["fast"][1] == res["python"][1]
    err = res["fast"][2]
    assert _PORT_IMPORT.search(err) and not _PAFFY_TPU_IMPORT.search(err)
    if env:
        assert res["fast"][1] == res["paffy_tpu"][1]
        traces = list((tmp_path / "traces").glob("paffy_trim.*.json"))
        # the fast lane's and the Python lane's, when the run succeeds
        assert len(traces) == (0 if res["fast"][0] else 2), traces


@pytest.mark.parametrize("cmd", DEVICE_COMMANDS)
def test_device_commands_reach_the_device_rule(tmp_path, cmd):
    # no visible card and no PAFFY_TPU_PLATFORM: the dispatcher's Python
    # lane raises for the device before it reads any input
    env = {k: v for k, v in ENV.items() if k != "PAFFY_TPU_PLATFORM"}
    argv = [DISPATCHER, cmd, "-i", str(tmp_path / "never-read.paf")]
    if cmd == "view":
        argv.append("-s")
    r = subprocess.run(argv, cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env=dict(env, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr
    assert "never-read" not in r.stderr


def _loads_torch(code, *argv, cwd=REPO):
    r = subprocess.run(
        [sys.executable, "-c", code + "\nprint('torch' in sys.modules)\n",
         *argv], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(ENV, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.splitlines()[-1] == "True"


@pytest.mark.parametrize("cmd", sorted(HOST_ONLY))
def test_host_command_imports_no_torch(cmd):
    lookup = f"_{HOST_ONLY[cmd]}_command"
    code = ("import sys\n"
            f"from paffy_tpu_torch.cli import {lookup}\n"
            f"assert {lookup}(sys.argv[1]) is not None")
    assert not _loads_torch(code, cmd)


@pytest.mark.parametrize("argv", [
    ["to_bed", "-n", "-i", "in.paf"],
    ["upconvert", "-i", "in.paf", "frag.fa"],
    ["faffy", "chunk", "-d", "chunks", "-c", "4", "-o", "1", "s.fa"],
    ["faffy", "merge", "-i", "list.txt"],
    ["faffy", "extract", "-i", "s.bed", "s.fa"],
], ids=["to_bed", "upconvert", "faffy-chunk", "faffy-merge",
        "faffy-extract"])
def test_python_only_host_command_runs_without_torch(tmp_path, argv):
    # the seven fast-lane commands' Python lane is checked in every
    # three-lane test above
    (tmp_path / "s.fa").write_text(">q\nACGTACGTAC\n>t\nACGTTCGTAC\n")
    (tmp_path / "in.paf").write_text(
        "q\t10\t0\t10\t+\tt\t10\t0\t10\t10\t10\t60\tcg:Z:10M\n")
    (tmp_path / "s.bed").write_text("t\t2\t7\n")
    (tmp_path / "frag.fa").write_text(">q|10|0\nACGTACGTAC\n")
    (tmp_path / "list.txt").write_text("frag.fa\n")
    main = "paffy_main"
    if argv[0] == "faffy":
        main, argv = "faffy_main", argv[1:]
    code = ("import sys\n"
            f"from paffy_tpu_torch.cli import {main}\n"
            f"assert {main}(sys.argv[1:]) == 0")
    assert not _loads_torch(code, *argv, cwd=tmp_path)


@pytest.mark.parametrize("argv", [
    ["view", "-s", "-i", "in.paf", "s.fa"],
    ["add_mismatches", "-i", "in.paf", "s.fa"],
    ["tile", "-i", "in.paf"], ["chain", "-i", "in.paf"]],
    ids=DEVICE_COMMANDS)
def test_device_command_loads_torch(tmp_path, argv):
    (tmp_path / "s.fa").write_text(">q\nACGTACGTAC\n>t\nACGTTCGTAC\n")
    (tmp_path / "in.paf").write_text(
        "q\t10\t0\t10\t+\tt\t10\t0\t10\t10\t10\t60\tcg:Z:10M\n")
    code = ("import sys\n"
            "from paffy_tpu_torch.cli import paffy_main\n"
            "assert paffy_main(sys.argv[1:]) == 0")
    assert _loads_torch(code, *argv, cwd=tmp_path)


# --------------------------------------------- seeded random differential
# (the counterpart of tools/fuzz_lanes.py for the port's lanes)

NAMES = ["q", "t", "a|1|2", "n|100|0", "m|200|0", "dotty.chr1", "x_y",
         "long" * 10]


def rand_cigar(rng, qspan, tspan):
    """A cigar of M, I and D ops consuming exactly (qspan, tspan)."""
    parts = []
    q = t = 0
    while q < qspan or t < tspan:
        kind = rng.integers(0, 3)
        if kind == 0 and q < qspan and t < tspan:
            n = int(rng.integers(1, min(qspan - q, tspan - t) + 1))
            parts.append(f"{n}M")
            q += n
            t += n
        elif kind == 1 and q < qspan:
            n = int(rng.integers(1, qspan - q + 1))
            parts.append(f"{n}I")
            q += n
        elif t < tspan:
            n = int(rng.integers(1, tspan - t + 1))
            parts.append(f"{n}D")
            t += n
    return "".join(parts)


def rand_record(rng) -> str:
    qn = NAMES[rng.integers(0, len(NAMES))]
    tn = NAMES[rng.integers(0, len(NAMES))]
    ql, tl = int(rng.integers(50, 2000)), int(rng.integers(50, 2000))
    qs = int(rng.integers(0, ql))
    qe = int(rng.integers(qs, ql + 1))
    ts = int(rng.integers(0, tl))
    te = int(rng.integers(ts, tl + 1))
    st = "+-"[rng.integers(0, 2)]
    tags = []
    r = rng.integers(0, 8)
    if r & 1:      # the sentinels: INT_MAX drops AS on output, -1 stays
        tags.append(f"AS:i:{[int(rng.integers(-5, 5000)), -1, 0, 2**31 - 1][rng.integers(0, 4)]}")
    if r & 2:      # -1 is the absent value of tl, cn and s1
        tags.append(f"tl:i:{[1, 2, 3, -1][rng.integers(0, 4)]}")
    if r & 4:
        tags.append("tp:A:" + "PSI"[rng.integers(0, 3)])
    if rng.integers(0, 4) == 0:
        tags.append(f"cn:i:{[7, -1][rng.integers(0, 2)]}")
    if rng.integers(0, 4) == 0:
        tags.append(f"s1:i:{[12345, -1][rng.integers(0, 2)]}")
    kind = rng.integers(0, 10)
    if kind < 6:
        tags.append("cg:Z:" + rand_cigar(rng, qe - qs, te - ts))
        if rng.integers(0, 20) == 0:
            tags[-1] = "cg:Z:0M"                # a zero-length op
    elif kind == 7:
        tags.append(f"cg:Z:{qe - qs + 1}M")     # span mismatch
    elif kind > 7:
        tags.append("cg:Z:5M3Q")                # bad op char
    if rng.integers(0, 12) == 0:
        qs, qe = qe + 1, qs                     # qstart > qend
    line = (f"{qn}\t{ql}\t{qs}\t{qe}\t{st}\t{tn}\t{tl}\t{ts}\t{te}"
            f"\t{max(qe - qs, 0)}\t{max(qe - qs, 1)}\t60")
    if tags:
        line += "\t" + "\t".join(tags)
    return line + "\n"


def rand_input(rng) -> bytes:
    lines = [rand_record(rng) for _ in range(int(rng.integers(1, 25)))]
    if len(lines) > 2 and rng.integers(0, 3) == 0:
        lines.append(lines[int(rng.integers(0, len(lines)))])  # duplicate
    junk = rng.integers(0, 10)
    if junk == 0:
        lines.insert(int(rng.integers(0, len(lines) + 1)), "\n")
    elif junk == 1:
        lines.insert(int(rng.integers(0, len(lines) + 1)), "a\tb\tc\n")
    elif junk == 2:
        k = int(rng.integers(0, len(lines)))
        lines[k] = lines[k].replace("\t+\t", "\t*\t").replace("\t-\t",
                                                              "\t*\t")
    return "".join(lines).encode()


FUZZ_COMMANDS = [("dedupe", []), ("dedupe", ["-a"]), ("invert", []),
                 ("filter", []), ("filter", ["-u", "0.9"]), ("trim", []),
                 ("shatter", []), ("dechunk", []), ("split_file", ["-q"])]


@pytest.mark.parametrize("seed", range(4))
def test_random_records_three_lanes_agree(tmp_path, seed):
    rng = np.random.default_rng(seed)
    for i, (cmd, flags) in enumerate(FUZZ_COMMANDS):
        payload = rand_input(rng)
        d = tmp_path / str(i)
        d.mkdir()
        res = run_lanes(cmd, flags, payload, d)
        codes = {lane: r[0] for lane, r in res.items()}
        assert len(set(codes.values())) == 1, (cmd, flags, payload, codes)
        assert res["fast"][1] == res["paffy_tpu"][1] == res["python"][1], (
            cmd, flags, payload)


def test_smoke_fast_lane_phase_equals_paffy_tpus(tmp_path):
    """chip_smoke.fast_lane_phase at a small size: each of its pinned runs
    gives paffy_tpu's digest, and each timed command runs in both lanes."""
    fa, paf, w = smoke_files(tmp_path / "in", True, **SMALL)
    cpaf = tmp_path / "chain.paf"
    cpaf.write_bytes(chip_smoke.chain_input(w, seq_len=SMALL["seq_len"]))
    am, pipe_tile = tmp_path / "am.paf", tmp_path / "pipe_tile.paf"
    assert ref_main(["add_mismatches", "-i", paf, fa, "-o", str(am)]) == 0
    assert ref_main(["tile", "-i", str(am), "-o", str(pipe_tile)]) == 0
    tpaf = tmp_path / "tile.paf"
    tpaf.write_bytes(chip_smoke.tile_input(am.read_bytes()))
    hd = tmp_path / "host"
    hd.mkdir()
    pins, _ = chip_smoke.host_phase(str(hd), paf, fa, str(cpaf), str(tpaf),
                                    str(pipe_tile), ref_main, ref_faffy)
    pins["chain.paf"] = chip_smoke.sha256_file(cpaf)
    trimmed = tmp_path / "trimmed.paf"
    assert ref_main(["trim", "-i", str(pipe_tile), "-o", str(trimmed)]) == 0
    pins["pipeline trim"] = chip_smoke.sha256_file(trimmed)
    fd = tmp_path / "fast"
    fd.mkdir()
    digests, walls = chip_smoke.fast_lane_phase(str(fd), {
        "in.paf": paf, "chain.paf": str(cpaf),
        "twins.paf": str(hd / "twins.paf"), "up.paf": str(hd / "up.paf"),
        "pipe_tile.paf": str(pipe_tile)}, reps=1)
    assert digests == {pin: pins[pin] for pin, _, _ in chip_smoke.FAST_RUNS}
    assert sorted(walls) == sorted(
        f"{lane} {label} {name}" for lane in ("binary", "fast", "python")
        for label in chip_smoke.FAST_TIMED for name in ("in.paf", "chain.paf"))


def test_with_provenance_round_trips_through_dechunk(tmp_path):
    # the records as the serializer writes them (AS:i:0 where none was)
    paf = tmp_path / "in.paf"
    r = subprocess.run([DISPATCHER, "dedupe", "-o", str(paf)], env=ENV,
                       input=WORKLOAD, capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    prov = tmp_path / "prov.paf"
    prov.write_bytes(chip_smoke.with_provenance(paf.read_bytes()))
    assert b"\nq|100|0\t100\t" in prov.read_bytes()
    out = tmp_path / "out.paf"
    r = subprocess.run([DISPATCHER, "dechunk", "-i", str(prov), "-o",
                        str(out)], env=ENV, capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.read_bytes() == paf.read_bytes()
