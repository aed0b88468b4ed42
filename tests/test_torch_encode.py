"""``add_mismatches`` of paffy_tpu_torch against paffy_tpu's, on the CPU
(PAFFY_TPU_PLATFORM=cpu, so K4 runs its plain PyTorch versions):
``encode_mismatches`` gives the same ops, lens and off as paffy_tpu's
native route, its device routes (tiled_runs and _column_runs in JAX on the
CPU, FORCE_DEVICE) and the C pass pair, and the same bytes as paffy_tpu's
fused encode_serialize (and the port's binding of it); the command and ``-a`` give the same bytes and
exit codes, including the prefix written before a missing sequence or a
paf_check failure.  K4's plain versions are also held against the C passes
on chip_smoke's K4 edge cases (a subset of the residues)."""

import numpy as np
import pytest
import torch

import chip_smoke
from paffy_tpu import native as ref_native
from paffy_tpu.cli import paffy_main as ref_main
from paffy_tpu.core import pafio as ref_pafio
from paffy_tpu.ops import mismatch as ref_mm
from paffy_tpu_torch import devconf, native
from paffy_tpu_torch.cli import paffy_main as port_main
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.ops import mismatch as port_mm
from paffy_tpu_torch.ops import mismatch_device, runs
from paffy_tpu_torch.ops.compare import PIECE_COLS as P
from ref_native import paffy_tpu_lib  # noqa: F401
from synthdata import make_workload

IUPAC = b"ACGTNMKRYVBHDWS"


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


def draw(rng, alphabet, n):
    if alphabet == "any":
        return rng.integers(0, 256, n, dtype=np.uint8)
    letters = np.frombuffer(alphabet, dtype=np.uint8)
    return letters[rng.integers(0, len(letters), n)]


def edge_workload(alphabet, lower, seed=7):
    """Records whose M runs have 1, P-1, P, P+1 and 2P+1 columns on both
    strands, with state flips dense (every fifth column) or only where
    placed (on and next to the piece cuts); adjacent M ops; input that
    already holds =/X; an empty record, M-free records and a 0-length M
    op.  Returns (PAF text, {name: bytes})."""
    rng = np.random.default_rng(seed)
    n = 6 * P
    t = draw(rng, alphabet, n)
    q = t.copy()
    dense = rng.random(n) < 0.2
    q[dense] = draw(rng, alphabet, int(dense.sum()))
    if lower:
        q[rng.random(n) < 0.3] |= 0x20
        t[rng.random(n) < 0.3] |= 0x20
    # "p": the target's copy, except at and next to the cuts
    p = t.copy()
    for c in (P - 1, P, 2 * P - 3, 2 * P + 1, 512, 1023):
        p[c + 9] = ord("A") if p[c + 9] != ord("A") else ord("C")
    seqs = {"q": q.tobytes(), "t": t.tobytes(), "p": p.tobytes()}
    lines = []
    for ln in (1, P - 1, P, P + 1, 2 * P + 1):
        for strand in "+-":
            for qn in ("q", "p"):
                lines.append(f"{qn}\t{n}\t5\t{5 + ln}\t{strand}\tt\t{n}\t9\t"
                             f"{9 + ln}\t{ln}\t{ln}\t60\tcg:Z:{ln}M")
            lines.append(f"q\t{n}\t3\t{3 + ln + 9}\t{strand}\tt\t{n}\t1\t"
                         f"{1 + ln + 8}\t{ln}\t{ln}\t60"
                         f"\tcg:Z:3M2I{ln}M1D4M")
    lines += [f"p\t{n}\t0\t30\t+\tt\t{n}\t0\t30\t30\t30\t60"
              f"\tcg:Z:5M5M10=3X7M",
              f"q\t{n}\t7\t47\t-\tt\t{n}\t2\t42\t40\t40\t60"
              f"\tcg:Z:20M0M20M",
              f"q\t{n}\t0\t10\t+\tt\t{n}\t0\t10\t10\t10\t60",
              f"q\t{n}\t0\t5\t+\tt\t{n}\t7\t7\t0\t5\t60\tcg:Z:5I",
              f"q\t{n}\t4\t4\t-\tt\t{n}\t7\t11\t0\t4\t60\tcg:Z:4D",
              f"q\t{n}\t0\t6\t+\tt\t{n}\t0\t6\t6\t6\t60\tcg:Z:2=4X"]
    return "\n".join(lines) + "\n", seqs


CASES = {"acgt": (b"ACGT", False), "acgt-lower": (b"ACGT", True),
         "iupac15-lower": (IUPAC, True), "anybyte": ("any", False)}


def pools(seqs):
    """paffy_tpu's pool and the port's over the same bytes."""
    ref = ref_mm.SequencePool({k: v.decode("latin-1")
                               for k, v in seqs.items()})
    g = ref._guard
    port = port_mm.SequencePool.from_arrays(
        ref.host_pool[g: g + ref._data_len], ref.index)
    return ref, port


def c_pass_pair(t, pool):
    """The C count and fill passes with the CSR rebuild (paffy_tpu's
    native route, through the port's own bindings)."""
    b = port_mm.build_m_column_batch(t, pool.offsets_for(t.qname, "query"),
                                     pool.offsets_for(t.tname, "target"))
    k = b.n_mops
    args = (pool.host_pool, b.lens[:k], b.qpos0[:k], b.tpos0[:k], b.rev[:k])
    per_mop = native.encode_runs_per_mop(*args)
    out_off, m_out_off, new_ops, new_lens = native.encode_rebuild_offsets(
        t.ops, t.lens, per_mop, int(per_mop.sum()) + len(t.ops) - k)
    native.encode_runs_fill_cigar(*args, m_out_off, new_ops, new_lens)
    return new_ops, new_lens, out_off[t.off]


def assert_cigars(got, ops, lens, off):
    for name, want in (("ops", ops), ("lens", lens), ("off", off)):
        np.testing.assert_array_equal(getattr(got, name), want,
                                      err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_encode_matches_every_paffy_tpu_route(case, monkeypatch):
    text, seqs = edge_workload(*CASES[case])
    ref, port = pools(seqs)
    r, t = ref_pafio.parse_paf_text(text), pafio.parse_paf_text(text)
    got = port_mm.encode_mismatches(t, port)
    want = ref_mm.encode_mismatches(r, ref)             # native route
    assert_cigars(got, want.ops, want.lens, want.off)
    assert_cigars(got, *c_pass_pair(t, port))
    monkeypatch.setattr(ref_mm, "FORCE_DEVICE", True)   # _column_runs
    dev = ref_mm.encode_mismatches(r, ref)
    assert_cigars(got, dev.ops, dev.lens, dev.off)
    monkeypatch.setattr(ref_mm, "TILED_THRESHOLD", 1)   # tiled_runs
    tiled = ref_mm.encode_mismatches(r, ref)
    assert_cigars(got, tiled.ops, tiled.lens, tiled.off)
    fused = ref_native.encode_serialize(
        r, ref.host_pool, ref.offsets_for(r.qname, "query"),
        ref.offsets_for(r.tname, "target")).tobytes()
    assert bytes(pafio.serialize_paf_bytes(got)) == fused
    assert native.encode_serialize(
        t, port.host_pool, port.offsets_for(t.qname, "query"),
        port.offsets_for(t.tname, "target")).tobytes() == fused
    assert b"=" in fused and b"X" in fused


@pytest.mark.parametrize("seed", [3, 4])
def test_encode_workload_matches_paffy_tpu(seed):
    seqs, lines = make_workload(seed=seed, length=20000, n_windows=20,
                                window=2000, step=700)
    text = "\n".join(lines) + "\n"
    ref, port = pools({k: v.encode() for k, v in seqs.items()})
    r, t = ref_pafio.parse_paf_text(text), pafio.parse_paf_text(text)
    want = ref_mm.encode_mismatches(r, ref)
    assert_cigars(port_mm.encode_mismatches(t, port), want.ops, want.lens,
                  want.off)


def test_encode_without_m_ops_returns_the_table():
    text = ("q\t9\t0\t4\t+\tt\t9\t0\t4\t4\t4\t60\tcg:Z:2=2X\n"
            "q\t9\t0\t5\t+\tt\t9\t0\t0\t0\t5\t60\tcg:Z:5I\n")
    _, port = pools({"q": b"ACGTACGTA", "t": b"ACGAACGTA"})
    t = pafio.parse_paf_text(text)
    assert port_mm.encode_mismatches(t, port) is t


def test_zero_length_m_ops_vanish_as_in_the_fused_encoder():
    # paffy_tpu's encode_mismatches returns a batch whose M ops are all of
    # length 0 unchanged, while its production route (encode_serialize)
    # drops them; the port follows the production bytes
    text = "q\t9\t0\t4\t+\tt\t9\t0\t4\t4\t4\t60\tcg:Z:0M2=2X0M\n"
    seqs = {"q": b"ACGTACGTA", "t": b"ACGAACGTA"}
    ref, port = pools(seqs)
    r, t = ref_pafio.parse_paf_text(text), pafio.parse_paf_text(text)
    got = bytes(pafio.serialize_paf_bytes(port_mm.encode_mismatches(t,
                                                                     port)))
    assert got == ref_native.encode_serialize(
        r, ref.host_pool, ref.offsets_for(r.qname, "query"),
        ref.offsets_for(r.tname, "target")).tobytes()
    assert got.endswith(b"cg:Z:2=2X\n")
    assert ref_mm.encode_mismatches(r, ref) is r     # keeps 0M0M


@pytest.mark.parametrize("label", chip_smoke.K4_EDGE_LABELS)
def test_k4_plain_matches_c_passes_on_edge_cases(label):
    c = chip_smoke.k4_edge_cases(residues=(0, 1, 7, 15))[label]
    if label in chip_smoke.K1_EDGE_LABELS:     # every length, fewer residues
        keep = np.isin(c["tpos0"] % 16, (0, 1, 15)) & np.isin(
            c["qpos0"] % 16, (0, 14, 15))
        c = {k: (v[keep] if k != "pool" else v) for k, v in c.items()}
    *_, n_runs, err = chip_smoke.k4_check(
        torch, devconf, native, runs, mismatch_device, c["pool"], c["lens"],
        c["qpos0"], c["tpos0"], c["rev"])
    assert err == 0 and n_runs > len(c["lens"])


def test_run_table_rows():
    lens = np.array([5, 0, P + 3, 2])
    tpos0 = np.array([3, 100, 17, 400])
    table, piece_off = runs.build_run_table(
        lens, [10, 20, 30, 40], tpos0, [False, True, False, True],
        np.cumsum(lens) - lens, 1000 + 2 * P)
    assert piece_off.tolist() == [0, 1, 1, 3, 4]
    assert table[2].tolist() == [5, P - 1, 4, 2]          # cut at P - 1
    assert table[3].tolist() == [0, 5, 5 + P - 1, 5 + P + 3]
    assert table[4].tolist() == [1, 1, 0, 1]
    assert table[1, 2] % 16 == 0                          # a cut is aligned


def test_run_wrappers_on_cpu_run_plain_without_launching():
    from paffy_tpu_torch import kernels
    ext = torch.from_numpy(np.frombuffer(b"ACGT" * 8, dtype=np.uint8).copy())
    table = torch.tensor([[0], [16], [8], [0], [1]], dtype=torch.int64)
    before = dict(kernels.LAUNCHES)
    counts = runs.run_counts(ext, table)
    starts, states = runs.run_fill(ext, table, torch.zeros(1,
                                                           dtype=torch.int64),
                                   int(counts[0]))
    assert kernels.LAUNCHES == before
    assert counts.tolist() == [1] and starts.tolist() == [0]
    assert states.tolist() == [1]
    with pytest.raises(ValueError):
        runs.run_counts(ext[:20], table)


# ------------------------------------------------------------ the command

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_encode")
    seqs, lines = make_workload(seed=2, length=12000, n_windows=16,
                                window=1500, step=600)
    rng = np.random.default_rng(4)
    with open(d / "seqs.fa", "w") as fh:
        for name, s in seqs.items():
            a, b = sorted(rng.integers(0, len(s), 2))
            s = s[:a] + s[a:b].lower() + s[b:]
            fh.write(f">{name}\n" + "\n".join(
                s[i: i + 60] for i in range(0, len(s), 60)) + "\n")
    (d / "in.paf").write_text("\n".join(lines) + "\n")
    qn, tn = lines[0].split("\t")[0], lines[0].split("\t")[5]
    for role, bad in (("query", lines[3].replace(qn, "zz", 1)),
                      ("target", lines[3].replace(f"\t{tn}\t", "\tzz\t", 1))):
        (d / f"missing_{role}.paf").write_text(
            "\n".join(lines[:3] + [bad] + lines[4:]) + "\n")
    f = lines[5].split("\t")
    f[3] = str(int(f[3]) + 1)          # the cigar no longer spans the query
    (d / "check.paf").write_text(
        "\n".join(lines[:5] + ["\t".join(f)] + lines[6:]) + "\n")
    return d


def both(argv, tmp_path):
    """((rc, error), output bytes) of paffy_tpu's and the port's command."""
    out = []
    for tag, main in (("ref", ref_main), ("port", port_main)):
        o = tmp_path / f"{tag}.paf"
        try:
            res = (main([*argv, "-o", str(o)]), None)
        except Exception as e:           # the command's own failure
            res = (None, f"{type(e).__name__}: {e}")
        out.append((res, o.read_bytes() if o.exists() else None))
    return out


def test_add_mismatches_cli_matches_paffy_tpu(files, tmp_path):
    ref, port = both(["add_mismatches", "-i", str(files / "in.paf"),
                      str(files / "seqs.fa")], tmp_path)
    assert port == ref and ref[0] == (0, None)
    assert b"=" in ref[1] and b"X" in ref[1]
    (tmp_path / "am.paf").write_bytes(ref[1])
    ref, port = both(["add_mismatches", "-a", "-i",
                      str(tmp_path / "am.paf")], tmp_path)
    assert port == ref and ref[0] == (0, None)
    assert ref[1] == (files / "in.paf").read_bytes()


@pytest.mark.parametrize("role", ["query", "target"])
def test_add_mismatches_missing_sequence_prefix(files, tmp_path, role,
                                                capsys):
    ref, port = both(["add_mismatches", "-i", str(files / f"missing_{role}.paf"),
                      str(files / "seqs.fa")], tmp_path)
    assert port == ref and ref[0] == (1, None)
    assert ref[1].count(b"\n") == 3
    assert capsys.readouterr().err.count(
        f"No {role} sequence named: zz found") == 2


def test_add_mismatches_check_failure_prefix(files, tmp_path):
    ref, port = both(["add_mismatches", "-i", str(files / "check.paf"),
                      str(files / "seqs.fa")], tmp_path)
    assert port == ref and ref[0][1].startswith("PafCheckError")
    assert ref[1].count(b"\n") == 5 and b"X" in ref[1]


def test_add_mismatches_a_check_failure_prefix(files, tmp_path):
    ref, port = both(["add_mismatches", "-a", "-i", str(files / "check.paf")],
                     tmp_path)
    assert port == ref and ref[0][1].startswith("PafCheckError")
    assert ref[1].count(b"\n") == 5
