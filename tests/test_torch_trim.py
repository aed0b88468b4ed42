"""``trim`` of paffy_tpu_torch against paffy_tpu's, on the CPU: the same
bytes and exit codes with the default flags and with each of -r, -t and
-f, on encoded records (=/X runs, both strands), on input the raw reader
hands to the full parser (a cigar with a leading zero), and on its
failures: the op-free-cigar abort (the sub-block stdio tail is lost), a
paf_check failure (the records before it are written), and a paf_check
failure before an op-free record, which wins.  ``trim_unreliable_tails``
gives paffy_tpu's table on raw and on parsed cigars."""

import numpy as np
import pytest

from paffy_tpu.cli import paffy_main as ref_main
from paffy_tpu.core import pafio as ref_pafio
from paffy_tpu.ops.tailtrim import trim_unreliable_tails as ref_trim
from paffy_tpu_torch.cli import paffy_main as port_main
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.ops.tailtrim import trim_unreliable_tails
from synthdata import make_workload
from test_torch_host import assert_tables_equal


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Encoded workload records (many, so the output passes several 4096
    byte blocks) and the failing variants of them."""
    d = tmp_path_factory.mktemp("torch_trim")
    seqs, lines = make_workload(seed=11, length=30000, n_windows=40,
                                window=2500, step=700)
    (d / "in.paf").write_text("\n".join(lines) + "\n")
    (d / "s.fa").write_text("".join(f">{k}\n{v}\n" for k, v in seqs.items()))
    assert ref_main(["add_mismatches", "-i", str(d / "in.paf"),
                     str(d / "s.fa"), "-o", str(d / "am.paf")]) == 0
    am = (d / "am.paf").read_text().splitlines()
    n = len(am)

    def variant(name, edits):
        rows = list(am)
        for i, fn in edits:
            rows[i] = fn(rows[i])
        (d / name).write_text("\n".join(rows) + "\n")

    def no_cigar(row):
        return "\t".join(f for f in row.split("\t")
                         if not f.startswith("cg:Z:"))

    def past_qlen(row):
        f = row.split("\t")
        f[3] = str(int(f[1]) + 3)
        return "\t".join(f)

    def leading_zero(row):
        return row.replace("cg:Z:", "cg:Z:0", 1)

    variant("opfree.paf", [(n - 3, no_cigar)])
    variant("check.paf", [(n - 4, past_qlen)])
    variant("check_first.paf", [(n - 5, past_qlen), (n - 3, no_cigar)])
    variant("noncanon.paf", [(2, leading_zero)])
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


@pytest.mark.parametrize("flags", [[], ["-r", "0.3"], ["-r", "0"],
                                   ["-t", "0.2"], ["-f"], ["-f", "-t", "0.4"]],
                         ids=["default", "r", "r0", "t", "f", "f-t"])
def test_trim_cli_matches_paffy_tpu(files, tmp_path, flags):
    ref, port = both(["trim", "-i", str(files / "am.paf"), *flags], tmp_path)
    assert port == ref and ref[0] == (0, None)
    assert ref[1] != (files / "am.paf").read_bytes()     # something trimmed


def test_trim_of_non_canonical_cigars_matches_paffy_tpu(files, tmp_path):
    ref, port = both(["trim", "-i", str(files / "noncanon.paf")], tmp_path)
    assert port == ref and ref[0] == (0, None)


@pytest.mark.parametrize("paf,kind", [
    ("opfree.paf", "op-free cigar"), ("check.paf", "Paf query end"),
    ("check_first.paf", "Paf query end")],
    ids=["op-free-abort", "check-prefix", "check-before-op-free"])
def test_trim_failures_match_paffy_tpu(files, tmp_path, paf, kind):
    ref, port = both(["trim", "-i", str(files / paf)], tmp_path)
    assert port == ref and ref[0][1].startswith("PafCheckError")
    assert kind in ref[0][1]
    # the records before the bad one were written (the op-free abort loses
    # the sub-block tail, so a multiple of 4096 bytes reaches the file)
    assert len(ref[1]) > 4096
    if paf == "opfree.paf":
        assert len(ref[1]) % 4096 == 0


@pytest.mark.parametrize("raw", [False, True], ids=["parsed", "raw"])
@pytest.mark.parametrize("fractions", [(0.05, 1.0), (0.5, 0.3), (0.0, 1.0)])
def test_trim_unreliable_tails_matches_paffy_tpu(files, raw, fractions):
    data = (files / "am.paf").read_bytes()
    kw = dict(parse_cigars=False) if raw else {}
    got = trim_unreliable_tails(pafio.parse_paf_data(data, **kw), *fractions)
    want = ref_trim(ref_pafio.parse_paf_data(data, **kw), *fractions)
    assert_tables_equal(got, want)
    assert bytes(pafio.serialize_paf_bytes(got)) == bytes(
        ref_pafio.serialize_paf_bytes(want))
