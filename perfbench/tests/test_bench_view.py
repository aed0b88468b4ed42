"""The view_stats cell: the plain reference of ``paffy view -s``
(perfbench/reference_view.py) gives the bytes of the program's ``view -s``
on the tiny hc_chr10 pair, and its control (no case folding) does not;
with view's column counts broken underneath, the harness's run of the
cell comes out not correct; K1's least bytes are counted from the
reference's work."""

import numpy as np
import pytest

import reference_view
import run
import synth
import tiny

CELL = "hc_chr10.view_stats"


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair")
    return synth.pair_inputs(tiny.config("hc_chr10"), 2**31 + 3, str(d))


def program_view(inputs, tmp_path):
    from paffy_tpu_torch.cli import paffy_main
    out = tmp_path / "view.txt"
    rc = paffy_main(["view", "-s", "-i", inputs["files"]["gapped"],
                     inputs["files"]["fasta"], "-o", str(out)])
    assert rc == 0
    return out.read_bytes()


def test_reference_equals_the_programs_view(pair, on_cpu, tmp_path):
    got = program_view(pair, tmp_path)
    want, work = reference_view.view_stats_jobs(
        pair["records"]["gapped"], pair["seqs"], ["whole"])
    assert got == want["whole"]
    assert got.count(b"\n") == len(pair["records"]["gapped"]["qstart"]) + 1
    assert set(work["whole"][0]) == {"records", "columns", "m_runs"}
    bad, _ = reference_view.view_stats_jobs(
        pair["records"]["gapped"], pair["seqs"], ["whole"], control=True)
    assert bad["whole"] != got


def _counts_off(how):
    def fault(traffic):
        from paffy_tpu_torch.commands import view
        counts = view.column_match_counts

        def broken(t, pool):
            m, x = counts(t, pool)
            m, x = np.array(m), np.array(x)
            if how == "unchanged":      # every column counted a match
                return m + x, np.zeros_like(x)
            if how == "half":           # the second half of the batch lost
                m[len(m) // 2:] = 0
                x[len(x) // 2:] = 0
                return m, x
            m[0] -= 1                   # one column moved to mismatches
            x[0] += 1
            return m, x
        view.column_match_counts = broken
    return fault


@pytest.fixture
def restore():
    from paffy_tpu_torch.commands import view
    saved = view.column_match_counts
    yield
    view.column_match_counts = saved


@pytest.mark.parametrize("how", ["unchanged", "half", "altered"])
def test_broken_view_counts_are_not_correct(how, on_cpu, restore):
    rc, res = run.run_cell(CELL, 19, 0.2, False, require_cuda=False,
                           config=tiny.config("hc_chr10"),
                           fault=_counts_off(how))
    assert rc == 0
    assert res["correct"] is False
    assert res["compared"]["jobs_differing"]["value"] > 0


def test_k1_least_bytes_count_the_references_work():
    reader = run.load_module(
        run.os.path.join(run.HERE, "metrics", "k1_roofline.view.py"),
        "metric_k1_roofline_view")
    w = {"records": 10, "columns": 1000, "m_runs": 4}
    pk = {"hbm_bytes_per_s": 1.0}
    assert reader.least_s(w, pk) == 2 * 1000 + 25 * 4 + 16 * 10
