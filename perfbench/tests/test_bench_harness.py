"""The harness: each traffic mix's jobs run at a tiny size on the program's
CPU path and prove correct; with no card the harness exits non-zero and
prints no result; a run with its timed path broken underneath, its look
for a chip skipped, comes out not correct; the controls, the plain
reference in the program's place with a guarantee broken or its trim in
float16, come out not correct through the same run."""

import os
import subprocess
import sys

import numpy as np
import pytest

import control
import run
import tiny

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELLS = [w["name"] for w in tiny.bench()["workloads"]]


def cell_config(name):
    spec = {w["name"]: w for w in tiny.bench()["workloads"]}[name]
    return tiny.config(spec["config"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(cell, on_cpu):
    rc, res = run.run_cell(cell, 2**33 + 5, 0.5, False, require_cuda=False,
                           config=cell_config(cell))
    assert rc == 0
    assert res["correct"] and res["failed"] == 0
    assert res["window"]["jobs"] >= 1
    assert list(res)[-1] == "compared"
    assert isinstance(res["launches"], dict)
    names = {m["name"] for m in tiny.bench()["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == names
    assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, cuda, monkeypatch):
    """A traced run of each cell at a tiny size through the card's kernels:
    correct, the device busy, the kernels' shares in (0, 100]."""
    monkeypatch.delenv("PAFFY_TPU_PLATFORM", raising=False)
    rc, res = run.run_cell(cell, 2**33 + 9, 0.5, True,
                           config=cell_config(cell))
    assert rc == 0 and res["correct"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    shares = [v["value"] for k, v in res["metrics"].items()
              if "roofline" in k]
    assert shares and all(0 < x <= 100 for x in shares)


def test_traced_run_reports_per_layer_metrics(on_cpu):
    cell = "hc_chr10.pipeline"
    rc, res = run.run_cell(cell, 11, 0.5, True, require_cuda=False,
                           config=cell_config(cell))
    assert rc == 0 and res["correct"]
    assert {"encode_s.rec", "chain_s.rec", "tile_s.rec",
            "worker_overlap.rec", "pool_s.rec"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0
    # no device on the CPU: the kernels' shares are left out, not 0
    assert "k6_roofline.rec" not in res["metrics"]


def test_no_card_exits_without_a_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PAFFY_TPU_PLATFORM", None)
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "hc_chr10.add_mismatches", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_bare_benchmark_directory_exits_without_a_result(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "hc_chr10.add_mismatches", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


# ----------------------------------------------------------------- faults

def _unchanged(traffic):
    """add_mismatches' encode returns its input: M ops left as they are."""
    from paffy_tpu_torch.ops import mismatch
    from paffy_tpu_torch.parallel import runner
    mismatch.encode_mismatches = lambda t, pool: t
    runner.encode_mismatches = mismatch.encode_mismatches


def _half(traffic):
    """Half of each batch left out of the encode."""
    from paffy_tpu_torch.ops import mismatch
    from paffy_tpu_torch.parallel import runner
    enc = mismatch.encode_mismatches

    def half(t, pool):
        return enc(t.take(np.arange((len(t) + 1) // 2)), pool)
    mismatch.encode_mismatches = half
    runner.encode_mismatches = half


def _altered(traffic):
    """One record's answer altered where it is produced: one of its =/X
    runs a column shorter after the encode, its query and target ends one
    base earlier to match."""
    from dataclasses import replace

    from paffy_tpu_torch.ops import mismatch
    from paffy_tpu_torch.parallel import runner
    enc = mismatch.encode_mismatches

    def altered(t, pool):
        t = enc(t, pool)
        lens, qend, tend = t.lens.copy(), t.qend.copy(), t.tend.copy()
        k = int(np.flatnonzero(lens[: t.off[1]] > 1)[-1])
        lens[k] -= 1
        qend[0] -= 1
        tend[0] -= 1
        return replace(t, lens=lens, qend=qend, tend=tend)
    mismatch.encode_mismatches = altered
    runner.encode_mismatches = altered


@pytest.fixture
def restore():
    from paffy_tpu_torch.ops import mismatch
    from paffy_tpu_torch.parallel import runner
    saved = mismatch.encode_mismatches
    yield
    mismatch.encode_mismatches = saved
    runner.encode_mismatches = saved


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_the_batch",
                              "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, on_cpu, restore):
    rc, res = run.run_cell(cell, 7, 0.2, False, require_cuda=False,
                           config=cell_config(cell), fault=fault)
    assert rc == 0
    assert res["correct"] is False
    assert res["compared"]["jobs_differing"]["value"] > 0


# --------------------------------------------------------------- controls

@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, on_cpu):
    """The control, the plain reference in the program's place with one
    guarantee broken (perfbench/control.py), comes out not correct through
    the harness's own run and comparison."""
    got = control.reading(cell, 3, require_cuda=False,
                          config=cell_config(cell))
    assert got["correct"] is False
    assert got["jobs_differing"] == got["jobs"] > 0
    assert got["jobs_failed"] == 0
