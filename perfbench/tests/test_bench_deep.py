"""The five-genome tile deployment sub5_grch38_24 and its cell
sub5_grch38_24.tile, with the runner's one-worker control
hc_grch38_24.pipeline_1w beside it: at a small size the harness runs the
tile cell on the program's CPU path and reads it correct, the control
(the reference with its counts in 8 bits) reads it not correct, and so
does a run whose timed path gives one record a level off by one; the
readers of the plan's counters read hand-built spans and give None
without them; the benchmark holds both cells with their eleven per-layer
metrics; the new yardstick imports nothing of the program."""

import os
from types import SimpleNamespace

import pytest

import control
import run
import synth_deep
import tiny
from test_bench_imports import FORBIDDEN, top_level_imports

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "sub5_grch38_24.tile"
CONTROL = "hc_grch38_24.pipeline_1w"


def config() -> dict:
    """sub5_grch38_24 on four contigs of ~100 kbp, two loci under 300
    records each: deep enough that 8-bit counts saturate."""
    cfg = tiny.full("sub5_grch38_24")
    cfg["contig_lengths"] = {k: cfg["contig_lengths"][k] for k in
                             ("chr19", "chr20", "chr21", "chr22")}
    cfg.update(seq_len=400_000, n_records=8, m_columns=373_000,
               stack_loci=2, stack_scale_len=400_000, stack_depth=300)
    return cfg


def test_cell_runs_correct_on_the_cpu(on_cpu):
    rc, res = run.run_cell(CELL, 2**33 + 21, 0.5, True, require_cuda=False,
                           config=config())
    assert rc == 0 and res["correct"] and res["failed"] == 0
    assert res["window"]["jobs"] >= 1
    assert {"tile_s.deep", "parse_s.deep", "write_s.deep",
            "device_idle.deep"} <= set(res["metrics"])
    # on the CPU K5 runs its plain sweep: no plan, no counters
    assert "k5_batches.deep" not in res["metrics"]


def test_control_is_not_correct(on_cpu):
    got = control.reading(CELL, 2**32 + 3, require_cuda=False,
                          config=config())
    assert got["correct"] is False
    assert got["jobs_differing"] == got["jobs"] > 0
    assert got["jobs_failed"] == 0


def _level_off_by_one(traffic):
    """One record's level one higher where K5's levels are made."""
    from paffy_tpu_torch.ops import tile
    assign = tile.assign_tile_levels

    def off_by_one(t, order, cap=tile.SATURATION):
        levels = assign(t, order, cap)
        levels[int(order[len(order) // 2])] += 1
        return levels
    tile.assign_tile_levels = off_by_one


def test_level_off_by_one_is_not_correct(on_cpu):
    from paffy_tpu_torch.ops import tile
    saved = tile.assign_tile_levels
    try:
        rc, res = run.run_cell(CELL, 7, 0.2, False, require_cuda=False,
                               config=config(), fault=_level_off_by_one)
    finally:
        tile.assign_tile_levels = saved
    assert rc == 0 and res["correct"] is False
    assert res["compared"]["jobs_differing"]["value"] == res["attempted"]


def test_input_is_deep_and_named_by_genome(tmp_path):
    inputs = synth_deep.deep_inputs(config(), 5, str(tmp_path))
    recs = inputs["records"]["deep"]
    assert inputs["seqs"] == {} and set(inputs["files"]) == {"deep"}
    n = len(recs["qstart"]) - 2 * 300        # the genomes', then the stacks
    assert n % 4 == 0
    for g, prefix in enumerate(("hs.", "g1.hs.", "g2.hs.", "g3.hs.")):
        part = recs["tname"][g * n // 4: (g + 1) * n // 4]
        assert all(x.startswith(prefix) for x in part.tolist())
        assert (recs["qname"][g * n // 4: (g + 1) * n // 4]
                == recs["qname"][: n // 4]).all()
    assert len(set(recs["tname"][n:].tolist())) > 8      # of 16
    assert (recs["qstart"] >= 0).all() and (recs["qend"] <= recs["qlen"]).all()
    assert (recs["tend"] <= recs["tlen"]).all() and (recs["s1"] == 0).all()


# ------------------------------------------------------------- readers

def reader(name):
    return run.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                           "metric_" + name.replace(".", "_"))


def span(name, start, end, **counts):
    return SimpleNamespace(name=name, start=start, end=end, phase=True,
                           counts=counts)


def hand_built():
    jobs = [SimpleNamespace(start=10.0, end=12.0, traced=True),
            SimpleNamespace(start=20.0, end=21.0, traced=True),
            SimpleNamespace(start=30.0, end=31.0, traced=False)]
    spans = [span("K5 tiles", 10.2, 10.4, batches=3, hist_mb=2500.0,
                  carried_mb=1500.0, waits=5),
             span("K5", 10.1, 10.9, waits=1),
             span("K5 tiles", 20.2, 20.3, batches=4, hist_mb=2600.0,
                  carried_mb=1700.0),
             span("K5 tiles", 30.2, 30.3, batches=9, hist_mb=1.0,
                  carried_mb=1.0)]
    return SimpleNamespace(jobs=jobs), spans


@pytest.mark.parametrize("name,want", [("k5_batches.deep", 3.5),
                                       ("k5_hist_mb.deep", 2550.0),
                                       ("k5_carried_mb.deep", 1600.0)])
def test_plan_counter_readers(name, want):
    data, spans = hand_built()
    r = reader(name)
    assert r.read(data, spans) == pytest.approx(want)
    # a program that counts none (the parent of these counters): None
    bare = [span(s.name, s.start, s.end) for s in spans]
    assert r.read(data, bare) is None
    assert r.read(data, []) is None


def test_both_cells_are_in_the_benchmark():
    bench = tiny.bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    assert (cells[CELL]["config"], cells[CELL]["traffic"],
            cells[CELL]["chips"]) == ("sub5_grch38_24", "tile", 1)
    assert (cells[CONTROL]["config"], cells[CONTROL]["traffic"],
            cells[CONTROL]["chips"]) == ("hc_grch38_24", "pipeline_1w", 1)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["records_per_s"]["workloads"][-2:] == [CELL, CONTROL]
    mine = {m["name"] for m in bench["per_layer"]
            if CELL in m.get("workloads", [])}
    assert mine == {"k5_batches.deep", "k5_hist_mb.deep",
                    "k5_carried_mb.deep", "k5_roofline.deep",
                    "k5_plan_s.deep", "tile_s.deep", "parse_s.deep",
                    "write_s.deep", "device_idle.deep"}
    assert {m["name"] for m in bench["per_layer"]
            if CONTROL in m.get("workloads", [])} == {"k5_plan_s.g1w",
                                                      "device_idle.g1w"}
    spec = {c["name"]: c for c in bench["configs"]}["sub5_grch38_24"]
    cfg = tiny.full("sub5_grch38_24")
    assert spec["reduced"] == cfg["reduced"]
    hc = tiny.full("hc_grch38_24")
    for k in ("contig_lengths", "target_prefix", "query_prefix", "seq_len",
              "n_records", "m_columns", "median_run", "indel_len",
              "rev_share"):
        assert cfg[k] == hc[k], k
    assert synth_deep.n_loci(cfg) == 200


@pytest.mark.parametrize("name", ["synth_deep.py", "reference_tile.py",
                                  "deep_readings.py"])
def test_new_yardstick_imports_nothing_of_the_program(name):
    mods = set(top_level_imports(os.path.join(BENCH, name)))
    assert not mods & (FORBIDDEN | {"paffy_tpu_torch", "chip_smoke",
                                    "torch"})
