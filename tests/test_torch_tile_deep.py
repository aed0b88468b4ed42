"""``tile`` of the five-genome deployment (the benchmark's sub5_grch38_24,
perfbench/synth_deep.py) at a small size: four query contigs of about
200 kbp, four target genomes and four loci under stacks of 25 to 60
records, with stacks placed by hand across a tile edge and on both sides
of a contig edge.  On the CPU: the port's ``paffy_main tile`` gives the
bytes of the plain reference (perfbench/reference_tile.py); the
reference's levels, a block of overlapping records at a time, equal
perfbench/reference.py's on the whole input; with HIST_BUDGET lowered the
plain emulation of K5 runs in three batches or more and gives the
sequential sweep's levels; ``TilePlan.counts`` equals a brute-force count
of the batches, the bins and the (tile, later batch) pairs whose counts
are carried; genome 0's records are synth_genome's at the same seed and
the file is chip_smoke.deep_tile_input's rule; the parse's names, split
from its pool in one pass, are those of the loop over records it
replaced, empty and latin-1 names among them.  On a card: the K5 tiles
span carries those counters and each batch has its K5 batch span.  This
file imports no JAX and nothing of paffy_tpu, so it also runs on a card:

    python -m pytest --noconftest tests/test_torch_tile_deep.py -q
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = REPO / "perfbench"
for p in (str(REPO), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import chip_smoke  # noqa: E402
import reference  # noqa: E402
import reference_tile  # noqa: E402
import synth_deep  # noqa: E402
import synth_genome  # noqa: E402
from paffy_tpu_torch import native, phases  # noqa: E402
from paffy_tpu_torch.cli import paffy_main  # noqa: E402
from paffy_tpu_torch.core import pafio  # noqa: E402
from paffy_tpu_torch.ops import tile, tile_device  # noqa: E402

CONTIGS = ("chr19", "chr20", "chr21", "chr22")
SIZES = dict(seq_len=800_000, n_records=8, m_columns=747_000)


def config(depth: int) -> dict:
    """sub5_grch38_24 on four of its contigs at a small size, four loci
    under ``depth`` records each."""
    with open(BENCH / "configs" / "sub5_grch38_24.json") as fh:
        cfg = json.load(fh)
    cfg["contig_lengths"] = {k: cfg["contig_lengths"][k] for k in CONTIGS}
    cfg.update(SIZES, stack_loci=4, stack_scale_len=SIZES["seq_len"],
               stack_depth=depth)
    return cfg


def edge_stacks(c, lens, depth, seed):
    """``deep_columns`` with three more stacks of ``depth`` gapless
    records: at the end of contig 0, at the start of contig 1 (the two
    touch in the position space) and across the first tile edge of
    contig 2 there (a multiple of tile_device.TILE)."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, dtype=np.int64)
    base = np.cumsum(lens) - lens
    edge = -(-int(base[2]) // tile_device.TILE) * tile_device.TILE
    places = [(0, int(lens[0]) - 340), (1, 0), (2, edge - int(base[2]) - 150)]
    k = len(places) * depth
    qc = np.repeat([p[0] for p in places], depth)
    ln = rng.integers(250, 340, k)
    q = np.clip(np.repeat([p[1] for p in places], depth)
                + rng.integers(0, 31, k), 0, lens[qc] - ln)
    tc = rng.integers(0, len(lens), k)
    more = dict(qc=qc, q=q, fwd=rng.integers(0, 2, k) == 0,
                g=rng.integers(0, 4, k), tc=tc,
                t=rng.integers(0, lens[tc] - ln), score=rng.integers(
                    0, int(c["score"].max()) + 1, k),
                kind=np.zeros(k, dtype=np.int64), m1=ln,
                gap=np.zeros(k, dtype=np.int64),
                m2=np.zeros(k, dtype=np.int64))
    return {key: np.concatenate([c[key], more[key]]) for key in c}


@pytest.fixture(scope="module", params=[(0, 25), (2**31 + 7, 60)],
                ids=["seed0-depth25", "seed2e31-depth60"])
def deep(request, tmp_path_factory):
    """(config, the PAF's path, the records, the table, its order)."""
    seed, depth = request.param
    cfg = config(depth)
    lens, works = synth_deep.genome0(cfg, seed)
    c = edge_stacks(synth_deep.deep_columns(cfg, seed, lens, works), lens,
                    depth, seed)
    paf = tmp_path_factory.mktemp("deep") / "deep.paf"
    paf.write_bytes(synth_deep.paf_text(c, lens, works, 4))
    recs = synth_deep.records(c, lens, works, 4)
    t = pafio.parse_paf_data(paf.read_bytes())
    return cfg, paf, recs, t, tile.tile_sort_order(t)


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


def sweep_tensors(t, order):
    arena_off, run_off, istart, iend, _ = tile.sweep_arguments(t)
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
            for a in (order, arena_off, run_off, istart, iend)]


def test_port_tile_gives_the_references_bytes(deep, tmp_path, cpu_platform):
    _, paf, recs, _, _ = deep
    out = tmp_path / "out.paf"
    assert paffy_main(["tile", "-i", str(paf), "-o", str(out)]) == 0
    want, work = reference_tile.tile_jobs(recs, {}, ["whole"])
    assert out.read_bytes() == want["whole"]
    assert work["whole"][0]["records"] == len(recs["qstart"])
    # the stacks stand on the genomes' records: levels well above 1
    levels = np.array([int(x[5:]) for x in out.read_text().split("\t")
                       if x.startswith("tl:i:")])
    assert levels.max() >= 25 and (levels > 1).mean() > 0.5


@pytest.mark.parametrize("chunk", [8, reference_tile.CHUNK])
def test_blocked_reference_equals_the_whole(deep, chunk, monkeypatch):
    _, _, recs, _, _ = deep
    monkeypatch.setattr(reference_tile, "CHUNK", chunk)
    n = len(recs["qstart"])
    order = np.lexsort((np.arange(n), -recs["score"], -recs["s1"]))
    np.testing.assert_array_equal(reference_tile.tile_levels(recs, order),
                                  reference.tile_levels(recs, order))
    got, _ = reference_tile.tile_jobs(recs, {}, ["whole"])
    assert got["whole"] == reference.serialize(reference.tile(recs))
    by, cuts = reference_tile.blocks(recs)
    assert len(cuts) > 20 and sorted(by.tolist()) == list(range(n))


def test_control_caps_the_levels(deep):
    _, _, recs, _, _ = deep
    n = len(recs["qstart"])
    order = np.lexsort((np.arange(n), -recs["score"], -recs["s1"]))
    levels = reference.tile_levels(recs, order)
    got, _ = reference_tile.tile_jobs(recs, {}, ["whole"], control=True)
    capped = np.where(levels == reference.EMPTY_TILE_LEVEL, levels,
                      np.minimum(levels, reference_tile.CONTROL_CAP))
    assert got["whole"] == reference.serialize(
        reference.take(dict(recs, tl=capped), order))


def budget_for(args, batches: int, tile_size: int) -> int:
    """A HIST_BUDGET in bytes that cuts the plan's rows into ``batches`` or
    more."""
    plan = tile_device.tile_plan(*args, tile=tile_size)
    widest = int(torch.diff(plan.row_off).max())
    return 4 * max(widest, plan.n_bins // (batches + 1))


@pytest.mark.parametrize("tile_size", [1024, tile_device.TILE])
def test_emulation_in_three_batches_or_more(deep, tile_size, monkeypatch):
    _, _, _, t, order = deep
    args = sweep_tensors(t, order)
    monkeypatch.setattr(tile_device, "HIST_BUDGET",
                        budget_for(args, 3, tile_size))
    plan = tile_device.tile_plan(*args, tile=tile_size)
    assert len(plan.batch_off) - 1 >= 3 and plan.carried > 0
    got = tile_device.tile_sweep_tiled_plain(*args, tile=tile_size)
    assert torch.equal(got, tile_device.tile_sweep_plain(*args))


def brute_counts(plan, tile_size, cap=tile_device.SATURATION):
    """batches, bins and carried (tile, later batch) pairs of ``plan``'s
    pairs, counted one pair at a time."""
    m = plan.row_off.numel() - 1
    bins = [0] * m
    batch_of = {}
    b = 0
    for k in range(m):
        while k >= plan.batch_off[b + 1]:
            b += 1
        batch_of[k] = b
    carried = 0
    off, pos = plan.pair_off.tolist(), plan.pair_pos.tolist()
    for j in range(len(off) - 1):
        seen = set()
        for rank, k in enumerate(pos[off[j]: off[j + 1]]):
            bins[k] = max(bins[k], min(rank + 1, cap))
            seen.add(batch_of[k])
        carried += len(seen) - 1
    # the greedy cut: each batch takes rows while they fit the budget
    lim, batches, width = tile_device.HIST_BUDGET // 4, 1, 0
    for w in bins:
        if width + w > lim:
            batches, width = batches + 1, 0
        width += w
    return {"batches": batches, "hist_mb": 4 * sum(bins) / 1e6,
            "carried_mb": 4 * tile_size * carried / 1e6}


@pytest.mark.parametrize("batches", [1, 3, 8])
@pytest.mark.parametrize("tile_size", [1024, tile_device.TILE])
def test_plan_counts_equal_a_brute_force_count(deep, batches, tile_size,
                                               monkeypatch):
    _, _, _, t, order = deep
    args = sweep_tensors(t, order)
    if batches > 1:
        monkeypatch.setattr(tile_device, "HIST_BUDGET",
                            budget_for(args, batches, tile_size))
    plan = tile_device.tile_plan(*args, tile=tile_size)
    got = plan.counts(tile_size)
    assert got == brute_counts(plan, tile_size)
    assert (got["batches"] >= batches) and ((got["carried_mb"] > 0)
                                            == (batches > 1))


def test_genome0_is_synth_genomes_and_the_rule_chip_smokes(tmp_path):
    seed = 2**33 + 5
    cfg = config(40)
    with open(BENCH / "configs" / "hc_grch38_24.json") as fh:
        hc = json.load(fh)
    hc["contig_lengths"] = cfg["contig_lengths"]
    hc.update(SIZES)
    g = synth_genome.genome_inputs(hc, seed, str(tmp_path))
    got = synth_deep.deep_inputs(cfg, seed, str(tmp_path))
    want, recs = g["records"]["gapless"], got["records"]["deep"]
    n, n_ops = len(want["qstart"]), int(want["off"][-1])
    for k, v in want.items():
        part = recs[k][: n_ops if k in ("ops", "lens") else n]
        np.testing.assert_array_equal(part, v if k != "off" else v[:n], k)
    with open(g["files"]["gapless"], "rb") as fh:
        genome = fh.read()
    with open(got["files"]["deep"], "rb") as fh:
        data = fh.read()
    assert data.startswith(genome)
    assert data.count(b"\n") == 4 * n + 4 * 40 == len(recs["qstart"])
    lens, works = synth_deep.genome0(cfg, seed)
    assert data == chip_smoke.deep_tile_input(works, lens, loci=4, stack=40,
                                              seed=seed)
    assert reference.serialize(recs) == data
    assert got["seqs"] == {}


def names_loop(raw, qoff, toff, n):
    """The parse's names one record at a time, as the port took them
    before the pool was split in one pass."""
    def name(at):
        return raw[at: raw.index(b"\0", at)].decode("latin-1")
    return ([name(a) for a in qoff[:n]], [name(a) for a in toff[:n]])


def test_names_split_equals_the_loop(deep):
    raw = b"a\0\0bb\0\xe9t\0" + b"pt.chr21\0g3.hs.chr19\0" * 3
    qoff, toff = np.array([0, 3, 9, 30, 51]), np.array([2, 6, 18, 39, 60])
    for got, want in zip(native._names(raw, qoff, toff, 5),
                         names_loop(raw, qoff, toff, 5)):
        assert got.dtype == object and got.tolist() == want
    _, paf, recs, t, _ = deep
    assert (t.qname == recs["qname"]).all()
    assert (t.tname == recs["tname"]).all()


@pytest.mark.needs_cuda
def test_counters_and_batch_spans_on_the_card(deep, monkeypatch):
    """K5 on the card in three batches or more, under a profiler: the K5
    tiles span carries the plan's counters, equal to the brute-force
    count, each batch has a K5 batch span with its ids, and the levels
    are the sequential sweep's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from paffy_tpu_torch import kernels
    monkeypatch.delenv("PAFFY_TPU_PLATFORM", raising=False)
    _, _, _, t, order = deep
    host = sweep_tensors(t, order)
    monkeypatch.setattr(tile_device, "HIST_BUDGET",
                        budget_for(host, 3, tile_device.TILE))
    plan = tile_device.tile_plan(*host)
    want = brute_counts(plan, tile_device.TILE)
    args = [a.cuda() for a in host]
    before = kernels.LAUNCHES["tile_sweep"]
    n_spans = len(phases.SPANS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        levels = tile_device.tile_sweep(*args)
        torch.cuda.synchronize()
    spans = phases.SPANS[n_spans:]
    assert torch.equal(levels.cpu(), tile_device.tile_sweep_plain(*host))
    assert kernels.LAUNCHES["tile_sweep"] - before == want["batches"] >= 3
    top, = [s for s in spans if s.name == "K5 tiles"]
    assert {k: top.counts[k] for k in want} == pytest.approx(want)
    assert top.counts["waits"] >= want["batches"]
    batch = [s for s in spans if s.name == "K5 batch"]
    assert [s.ids["batch"] for s in batch] == list(range(want["batches"]))
    assert sum(s.ids["records"] for s in batch) == len(order)
    assert sum(s.ids["bins"] for s in batch) == plan.n_bins
