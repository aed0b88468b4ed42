"""``tile`` of paffy_tpu_torch against paffy_tpu's, on the CPU
(PAFFY_TPU_PLATFORM=cpu, so K5 runs its plain PyTorch version):
``assign_tile_levels`` gives the levels of paffy_tpu's (its JAX scan on the
CPU) and of the port's C sweep with several query sequences, ties in
(chain_score, score), empty records and saturation (a low cap, held against
the C sweep with the same cap), and raises on inconsistent query lengths;
the plain emulation of the CUDA kernel's decomposition (per-tile counts,
merged histogram rows, then the medians) equals the sequential plain
sweep, paffy_tpu's levels and the C sweep at tiles of 1, 7, 64 and 4096
positions, on chip_smoke.k5_edge_cases and at caps 1, 2 and 5, and, on
records stacked deep, with HIST_BUDGET cut to a few KB so that the sweep
runs in 1, 2 or many batches with its counts carried between them; the
tile plan covers each record's span, bounds its counts and cuts its rows
into batches that fit the budget; chip_smoke.deep_tile_input at a small
size tiles as paffy_tpu tiles it; the command gives the same bytes and
exit codes, including the walk-violation abort that writes nothing.
native.tile_intervals gives each record one interval per maximal stretch
of its touching aligned runs, covering the bases match_intervals' runs
cover, and the CSR of them; on add_mismatches' =/X output it joins many
runs into one, and the levels, in one batch or many, are paffy_tpu's,
the C sweep's and those of the per-run intervals."""

import numpy as np
import pytest
import torch

from paffy_tpu.cli import paffy_main as ref_main
from paffy_tpu.core import pafio as ref_pafio
from paffy_tpu.ops import tile as ref_tile
from paffy_tpu_torch import native
from paffy_tpu_torch.cli import paffy_main as port_main
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.ops import tile, tile_device
from paffy_tpu_torch.ops.coverage import (EMPTY_TILE_LEVEL, SATURATION,
                                          match_intervals)
from ref_native import paffy_tpu_lib  # noqa: F401
from synthdata import make_workload

import chip_smoke

TILES = (1, 7, 64, 4096)


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


def tile_text(seed, n_seqs=3, n_records=40, seq_len=3000, ties=False):
    """Records on n_seqs query sequences with random cigars of M/=/X/I/D
    ops (some of length 0), empty and M-free records, scores drawn from a
    small range (ties) when asked."""
    rng = np.random.default_rng(seed)
    lines = []
    for r in range(n_records):
        qn = f"s{rng.integers(0, n_seqs)}"
        ops, q, tspan = [], 0, 0
        for _ in range(rng.integers(0, 9)):
            op = "MMM=XID"[rng.integers(0, 7)]
            ln = int(rng.integers(0, seq_len // 12))
            ops.append(f"{ln}{op}")
            q += ln if op != "D" else 0
            tspan += ln if op != "I" else 0
        qs = int(rng.integers(0, seq_len - q))
        score = int(rng.integers(0, 3 if ties else 10**6))
        chain = int(rng.integers(0, 2)) if ties else -1
        tags = f"\tAS:i:{score}" + (f"\ts1:i:{chain}" if chain >= 0 else "")
        cg = f"\tcg:Z:{''.join(ops)}" if r % 9 else ""
        if not cg:
            q = tspan = 0
        lines.append(f"{qn}\t{seq_len}\t{qs}\t{qs + q}\t"
                     f"{'+-'[rng.integers(0, 2)]}\tt\t{10**6}\t5\t{5 + tspan}"
                     f"\t{q}\t{max(q, tspan)}\t60{tags}{cg}")
    return "\n".join(lines) + "\n"


def c_sweep(t, order, cap):
    arena_off, run_off, istart, iend, total = tile.sweep_arguments(t)
    return c_sweep_arrays(order, arena_off, run_off, istart, iend, cap,
                          total)


def c_sweep_arrays(order, arena_off, run_off, istart, iend, cap, total):
    """The port's C sweep (its own native library) on sweep arguments."""
    arena = np.zeros(max(total, 1), dtype=np.uint16)
    levels = np.full(len(run_off) - 1, EMPTY_TILE_LEVEL, dtype=np.int64)
    native.tile_sweep(order, arena_off, run_off, istart, iend, arena, cap,
                      levels)
    return levels


@pytest.mark.parametrize("seed,n_seqs,ties", [(1, 1, False), (2, 3, False),
                                              (3, 4, True), (4, 2, True)])
def test_levels_match_jax_scan_and_c_sweep(seed, n_seqs, ties):
    text = tile_text(seed, n_seqs=n_seqs, ties=ties)
    t, r = pafio.parse_paf_text(text), ref_pafio.parse_paf_text(text)
    order = tile.tile_sort_order(t)
    np.testing.assert_array_equal(order, ref_tile.tile_sort_order(r))
    got = tile.assign_tile_levels(t, order)
    np.testing.assert_array_equal(got, ref_tile.assign_tile_levels(r, order))
    np.testing.assert_array_equal(got, c_sweep(t, order, SATURATION))
    assert (got == EMPTY_TILE_LEVEL).any() and len(np.unique(got)) > 2


@pytest.mark.parametrize("cap", [1, 2, 5])
def test_saturation_matches_c_sweep(cap):
    # 60 records over one short sequence: counts pass every low cap
    text = tile_text(5, n_seqs=1, n_records=60, seq_len=900)
    t = pafio.parse_paf_text(text)
    order = tile.tile_sort_order(t)
    got = tile.assign_tile_levels(t, order, cap=cap)
    np.testing.assert_array_equal(got, c_sweep(t, order, cap))
    assert got[got != EMPTY_TILE_LEVEL].max() == cap


def test_inconsistent_query_length_raises():
    text = tile_text(6, n_seqs=1, n_records=5)
    lines = text.splitlines()
    f = lines[3].split("\t")
    f[1] = str(int(f[1]) + 1)
    t = pafio.parse_paf_text("\n".join(lines[:3] + ["\t".join(f)]) + "\n")
    with pytest.raises(ValueError, match="inconsistent lengths"):
        tile.assign_tile_levels(t, tile.tile_sort_order(t))


def test_plain_sweep_counts_and_empty_records():
    # two records on one sequence, one on another, one without bases
    order = torch.tensor([2, 0, 3, 1])
    arena_off = torch.tensor([0, 0, 0, 10])
    run_off = torch.tensor([0, 2, 2, 3, 4])
    istart = torch.tensor([1, 5, 0, 2])
    iend = torch.tensor([3, 6, 4, 6])
    arena = torch.zeros(20, dtype=torch.int16)
    levels = tile_device.tile_sweep(order, arena_off, run_off, istart, iend)
    plain = tile_device.tile_sweep_plain(order, arena_off, run_off, istart,
                                         iend, arena=arena)
    # record 2 covers 0..3 first (level 1); record 0 then counts 2 at 1
    # and 2 and 1 at 5, the 2nd smallest of (1, 2, 2) -> 2; record 3 is
    # alone on its sequence; record 1 has no base
    assert levels.tolist() == plain.tolist() == [2, EMPTY_TILE_LEVEL, 1, 1]
    assert arena[:7].tolist() == [1, 2, 2, 1, 0, 1, 0]
    assert arena[12:16].tolist() == [1, 1, 1, 1]
    for t in TILES:
        assert tile_device.tile_sweep_tiled_plain(
            order, arena_off, run_off, istart, iend, tile=t).tolist() == \
            levels.tolist()


# ------------------------------------------- the kernel's decomposition

def sweep_tensors(t, order):
    arena_off, run_off, istart, iend, total = tile.sweep_arguments(t)
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
            for a in (order, arena_off, run_off, istart, iend)], total


@pytest.mark.parametrize("tile_size", TILES)
@pytest.mark.parametrize("seed,n_seqs,ties", [(2, 3, False), (3, 4, True)])
def test_tiled_emulation_matches_paffy_tpu(tile_size, seed, n_seqs, ties):
    # short sequences keep the one-position tiles few
    text = tile_text(seed, n_seqs=n_seqs, n_records=30, seq_len=1200,
                     ties=ties)
    t, r = pafio.parse_paf_text(text), ref_pafio.parse_paf_text(text)
    order = tile.tile_sort_order(t)
    args, total = sweep_tensors(t, order)
    got = tile_device.tile_sweep_tiled_plain(*args, tile=tile_size).numpy()
    np.testing.assert_array_equal(got, ref_tile.assign_tile_levels(r, order))
    np.testing.assert_array_equal(got, c_sweep(t, order, SATURATION))
    np.testing.assert_array_equal(got, tile_device.tile_sweep_plain(*args))
    assert (got == EMPTY_TILE_LEVEL).any() and len(np.unique(got)) > 2


@pytest.mark.parametrize("tile_size", TILES)
@pytest.mark.parametrize("label", chip_smoke.K5_EDGE_LABELS)
def test_tiled_emulation_on_edge_cases(tile_size, label):
    *host, cap, _ = chip_smoke.k5_edge_cases(scale=0.05)[label]
    args = [torch.from_numpy(a) for a in host]
    got = tile_device.tile_sweep_tiled_plain(*args, cap, tile_size)
    assert torch.equal(got, tile_device.tile_sweep_plain(*args, cap))
    total = int(host[1].max()) + int(host[4].max())
    np.testing.assert_array_equal(got.numpy(), c_sweep_arrays(*host, cap,
                                                              total))
    levels = got[got != EMPTY_TILE_LEVEL]
    assert levels.numel() and (got == EMPTY_TILE_LEVEL).any()
    if label == "saturation inside one tile":
        assert int(levels.max()) == cap


@pytest.mark.parametrize("tile_size", [7, 64])
@pytest.mark.parametrize("cap", [1, 2, 5])
def test_tiled_emulation_saturates(tile_size, cap):
    text = tile_text(5, n_seqs=1, n_records=30, seq_len=500)
    t = pafio.parse_paf_text(text)
    order = tile.tile_sort_order(t)
    args, _ = sweep_tensors(t, order)
    got = tile_device.tile_sweep_tiled_plain(*args, cap, tile_size).numpy()
    np.testing.assert_array_equal(got, c_sweep(t, order, cap))
    assert got[got != EMPTY_TILE_LEVEL].max() == cap


@pytest.mark.parametrize("tile_size", TILES)
def test_tile_plan_covers_spans_and_bounds_counts(tile_size):
    label = "several sequences, tiles across their borders"
    *host, cap, _ = chip_smoke.k5_edge_cases(scale=0.05)[label]
    order, arena_off, run_off, istart, iend = host
    plan = tile_device.tile_plan(*(torch.from_numpy(a) for a in host), cap,
                                 tile_size)
    pair_off, pair_pos = plan.pair_off.tolist(), plan.pair_pos.tolist()
    seen = {}
    for b, t in enumerate(plan.tile_ids.tolist()):
        at = pair_pos[pair_off[b]: pair_off[b + 1]]
        assert at and at == sorted(set(at))
        for k in at:
            seen.setdefault(int(order[k]), []).append(t)
    for r in order.tolist():
        a, e = run_off[r], run_off[r + 1]
        lo = arena_off[r] + (istart[a] if e > a else 0)
        hi = arena_off[r] + (iend[e - 1] if e > a else 0)
        want = list(range(lo // tile_size, (hi - 1) // tile_size + 1)) \
            if hi > lo else []
        assert seen.get(r, []) == want
    # the rows, by processing position, hold every count a record reaches
    # (1 + the records before it covering a base); records outside the
    # order have none
    arena = torch.zeros(int(arena_off.max()) + int(iend.max()),
                        dtype=torch.int16)
    bins = torch.diff(plan.row_off)
    assert bins.numel() == len(order)
    for k, r in enumerate(order.tolist()):
        before = arena.clone()
        tile_device.tile_sweep_plain(torch.tensor([r]),
                                     *(torch.from_numpy(a) for a in host[1:]),
                                     cap, arena=arena)
        grew = arena != before
        if grew.any():
            assert int(arena[grew].max()) <= int(bins[k])
    assert len(np.setdiff1d(np.arange(len(run_off) - 1), order))
    assert plan.n_bins == int(bins.sum())
    assert (plan.batch_off, plan.batch_row) == ([0, len(order)],
                                                [0, plan.n_bins])


def test_tile_plan_refuses_bad_order_and_splits_large_rows(monkeypatch):
    *host, cap, _ = chip_smoke.k5_edge_cases(scale=0.05)[
        chip_smoke.K5_EDGE_LABELS[0]]
    args = [torch.from_numpy(a) for a in host]
    for bad in (torch.cat([args[0], args[0][:1]]), args[0] - 1,
                args[0] + len(host[2])):
        with pytest.raises(ValueError, match="distinct records"):
            tile_device.tile_plan(bad, *args[1:], cap)
    whole = tile_device.tile_plan(*args, cap, 64)
    bins = torch.diff(whole.row_off)
    widest = int(bins.max())
    for budget in (4 * whole.n_bins - 1, 4 * whole.n_bins // 3, 4 * widest):
        monkeypatch.setattr(tile_device, "HIST_BUDGET", budget)
        plan = tile_device.tile_plan(*args, cap, 64)
        # the same pairs and rows, cut into batches that cover the order
        # in order, each one contiguous slice of rows within the budget
        for a, b in zip(plan[:4], whole[:4]):
            assert torch.equal(a, b)
        cuts, rows = plan.batch_off, plan.batch_row
        assert cuts[0] == 0 and cuts[-1] == len(host[0]) and len(cuts) > 2
        assert all(a < b for a, b in zip(cuts, cuts[1:]))
        assert rows == plan.row_off[cuts].tolist()
        assert all(4 * (b - a) <= budget for a, b in zip(rows, rows[1:]))
        # greedy: no batch could take the next record's row as well
        assert all(4 * (plan.row_off[b + 1] - plan.row_off[a]) > budget
                   for a, b in zip(cuts[:-2], cuts[1:-1]))
    assert len(cuts) - 1 > 5
    monkeypatch.setattr(tile_device, "HIST_BUDGET", 4 * widest - 1)
    with pytest.raises(ValueError, match="HIST_BUDGET"):
        tile_device.tile_plan(*args, cap, 64)


# ------------------------------------------------- deep stacks, in batches

def stack_text(seed, n_loci=3, stack=30, n_background=24, seq_len=1500):
    """Stacks of records over a few loci of two query sequences: each
    locus under ``stack`` records of about 120 bases, starting within 8
    bases of it, a third of them with an insertion or deletion in their M
    run and some in =/X ops; ``n_background`` shorter records elsewhere;
    every AS drawn from one range, so the order interleaves the stacks."""
    rng = np.random.default_rng(seed)
    lines = []
    loci = [(f"s{rng.integers(0, 2)}", int(rng.integers(10, seq_len - 150)))
            for _ in range(n_loci)]
    for r in range(n_loci * stack + n_background):
        if r < n_loci * stack:
            qn, at = loci[r % n_loci]
            qs = at + int(rng.integers(-8, 9))
            ln = int(rng.integers(100, 141))
        else:
            qn, ln = f"s{rng.integers(0, 2)}", int(rng.integers(20, 300))
            qs = int(rng.integers(0, seq_len - ln))
        kind, gap = int(rng.integers(0, 4)), int(rng.integers(1, 6))
        m1 = int(rng.integers(ln // 4, 3 * ln // 4))
        if kind == 1:                       # an insertion
            ops, tspan = [f"{m1}M", f"{gap}I", f"{ln - gap - m1}M"], ln - gap
        elif kind == 2:                     # a deletion
            ops, tspan = [f"{m1}M", f"{gap}D", f"{ln - m1}M"], ln + gap
        elif kind == 3:                     # =/X runs
            ops, tspan = [f"{m1}=", f"{gap}X", f"{ln - gap - m1}="], ln
        else:
            ops, tspan = [f"{ln}M"], ln
        lines.append(f"{qn}\t{seq_len}\t{qs}\t{qs + ln}\t"
                     f"{'+-'[rng.integers(0, 2)]}\tt\t{10**6}\t5\t"
                     f"{5 + tspan}\t{ln}\t{ln}\t60\t"
                     f"AS:i:{rng.integers(0, 1000)}\tcg:Z:{''.join(ops)}")
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def stacks():
    """stack_text's table, order, sweep tensors and paffy_tpu's levels."""
    text = stack_text(21)
    t, r = pafio.parse_paf_text(text), ref_pafio.parse_paf_text(text)
    order = tile.tile_sort_order(t)
    np.testing.assert_array_equal(order, ref_tile.tile_sort_order(r))
    args, total = sweep_tensors(t, order)
    return t, order, args, total, ref_tile.assign_tile_levels(r, order)


@pytest.mark.parametrize("tile_size", [7, 64, 4096])
@pytest.mark.parametrize("batches", ["one", "two", "many"])
def test_tiled_emulation_in_batches_matches_paffy_tpu(stacks, monkeypatch,
                                                      tile_size, batches):
    t, order, args, total, ref = stacks
    plan = tile_device.tile_plan(*args, tile=tile_size)
    row_off = plan.row_off.tolist()
    widest = int(torch.diff(plan.row_off).max())
    # "two": the cut that halves the rows most evenly; "many": the
    # smallest budget, the widest row
    half = min(max(r, plan.n_bins - r) for r in row_off)
    budget = {"one": plan.n_bins, "two": max(half, widest),
              "many": widest}[batches]
    monkeypatch.setattr(tile_device, "HIST_BUDGET", 4 * budget)
    got = tile_device.tile_sweep_tiled_plain(*args, tile=tile_size).numpy()
    assert np.abs(got - ref).max() == 0
    np.testing.assert_array_equal(got, tile_device.tile_sweep_plain(*args))
    np.testing.assert_array_equal(got, c_sweep_arrays(
        *(a.numpy() for a in args), SATURATION, total))
    assert got.max() > 20                # the stacks' depth
    n_batches = len(tile_device.tile_plan(*args, tile=tile_size).batch_off) - 1
    assert {"one": n_batches == 1, "two": n_batches == 2,
            "many": n_batches > 5}[batches]
    assert 4 * budget < 64 << 10 and plan.n_bins > 4 * widest


def test_deep_tile_input_in_batches_matches_paffy_tpu(tmp_path, monkeypatch):
    """chip_smoke.deep_tile_input at a small size: its genome 0 is
    genome.paf; the port's tile gives paffy_tpu's bytes; its rows at a
    budget of a quarter of them take several batches, in which the
    emulation gives the sequential sweep's levels."""
    _, paf, lens, works = chip_smoke.build_genome(
        str(tmp_path), native, n_contigs=3, seq_len=400_000, n_records=12,
        m_columns=300_000)
    data = chip_smoke.deep_tile_input(works, lens, loci=4, stack=25)
    genome = (tmp_path / "genome.paf").read_bytes()
    assert data.startswith(genome) and data.count(b"\n") == \
        chip_smoke.DEEP_GENOMES * genome.count(b"\n") + 4 * 25
    deep = tmp_path / "deep.paf"
    deep.write_bytes(data)
    ref, port = both(["tile", "-i", str(deep)], tmp_path)
    assert port == ref and ref[0] == (0, None)
    t = pafio.parse_paf_data(data)
    args, _ = sweep_tensors(t, tile.tile_sort_order(t))
    plan = tile_device.tile_plan(*args, tile=512)
    widest = int(torch.diff(plan.row_off).max())
    monkeypatch.setattr(tile_device, "HIST_BUDGET",
                        4 * max(widest, plan.n_bins // 4))
    assert len(tile_device.tile_plan(*args, tile=512).batch_off) > 4
    got = tile_device.tile_sweep_tiled_plain(*args, tile=512)
    assert torch.equal(got, tile_device.tile_sweep_plain(*args))
    assert int(got.max()) >= 25


# ------------------------------------------------------------ the command

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_tile")
    seqs, lines = make_workload(seed=6, length=15000, n_windows=20,
                                window=2000, step=500)
    (d / "in.paf").write_text("\n".join(lines) + "\n")
    (d / "mixed.paf").write_text(tile_text(7, n_seqs=3, ties=True))
    f = lines[4].split("\t")
    f[3] = str(int(f[3]) - 1)          # the walk no longer ends at qend
    (d / "walk.paf").write_text(
        "\n".join(lines[:4] + ["\t".join(f)] + lines[5:]) + "\n")
    f = lines[6].split("\t")
    f[1] = str(int(f[1]) + 7)          # a second length for one name
    (d / "qlen.paf").write_text(
        "\n".join(lines[:6] + ["\t".join(f)] + lines[7:]) + "\n")
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


@pytest.mark.parametrize("paf", ["in.paf", "mixed.paf"])
def test_tile_cli_matches_paffy_tpu(files, tmp_path, paf):
    ref, port = both(["tile", "-i", str(files / paf)], tmp_path)
    assert port == ref and ref[0] == (0, None)
    assert b"tl:i:2" in ref[1]


@pytest.mark.parametrize("paf", ["walk.paf", "qlen.paf"])
def test_tile_walk_violation_writes_nothing(files, tmp_path, paf):
    ref, port = both(["tile", "-i", str(files / paf)], tmp_path)
    assert port == ref and ref[0][1].startswith("PafCheckError: tile:")
    assert ref[1] is None


def test_tile_of_encoded_input(files, tmp_path):
    # =/X cigars: many short intervals per record
    seqs, _ = make_workload(seed=6, length=15000, n_windows=20, window=2000,
                            step=500)
    fa = tmp_path / "s.fa"
    fa.write_text("".join(f">{k}\n{v}\n" for k, v in seqs.items()))
    am = tmp_path / "am.paf"
    assert ref_main(["add_mismatches", "-i", str(files / "in.paf"), str(fa),
                     "-o", str(am)]) == 0
    ref, port = both(["tile", "-i", str(am)], tmp_path)
    assert port == ref and ref[0] == (0, None)
    assert pafio.parse_paf_data(am.read_bytes()).ops.max() == 4   # X


# ------------------------------------------ the joined intervals of K5

def joined_runs(t):
    """Each record's union of match_intervals' runs as maximal disjoint,
    non-touching intervals, in Python: a list of [(start, end), ...] per
    record."""
    rec, start, end = match_intervals(t)
    out = [[] for _ in range(len(t))]
    for r, a, b in zip(rec.tolist(), start.tolist(), end.tolist()):
        if b <= a:
            continue
        if out[r] and out[r][-1][1] >= a:
            out[r][-1] = (out[r][-1][0], max(out[r][-1][1], b))
        else:
            out[r].append((a, b))
    return out


def test_tile_intervals_joins_touching_runs():
    # 5= 3X 2D 4= touch (the D moves no query base); 1I breaks; 6M, a 0X
    # dropped, 3= touch again; the second record has no aligned base, the
    # third no cigar; the fourth starts where the first ends, and stays
    # its own
    text = ("s0\t100\t10\t32\t+\tt\t1000\t5\t30\t21\t23\t60\t"
            "cg:Z:5=3X2D4=1I6M0X3=\n"
            "s0\t100\t40\t47\t-\tt\t1000\t5\t8\t0\t7\t60\t"
            "cg:Z:4I3D3I0M\n"
            "s1\t100\t0\t9\t+\tt\t1000\t5\t14\t9\t9\t60\n"
            "s0\t100\t32\t35\t+\tt\t1000\t5\t8\t3\t3\t60\t"
            "cg:Z:3=\n")
    t = pafio.parse_paf_text(text)
    run_off, istart, iend, n_runs = native.tile_intervals(
        t.off, t.ops, t.lens, t.qstart)
    assert run_off.tolist() == [0, 2, 2, 2, 3]
    assert list(zip(istart.tolist(), iend.tolist())) == [(10, 22), (23, 32),
                                                         (32, 35)]
    assert n_runs == 8 == len(match_intervals(t)[0])


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_tile_intervals_cover_the_runs_bases(seed):
    text = tile_text(seed, n_seqs=3, n_records=120)
    t = pafio.parse_paf_text(text)
    assert set(t.strand.tolist()) == {True, False}
    run_off, istart, iend, n_runs = native.tile_intervals(
        t.off, t.ops, t.lens, t.qstart)
    rec, _, _ = match_intervals(t)
    assert n_runs == len(rec)
    assert run_off.dtype == istart.dtype == iend.dtype == np.int64
    assert len(run_off) == len(t) + 1 and run_off[0] == 0
    assert run_off[-1] == len(istart) == len(iend)
    assert (np.diff(run_off) >= 0).all()
    want = joined_runs(t)
    for r in range(len(t)):
        a, b = run_off[r], run_off[r + 1]
        s, e = istart[a:b], iend[a:b]
        assert (e > s).all()                        # none empty
        assert (s[1:] > e[:-1]).all()               # ascending, apart
        assert list(zip(s.tolist(), e.tolist())) == want[r]
    # the table holds each kind the join must meet
    has_cigar = np.diff(t.off) > 0
    assert not has_cigar.all() and (np.diff(run_off)[has_cigar] == 0).any()
    assert (t.lens[(t.ops != 1) & (t.ops != 2)] == 0).any()
    assert {1, 2} <= set(t.ops.tolist()) and n_runs > len(istart)


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """add_mismatches' =/X output (paffy_tpu's) of a workload whose
    windows overlap, parsed by both packages."""
    d = tmp_path_factory.mktemp("tile_encoded")
    seqs, lines = make_workload(seed=8, length=20000, n_windows=40,
                                window=2000, step=300)
    fa, paf, am = d / "s.fa", d / "in.paf", d / "am.paf"
    fa.write_text("".join(f">{k}\n{v}\n" for k, v in seqs.items()))
    paf.write_text("\n".join(lines) + "\n")
    assert ref_main(["add_mismatches", "-i", str(paf), str(fa), "-o",
                     str(am)]) == 0
    data = am.read_bytes()
    return pafio.parse_paf_data(data), ref_pafio.parse_paf_data(data)


@pytest.mark.parametrize("batches", ["one", "many"])
def test_encoded_input_joins_runs_and_tiles_as_paffy_tpu(encoded,
                                                         monkeypatch,
                                                         batches):
    t, r = encoded
    assert set(t.ops.tolist()) >= {3, 4}
    order = tile.tile_sort_order(t)
    ref = ref_tile.assign_tile_levels(r, order)
    args, total = sweep_tensors(t, order)
    run_off, istart, _, n_runs = native.tile_intervals(
        t.off, t.ops, t.lens, t.qstart)
    assert n_runs > 4 * len(istart)                 # the join engages
    assert torch.equal(args[2], torch.from_numpy(run_off))
    # the per-run intervals in CSR form give the same levels
    rec, pstart, pend = match_intervals(t)
    per_run = [torch.from_numpy(np.searchsorted(rec, np.arange(len(t) + 1))),
               torch.from_numpy(pstart), torch.from_numpy(pend)]
    np.testing.assert_array_equal(tile.assign_tile_levels(t, order), ref)
    np.testing.assert_array_equal(c_sweep(t, order, SATURATION), ref)
    np.testing.assert_array_equal(
        tile_device.tile_sweep_plain(*args[:2], *per_run).numpy(), ref)
    if batches == "many":
        plan = tile_device.tile_plan(*args, tile=512)
        widest = int(torch.diff(plan.row_off).max())
        monkeypatch.setattr(tile_device, "HIST_BUDGET",
                            4 * max(widest, plan.n_bins // 4))
        assert len(tile_device.tile_plan(*args, tile=512).batch_off) > 4
    got = tile_device.tile_sweep_tiled_plain(*args, tile=512).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, c_sweep_arrays(
        *(a.numpy() for a in args), SATURATION, total))
    assert got[got != EMPTY_TILE_LEVEL].max() > 2
