"""``tile`` of paffy_tpu_torch against paffy_tpu's, on the CPU
(PAFFY_TPU_PLATFORM=cpu, so K5 runs its plain PyTorch version):
``assign_tile_levels`` gives the levels of paffy_tpu's (its JAX scan on the
CPU) and of the port's C sweep with several query sequences, ties in
(chain_score, score), empty records and saturation (a low cap, held against
the C sweep with the same cap), and raises on inconsistent query lengths;
the plain emulation of the CUDA kernel's decomposition (per-tile counts,
merged histogram rows, then the medians) equals the sequential plain
sweep, paffy_tpu's levels and the C sweep at tiles of 1, 7, 64 and 4096
positions, on chip_smoke.k5_edge_cases and at caps 1, 2 and 5; the tile
plan covers each record's span and bounds its counts; the command gives
the same bytes and exit codes, including the walk-violation abort that
writes nothing."""

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
from paffy_tpu_torch.ops.coverage import EMPTY_TILE_LEVEL, SATURATION
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
    pair_off, pair_rec = plan.pair_off.tolist(), plan.pair_rec.tolist()
    rank = {r: k for k, r in enumerate(order.tolist())}
    seen = {}
    for b, t in enumerate(plan.tile_ids.tolist()):
        recs = pair_rec[pair_off[b]: pair_off[b + 1]]
        assert recs and [rank[r] for r in recs] == sorted(rank[r]
                                                          for r in recs)
        for r in recs:
            seen.setdefault(r, []).append(t)
    for r in order.tolist():
        a, e = run_off[r], run_off[r + 1]
        lo = arena_off[r] + (istart[a] if e > a else 0)
        hi = arena_off[r] + (iend[e - 1] if e > a else 0)
        want = list(range(lo // tile_size, (hi - 1) // tile_size + 1)) \
            if hi > lo else []
        assert seen.get(r, []) == want
    # the rows hold every count a record reaches (1 + the records before
    # it covering a base) and are empty for records outside the order
    arena = torch.zeros(int(arena_off.max()) + int(iend.max()),
                        dtype=torch.int16)
    bins = torch.diff(plan.row_off)
    for r in order.tolist():
        before = arena.clone()
        tile_device.tile_sweep_plain(torch.tensor([r]),
                                     *(torch.from_numpy(a) for a in host[1:]),
                                     cap, arena=arena)
        grew = arena != before
        if grew.any():
            assert int(arena[grew].max()) <= int(bins[r])
    outside = np.setdiff1d(np.arange(len(run_off) - 1), order)
    assert len(outside) and (bins[outside] == 0).all()
    assert plan.n_bins == int(bins.sum())


def test_tile_plan_refuses_bad_order_and_large_rows(monkeypatch):
    *host, cap, _ = chip_smoke.k5_edge_cases(scale=0.05)[
        chip_smoke.K5_EDGE_LABELS[0]]
    args = [torch.from_numpy(a) for a in host]
    for bad in (torch.cat([args[0], args[0][:1]]), args[0] - 1,
                args[0] + len(host[2])):
        with pytest.raises(ValueError, match="distinct records"):
            tile_device.tile_plan(bad, *args[1:], cap)
    plan = tile_device.tile_plan(*args, cap, 64)
    monkeypatch.setattr(tile_device, "HIST_BUDGET", 4 * plan.n_bins - 1)
    with pytest.raises(ValueError, match="HIST_BUDGET"):
        tile_device.tile_plan(*args, cap, 64)


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
