"""The mesh path of paffy_tpu_torch against paffy_tpu's, on the CPU
(PAFFY_TPU_PLATFORM=cpu): paffy_tpu runs on the 8 virtual CPU devices of
tests/conftest.py, the port on a mesh of 8 ``cpu`` slots, so K7 and K5/K6
run their plain PyTorch versions.  Every comparison is exact: the mesh's
shape rule; shard_records' fields; sharded_view_stats' matches,
mismatches and totals (its zero padding included) and
column_counts_multichip on (4,2), (2,4) and (8,1) meshes; K7's plain
version with every seq cut inside a record; chain_groups_device and
assign_tile_levels_sharded per data row; sharded_pipeline_stage and
run_pipeline(mesh=) against paffy_tpu's bytes."""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from paffy_tpu.core import pafio as ref_pafio
from paffy_tpu.ops import chain as ref_chain
from paffy_tpu.ops.chain_device import chain_groups_device as ref_cgd
from paffy_tpu.ops.mismatch import SequencePool as RefPool
from paffy_tpu.ops.tile import (assign_tile_levels_sharded as ref_levels,
                                tile_sort_order as ref_order)
from paffy_tpu.parallel import pipeline as ref_pl
from paffy_tpu.parallel import runner as ref_runner
from paffy_tpu_torch import devconf, kernels
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.ops import compare, group_stats, mismatch, tile
from paffy_tpu_torch.ops.chain import paf_chain
from paffy_tpu_torch.ops.chain_device import chain_groups_device
from paffy_tpu_torch.ops.mismatch_device import build_ext_pool
from paffy_tpu_torch.ops.segments import build_m_column_batch
from paffy_tpu_torch.parallel import pipeline, runner
from ref_native import paffy_tpu_lib  # noqa: F401
from synthdata import make_workload

import chip_smoke

CPU = torch.device("cpu")
MESHES = [(4, 2), (2, 4), (8, 1)]


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def jax_devices():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    return devs[:8]


def both(lines, seqs):
    """(port table, paffy_tpu table, port pool, paffy_tpu pool)."""
    text = "\n".join(lines) + "\n"
    return (pafio.parse_paf_text(text), ref_pafio.parse_paf_text(text),
            mismatch.SequencePool(seqs), RefPool(seqs))


def seed4():
    seqs, lines = make_workload(seed=4, length=8000, n_windows=20,
                                window=1200, step=330)
    return both(lines, seqs)


def renamed(specs, rename=lambda k, f: f"{f}.g{k}"):
    """Workloads of ``specs`` (seed, length, n_windows, window, step), each
    under its own contig names (tests/test_sharding.py:58-76)."""
    all_lines, seqs = [], {}
    for k, (seed, length, nw, w, st) in enumerate(specs):
        s, lines = make_workload(seed=seed, length=length, n_windows=nw,
                                 window=w, step=st)
        ren = {nm: rename(k, nm) for nm in s}
        seqs.update({ren[nm]: v for nm, v in s.items()})
        for ln in lines:
            f = ln.split("\t")
            f[0], f[5] = ren.get(f[0], f[0]), ren.get(f[5], f[5])
            all_lines.append("\t".join(f))
    return all_lines, seqs


def hetero():
    """Two geometries under distinct contig names: groups of very
    different column counts, and a group count that does not divide the
    record count (a copy of tests/test_sharding.py's _hetero_workload)."""
    return both(*renamed([(7, 6000, 9, 700, 410), (8, 30000, 4, 9000,
                                                     5100)]))


def many_queries():
    """Five geometries: ten query contigs for the tile and chain rows."""
    return both(*renamed([(s, 5000 + 700 * s, 6, 900, 500)
                          for s in range(20, 25)]))


WORKLOADS = {"seed4": seed4, "hetero": hetero}


@pytest.mark.parametrize("n", [1, 2, 6, 8])
def test_make_mesh_shapes_match_paffy_tpu(jax_devices, n):
    slots = [CPU] * n
    for dp, sp in [(None, None), (n, None), (1, None), (None, 1)]:
        got = pipeline.make_mesh(slots, dp=dp, sp=sp)
        want = ref_pl.make_mesh(jax_devices[:n], dp=dp, sp=sp)
        assert got.shape == dict(want.shape), (dp, sp)
        assert [len(r) for r in got.devices] == [want.shape["seq"]] * \
            want.shape["data"]
    with pytest.raises(AssertionError):
        ref_pl.make_mesh(jax_devices[:n], dp=n + 1)
    with pytest.raises(AssertionError):
        pipeline.make_mesh(slots, dp=n + 1)


def test_make_mesh_fills_slots_in_order():
    devs = [torch.device("cuda", i) for i in range(8)]    # never touched
    mesh = pipeline.make_mesh(devs, dp=2, sp=4)
    assert mesh.devices == [devs[:4], devs[4:]]
    assert mesh.first == devs[0]
    assert pipeline.make_mesh().devices == [[CPU]]         # devconf's


def test_devices_follow_the_platform(monkeypatch):
    assert devconf.devices() == [CPU]
    monkeypatch.delenv("PAFFY_TPU_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        devconf.devices()


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("n_groups", [1, 3, 4, 8])
def test_shard_records_matches_paffy_tpu(workload, n_groups):
    t, r, pool, rpool = WORKLOADS[workload]()
    got = pipeline.shard_records(t, pool, n_groups)
    want = ref_pl.shard_records(r, rpool, n_groups)
    np.testing.assert_array_equal(got.n_cols, want.n_cols)
    np.testing.assert_array_equal(got.group_of_record, want.group_of_record)
    np.testing.assert_array_equal(got.index_in_group, want.index_in_group)
    assert got.rec_pad == want.rec_pad
    for g, tab in enumerate(got.tables):
        size = int((got.group_of_record == g).sum())
        assert tab[2].sum() == got.n_cols[g]
        assert tab.shape[1] == 0 or 0 <= tab[3].min() <= tab[3].max() < size


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("dp,sp", MESHES)
def test_sharded_view_stats_match_paffy_tpu(jax_devices, workload, dp, sp):
    t, r, pool, rpool = WORKLOADS[workload]()
    b = pipeline.shard_records(t, pool, dp)
    before = dict(kernels.LAUNCHES)
    m, x, totals = pipeline.sharded_view_stats(
        pipeline.make_mesh([CPU] * 8, dp=dp, sp=sp), pool, b)
    assert kernels.LAUNCHES == before       # the CPU runs the plain K7
    want = ref_pl.sharded_view_stats(
        ref_pl.make_mesh(jax_devices, dp=dp, sp=sp), rpool.ext,
        ref_pl.shard_records(r, rpool, dp))
    for got, w in zip((m, x, totals), want):
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, np.asarray(w))


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("dp,sp", MESHES)
def test_column_counts_multichip_match_paffy_tpu(jax_devices, workload, dp,
                                                 sp):
    t, r, pool, rpool = WORKLOADS[workload]()
    m, x, totals = pipeline.column_counts_multichip(
        t, pool, pipeline.make_mesh([CPU] * 8, dp=dp, sp=sp))
    want = ref_pl.column_counts_multichip(
        r, rpool, ref_pl.make_mesh(jax_devices, dp=dp, sp=sp))
    for got, w in zip((m, x, totals), want):
        np.testing.assert_array_equal(got, np.asarray(w))
    m1, x1 = mismatch.column_match_counts(t, pool)
    np.testing.assert_array_equal(m, m1)
    np.testing.assert_array_equal(x, x1)
    assert totals.tolist() == [m1.sum(), x1.sum()]


def test_mesh_shapes_agree_on_uneven_groups():
    t, _, pool, _ = hetero()
    assert len(t) % 4 != 0
    res = [pipeline.column_counts_multichip(
        t, pool, pipeline.make_mesh([CPU] * 8, dp=dp, sp=sp))
        for dp, sp in MESHES]
    for got in res[1:]:
        for a, b in zip(got, res[0]):
            np.testing.assert_array_equal(a, b)


def one_record_table(t, pool, rec):
    """The piece table of record ``rec`` alone, cut every 4096 columns."""
    sub = t.take(np.array([rec]))
    b = build_m_column_batch(sub, pool.offsets_for(sub.qname, "query"),
                             pool.offsets_for(sub.tname, "target"))
    k = b.n_mops
    return compare.build_piece_table(b.lens[:k], b.qpos0[:k], b.tpos0[:k],
                                     b.rev[:k], b.rec[:k], pool.pool_len, 1)


def test_group_stats_plain_sums_over_every_seq_cut():
    # a record whose pieces are cut at every piece boundary into two seq
    # ranges: the two ranges' partial counts add up to the record's matches
    # (piece_match_counts_plain) and columns, whatever the cut
    t, _, pool, _ = seed4()
    rec = int(np.argmax(np.diff(t.off)))     # the most cigar ops
    tab = one_record_table(t, pool, rec)
    assert tab.shape[1] > 8
    ext = pool.ext
    want_m = compare.piece_match_counts_plain(ext, torch.from_numpy(tab), 1)
    m1, x1 = mismatch.column_match_counts(t.take(np.array([rec])), pool)
    assert int(want_m[0]) == m1[0]
    for cut in range(tab.shape[1] + 1):
        outs = [torch.zeros(k, dtype=torch.int64) for k in (1, 1, 2)]
        for part in (tab[:, :cut], tab[:, cut:]):
            group_stats.group_stats(ext, torch.from_numpy(part), *outs)
        assert outs[0].tolist() == [m1[0]], cut
        assert outs[1].tolist() == [m1[0] + x1[0]], cut
        assert outs[2].tolist() == [m1[0], x1[0]], cut


def test_group_stats_plain_slots_and_edge_cases():
    # every K1 edge case, slots = records: equal to K1's plain counts and
    # the per-record columns, added on top of what the outputs held
    for label, c in chip_smoke.k1_edge_cases().items():
        tab = torch.from_numpy(compare.build_piece_table(
            c["lens"], c["qpos0"], c["tpos0"], c["rev"], c["rec"],
            len(c["pool"]), c["n_records"]))
        ext = build_ext_pool(torch.from_numpy(c["pool"]))
        n = c["n_records"]
        match = torch.full((n,), 5, dtype=torch.int64)
        cols = torch.full((n,), 7, dtype=torch.int64)
        totals = torch.tensor([1, 2])
        group_stats.group_stats(ext, tab, match, cols, totals)
        want = compare.piece_match_counts_plain(ext, tab, n)
        want_cols = np.bincount(c["rec"], weights=c["lens"],
                                minlength=n).astype(np.int64)
        assert torch.equal(match - 5, want), label
        np.testing.assert_array_equal((cols - 7).numpy(), want_cols)
        assert totals.tolist() == [1 + int(want.sum()),
                                   2 + int(c["lens"].sum() - want.sum())]


def test_group_stats_refuses_bad_arguments():
    ext = torch.zeros(32, dtype=torch.uint8)
    tab = torch.zeros((4, 1), dtype=torch.int64)
    ok = [torch.zeros(k, dtype=torch.int64) for k in (3, 3, 2)]
    for bad in ([torch.zeros(3, dtype=torch.int32), *ok[1:]],
                [ok[0], torch.zeros(4, dtype=torch.int64), ok[2]],
                [*ok[:2], torch.zeros(3, dtype=torch.int64)]):
        with pytest.raises(ValueError):
            group_stats.group_stats(ext, tab, *bad)
    with pytest.raises(ValueError):
        group_stats.group_stats(ext[:24], tab, *ok)
    with pytest.raises(ValueError):
        group_stats.group_stats(ext, tab.to(torch.int32), *ok)


@pytest.mark.parametrize("n", [0, 1, 5, 13])
@pytest.mark.parametrize("sp", [1, 2, 3, 4])
def test_seq_ranges_cover_the_pieces_in_order(n, sp):
    cols = np.random.default_rng(n + sp).integers(1, 4097, n)
    ranges = pipeline.seq_ranges(cols, sp)
    assert len(ranges) == sp
    assert [a for a, _ in ranges] == [0] + [b for _, b in ranges[:-1]]
    assert ranges[-1][1] == n and all(a <= b for a, b in ranges)
    if n >= sp:   # near-equal columns: no range over its share by a piece
        share = cols.sum() / sp
        assert all(cols[a:b].sum() <= share + 4096 for a, b in ranges)


def chain_cases():
    edge = chip_smoke.k6_edge_cases(scale=0.05)
    rng = np.random.default_rng(5)
    rand = []
    for k in rng.integers(0, 40, 23):
        qs = np.sort(rng.integers(0, 5000, k))
        ln = rng.integers(1, 200, k)
        ts = qs + rng.integers(0, 300, k)
        rand.append((qs, qs + ln, ts, ts + ln, rng.integers(1, 400, k)))
    return {"groups of 0 and 1": edge["groups of 0 and 1"],
            "many groups and a large one": edge["many groups and a large one"],
            "random": (rand, (10, 1, 2000))}


@pytest.mark.parametrize("label", list(chain_cases()))
@pytest.mark.parametrize("dp", [1, 2, 3])
def test_chain_groups_device_rows_match_paffy_tpu(jax_devices, label, dp):
    groups, costs = chain_cases()[label]
    got = chain_groups_device(groups, *costs,
                              mesh=pipeline.make_mesh([CPU] * dp, dp=dp))
    plain = chain_groups_device(groups, *costs)
    jax_mesh = ref_cgd(groups, *costs, mesh=ref_pl.make_mesh(
        jax_devices[:dp], dp=dp, sp=1))
    jax_one = ref_cgd(groups, *costs)
    assert len(got) == len(groups)
    for k, g in enumerate(groups):
        want = ref_chain._dp_numpy(*g, *costs)
        for other in (want, plain[k], jax_mesh[k], jax_one[k]):
            np.testing.assert_array_equal(got[k][0], other[0], err_msg=k)
            np.testing.assert_array_equal(got[k][1], other[1], err_msg=k)


def test_chain_on_a_mesh_matches_paffy_tpu():
    t, r, _, _ = many_queries()
    assert len(set(t.qname)) >= 6
    mesh = pipeline.make_mesh([CPU] * 8, dp=4, sp=2)
    got = paf_chain(t, dp_many=partial(chain_groups_device, mesh=mesh))
    want = ref_chain.paf_chain(r)
    assert bytes(pafio.serialize_paf_bytes(got)) == \
        bytes(ref_pafio.serialize_paf_bytes(want))


@pytest.mark.parametrize("workload", ["many_queries", "hetero"])
@pytest.mark.parametrize("dp", [1, 2, 3, 4])
def test_tile_levels_on_a_mesh_match_paffy_tpu(jax_devices, workload, dp):
    t, r, _, _ = {"many_queries": many_queries, "hetero": hetero}[workload]()
    order = tile.tile_sort_order(t)
    np.testing.assert_array_equal(order, ref_order(r))
    got = tile.assign_tile_levels_sharded(
        t, order, mesh=pipeline.make_mesh([CPU] * dp, dp=dp))
    want = ref_levels(r, order, mesh=ref_pl.make_mesh(jax_devices[:dp],
                                                      dp=dp, sp=1))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tile.assign_tile_levels(t, order))
    assert len(np.unique(got)) > 1


def serialized(t, ref=False):
    return bytes((ref_pafio if ref else pafio).serialize_paf_bytes(t))


@pytest.mark.parametrize("workload", ["hetero", "many_queries"])
def test_sharded_pipeline_stage_matches_paffy_tpu(workload):
    t, r, pool, rpool = {"many_queries": many_queries,
                         "hetero": hetero}[workload]()
    mesh = pipeline.make_mesh([CPU] * 8)
    got = runner.sharded_pipeline_stage(t, pool, mesh)
    assert serialized(got) == serialized(
        ref_runner.pipeline_stage(r, rpool), ref=True)


@pytest.mark.parametrize("n_shards", [1, 3])
def test_run_pipeline_on_a_mesh_matches_paffy_tpu(n_shards):
    lines, seqs = renamed([(s, 5000 + 700 * s, 6, 900, 500)
                           for s in range(20, 25)])
    t, r, _, _ = both(lines, seqs)
    got = runner.run_pipeline(t, seqs, n_shards=n_shards,
                              mesh=pipeline.make_mesh([CPU] * 8, dp=4))
    want = ref_runner.run_pipeline(r, seqs, n_shards=n_shards)
    assert serialized(got) == serialized(want, ref=True)
