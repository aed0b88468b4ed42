#!/usr/bin/env python3
"""Smoke run of paffy_tpu_torch on one NVIDIA GPU: ``paffy view -s``,
``add_mismatches``, ``tile``, ``chain`` and ``trim``, the fused
``add_mismatches | chain | tile | trim`` pipeline, the (data, seq) mesh
path and the multi-process runner, at chromosome scale through the port's
CUDA kernels; every host-only paffy and faffy command at the same scale,
in process and through the native fast lane (bin/paffy-torch); and
``chain`` under the profiler hook (PAFFY_TPU_PROFILE).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (any failure exits non-zero and prints no result line):

1. build   -- nvcc builds csrc/*.cu for sm_90a, one nvcc per source, all
              at once (their -Xptxas -v lines are printed), and g++ the
              native fast lane (native.build_fast) and the port's native
              host library.
2. synth   -- a seeded workload at the scale of a human-chimp chr10 pair:
              two 135 Mbp sequences (soft-masked, with runs of N), 208 PAF
              records, 1.25e8 M columns in runs of median ~420 columns split
              by 1-8 bp indels, 30% '-' strand; written as FASTA and PAF to
              a temporary directory.  Their SHA-256 digests must equal the
              pinned ones (PINS).
3. view    -- the port's ``view -s`` (launch counts reset before it) and
              ``view -s -t`` on cuda:0.  The digests of their outputs must
              equal the pinned digests of paffy_tpu's ``view`` on the same
              files (its host C route), and the aggregate line must agree
              with the synthesized alignment.
4. counts  -- the port's per-record counts against the single-threaded C
              loop (native.column_compare_counts) over independently built
              run arrays; K1 and K2 against their plain PyTorch versions on
              the card at full size, and K1 against its plain version and
              the C loop on its edge cases (k1_edge_cases).
5. add_mismatches -- the port's ``add_mismatches`` (launch counts reset
              before it) on the same files, then ``add_mismatches -a`` on
              its output (a host path); both digests must equal the pinned
              digests of paffy_tpu's output (its host C route).
   batches -- ``view -s`` and ``add_mismatches`` again with the streaming
              batch (commands.common.BATCH_BYTES) cut so that in.paf spans
              MIN_BATCHES batches or more: the same pins, the same kernels
              launched.
6. runs    -- K4 (count and fill) at full size and on its edge cases
              (k4_edge_cases) against its plain versions on the card and
              the C passes native.encode_runs_per_mop and
              native.encode_runs_fill_cigar.
7. tile    -- a tile input made from the encoded PAF (tile_input: each
              record and three shifted copies, 832 records), pinned; the
              port's ``tile`` on it (launch counts reset before it) must
              equal the pinned digest of paffy_tpu's ``tile``; K5's levels
              must equal its plain version on the card and the C sweep
              native.tile_sweep, and span more than one level; K5 against
              both on its edge cases (k5_edge_cases) at their own tiles and
              at K5_EDGE_TILE.
8. chain   -- the chain input: the port's ``shatter`` of in.paf (one
              gapless record per M run, 216,159 records), pinned, and equal
              to chain_input's bytes, made from the synthesis;
              the port's ``chain`` on it (launch counts reset before it)
              must equal the pinned digest of paffy_tpu's ``chain`` and
              launch K6 once.  K6 must equal the C DP (native.chain_dp) at
              full size over both strand sets in one launch, and its plain
              version on the card and the C DP on the first K6_PREFIX
              records of each group and on its edge cases (k6_edge_cases);
              at K6_OTHER_K (2 and 256 recent candidates) it must equal the
              C DP on the prefixes and the edge cases.
9. pipeline -- the port's ``add_mismatches``, ``chain``, ``tile`` and
              ``trim`` one after another on chain_input, with files between
              them, each pinned and each launching its kernels (K6 and K5
              once each); K5 on the pipeline's tile input against its plain
              version (on the host: 216,159 records) and the C sweep; then
              ``run_pipeline`` in process on the same table with a pool
              from the same FASTA, pinned, with its records per second.
   host    -- host_phase through the port's ``paffy_main`` and
              ``faffy_main``: invert, dedupe -a, filter, to_bed, split_file,
              faffy chunk, merge and extract, upconvert and dechunk at full
              size, each output's digest pinned to paffy_tpu's, no kernel
              launched; each command's wall is printed.
   fast lane -- the fast lane's binary, fresh as bin/paffy-torch tests it;
              fast_lane_phase: invert of in.paf and chain.paf, dedupe -a of
              twins.paf, filter -w 1 and -u 0.97, split_file -q -m,
              dechunk of up.paf, shatter of in.paf and trim of the
              pipeline's tile output through bin/paffy-torch in
              subprocesses, each running no Python and each output held to
              the existing pin of the same output; FAST_TIMED on in.paf and
              chain.paf, each timed from process start to exit as the
              binary alone, through the dispatcher and through the Python
              lane (PAFFY_TPU_NO_FAST=1), the lanes' outputs equal; a
              Python-lane dedupe under PYTHONPROFILEIMPORTTIME imports no
              torch module; and view -s and chain through bin/paffy-torch
              on the card, pinned.
   profile -- ``chain`` on chain.paf under PAFFY_TPU_PROFILE (after one
              warm-up run of the profiler, which starts CUPTI): its output
              pinned, one Chrome trace written, holding device events of
              K6; the device's busy time (the union of its kernels, copies
              and sets) over the command's wall is printed.
10. mesh   -- column_counts_multichip on in.paf over a (1,1) mesh of the
              first card, then over 8 slots filled round robin from the
              cards present as (4,2), (8,1) and (2,4) (all cuda:0 on one
              card; the number of distinct cards is printed): its counts
              must equal K1's from the counts phase and the C loop, its
              totals their sums, on every shape, and each run must launch
              K7 once per slot that holds pieces.  K7 against its plain
              version on the card at full size and on k1_edge_cases, each
              table cut into K7_SEQ_RANGES seq ranges (a record's pieces
              then lie in two ranges).  sharded_pipeline_stage and
              run_pipeline on the (4,2) slots on chain_input: pinned (the
              "run_pipeline" pin), launching K6 and K5.
11. multiprocess -- two processes of ``python -m
              paffy_tpu_torch.parallel.distributed chain.paf seqs.fa out.paf
              --shards 2`` in a gloo group on a free localhost port, each
              with a time limit: the output is pinned ("run_pipeline"; one
              contig group, so process 1 runs no shard but joins the
              barriers).
12. timing -- every kernel and its plain version with CUDA events (median
              after warm-up), each beside its bound: the larger of the
              bytes it must move over 3.35 TB/s and, for K6, its integer
              operations over the card's INT32 rate; each command's wall
              time split by phase and its peak device memory.  A kernel's
              ``ms`` is one call at a time between two events, so it
              includes the host's launch work; ``ms_in_a_row`` is the time
              per call of ``in_a_row`` calls (20, fewer for a kernel too
              slow for 20) between two events, which hides that work
              behind the kernels.  K5's timed call includes its plan (the
              (tile, record) list, built on the card), which is also timed
              alone; K5 is also timed at each of K5_TILES, on tile_input
              and on the pipeline's tile input.  K6's timed call is one
              chain run's one launch; its plain version is timed on the
              prefix; K6 is also timed at each K of K6_SWEEP_K and block of
              K6_SWEEP_THREADS.  A command's peak device memory is counted
              above the tensors this script already held.  K7's ``ms`` is the (1,1) mesh's one launch
              over all pieces; ``ms_8_slots_in_a_row`` is the time of the
              (4,2) mesh's 8 launches, 20 times in a row, per 8.

Integer and byte outputs are compared exactly.  The line before the last
is the kernels' JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
This script uses only paffy_tpu_torch, and imports no JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

SEED = 0
SEQ_LEN = 135_000_000
N_RECORDS = 208
M_COLUMNS = 125_000_000
MEDIAN_RUN = 420
REV_SHARE = 0.3
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet

# SHA-256 of the seed-0 synthesis, of paffy_tpu's view, add_mismatches and
# add_mismatches -a output on it (host C routes), of tile_input made from
# that add_mismatches output, and of paffy_tpu's tile on it; of
# chain_input (paffy_tpu's shatter of in.paf), of paffy_tpu's chain on it,
# of its add_mismatches, chain, tile and trim one after another from it,
# and of its run_pipeline on it; of host_phase's outputs through
# paffy_tpu's commands; made by tests/test_torch_host.py --pins
PINS = {
    "seqs.fa": "5e4d5d8787566cbba4677b110e206d3355fdabe151b45a21851ab56c9f6b9c80",
    "in.paf": "056d1e714c15d00b20db3ecc10efba39f4c2322ec8a4b15874d1f08514b2f769",
    "view -s": "c530168cf5970932616ad3eee0f20e7184f6bf0e000ba2ccbac65e6a9c7da473",
    "view -s -t": "91d9b93f69992fcd06510a7276c7d1be03fd3cf71b0d6a5d7638b5b7e0c428eb",
    "add_mismatches": "d637f3b61cf36c9e35548a81e3bec03353fadc91b0b70db89caf1340b8114fcb",
    "add_mismatches -a": "056d1e714c15d00b20db3ecc10efba39f4c2322ec8a4b15874d1f08514b2f769",
    "tile.paf": "66f1524d0fd23042b3855f914d256ee309c45019ee833c1758fa604c788205f8",
    "tile": "e6338aff2b2f86ffde6fc1ec79179640ab28feb310e12d79ed02310b60dbc798",
    "chain.paf": "e4691f7732a3ba5b7e9111e0d0e56f984b93d52d2eafaf63da0712f4e0bc720c",
    "chain": "d8876d0174e3fcb85b02a69c5d835d2af632e22e533fb7bb06faf31ab866248b",
    "pipeline add_mismatches": "028eb4fe3aeafda5389d152bbc7e512ea1a5e6b763ae8a32f915bb7b74463e6a",
    "pipeline chain": "47f3c9bc86f6894f4940e11c210270fa200e83ae42f3b656c2c4678a619c30b6",
    "pipeline tile": "94139344fdb2a669862ae4877a65390594325b39b53262457ce42cb12f3f8bd8",
    "pipeline trim": "4327696a68f292d133479aab577a7d1c79b01c8cc1867d766cc3ef92b4ad05af",
    "run_pipeline": "4327696a68f292d133479aab577a7d1c79b01c8cc1867d766cc3ef92b4ad05af",
    "invert in.paf": "ad0588feffbeace1005c0ce2103210f83561e472429114d8aa5a05ebc402fc09",
    "invert chain.paf": "0f5c7e8bd04ca7e1c90e7e1b3e9daa9988b3f1a5e02af4a666cb2af23e92273d",
    "dedupe -a": "e4691f7732a3ba5b7e9111e0d0e56f984b93d52d2eafaf63da0712f4e0bc720c",
    "filter -w 1": "94139344fdb2a669862ae4877a65390594325b39b53262457ce42cb12f3f8bd8",
    "filter -u 0.97": "4ec6cbe73ed8ce4da7cd88cb5feafa1bb188df3fac97fe070a3686ba2cf930a6",
    "to_bed": "a274b52d6d93605950459a0be4b6b6ef1502277df829fc77eeab1d313f4aec13",
    "to_bed -b -n": "2a9622e2b56b1169411c0b88b619ebc870d3fc88927985f6cf8125bf409d615b",
    "to_bed -e -m 100": "fcae192575259bc2e4baff9d8abdba1066a509053aee62997d52ce7e663119fc",
    "split_file -q -m": "3b49c0a426b40574f2c7044ac5e17d4199cfc5229a708c29e6922599da0c8abe",
    "faffy chunk": "b474c993980996d6534327e607079c7a3bf25ada0eeee64c2c5ceda21be1af65",
    "faffy merge": "253d1a879ebe8e5999945ba6c260ca9d0abfedbf95ac158c8da67e28b16d580b",
    "faffy extract": "84326d84c32022d69743eec4d64f52ce13f98bc44342090cb0b56bc33ab59b51",
    "upconvert": "d8545c03b2fefd6a19a9b682bb9f8ee84a43bd67f91270c5a84f4695706b5b9c",
    "dechunk": "056d1e714c15d00b20db3ecc10efba39f4c2322ec8a4b15874d1f08514b2f769",
}

# the K1 edge cases, see k1_edge_cases
K1_EDGE_LABELS = ("every residue, + strand", "every residue, - strand",
                  "both ends of ext")
# the K4 edge cases, see k4_edge_cases
K4_EDGE_LABELS = K1_EDGE_LABELS[:2] + ("placed flips, + strand",
                                       "placed flips, - strand")
# the tile input, see tile_input
TILE_COPIES = 3
TILE_SHIFT = 250_000
# paffy chain's default costs (-d, -e, -g), K6's arguments on the main path
CHAIN_COSTS = (5000, 1, 1_000_000)
# K6's plain version runs on the first records of each group only
K6_PREFIX = 3000
K6_WIDE = 1024                 # the widest windows of "wide windows" pass it
K6_OTHER_K = (2, 256)          # K6's second and third counts of recent
K6_SWEEP_K = (8, 16, 32, 64)   # the timing sweep of K6's K and block
K6_SWEEP_THREADS = (256, 384, 512)
K5_TILES = (4096, 8192, 16384, 32768, 65536)   # the timing sweep of K5's tile
K5_EDGE_TILE = 7               # K5's edge cases also run at this tile
# K6's operation bound: 32-bit integer instructions per candidate of the
# windows (int64 compare of the slot, tgap and its two bounds, qgap + tgap,
# the zero test, the gap cost's multiply-add, g < score, the value, the
# key compare and the selects of the best), over the H100 SXM's integer
# rate: 132 SMs x 64 INT32 lanes x 1.98 GHz (NVIDIA Hopper white paper)
K6_OPS_PER_CANDIDATE = 30
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# K7's checks cut each piece table into this many seq ranges
K7_SEQ_RANGES = 3
MESH_SHAPES = ((1, 1), (4, 2), (8, 1), (2, 4))
MP_TIMEOUT_S = 300             # each multiprocess run's time limit
# split_file -m of the host phase: both 135 Mbp contigs are "small", and
# the second does not fit the first one's file
SPLIT_MIN_LENGTH = 200_000_000
# the multi-batch runs of view -s and add_mismatches: in.paf in this many
# streaming batches or more
MIN_BATCHES = 4
# the fast lane phase: its pinned runs through bin/paffy-torch, each
# (pin, argv, input file); the input files are in.paf, chain.paf, and
# host_phase's twins.paf and up.paf, and the pipeline's tile output
FAST_RUNS = (
    ("invert in.paf", ["invert"], "in.paf"),
    ("invert chain.paf", ["invert"], "chain.paf"),
    ("dedupe -a", ["dedupe", "-a"], "twins.paf"),
    ("filter -w 1", ["filter", "-w", "1"], "pipe_tile.paf"),
    ("filter -u 0.97", ["filter", "-u", "0.97"], "pipe_tile.paf"),
    ("split_file -q -m", ["split_file", "-q", "-m", str(SPLIT_MIN_LENGTH)],
     "twins.paf"),
    ("dechunk", ["dechunk"], "up.paf"),
    ("chain.paf", ["shatter"], "in.paf"),      # shatter of in.paf
    ("pipeline trim", ["trim"], "pipe_tile.paf"),
)
# its timed runs, on in.paf and on chain.paf (dechunk on their names with
# "|length|0" provenance, see with_provenance), as the binary alone, through
# the dispatcher and through the Python lane
FAST_TIMED = {"invert": ["invert"], "dedupe -a": ["dedupe", "-a"],
              "filter -u 0.97": ["filter", "-u", "0.97"], "trim": ["trim"],
              "shatter": ["shatter"],
              "split_file -q -m": ["split_file", "-q", "-m",
                                   str(SPLIT_MIN_LENGTH)],
              "dechunk": ["dechunk"]}
FAST_REPS = 3
K6_EDGE_LABELS = ("wide windows", "ties, zero gaps, g == score",
                  "tgap at max_gap", "mirrored coordinates", "past 2^40",
                  "groups of 0 and 1", "many groups and a large one")
K5_EDGE_LABELS = ("records across many tiles", "saturation inside one tile",
                  "zero-length intervals and empty records",
                  "several sequences, tiles across their borders")


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ workload

def synth_workload(rng, seq_len, n_records, m_columns):
    """Alignment structure of the records: per-run (record, length, query
    and target start relative to the sequences) and the PAF lines."""
    runs = np.maximum(rng.lognormal(np.log(MEDIAN_RUN), 0.8,
                                    int(m_columns / MEDIAN_RUN * 1.2)), 1)
    runs = runs.astype(np.int64)
    n_runs = int(np.searchsorted(np.cumsum(runs), m_columns)) + 1
    runs = runs[:n_runs]
    cuts = np.sort(rng.choice(np.arange(1, n_runs), n_records - 1,
                              replace=False))
    first = np.zeros(n_runs, dtype=bool)
    first[0] = True
    first[cuts] = True
    run_rec = np.cumsum(first) - 1
    gap = rng.integers(1, 9, n_runs)
    gap[first] = 0
    is_ins = rng.random(n_runs) < 0.5
    ins = np.where(is_ins, gap, 0)
    dele = np.where(is_ins, 0, gap)
    rec_first = np.flatnonzero(first)

    def within_record_start(adv):
        # offset of each run's first column from its record's start
        end = np.cumsum(adv)
        base = (end - adv)[rec_first]
        return end - runs - base[run_rec]
    q_rel = within_record_start(ins + runs)
    t_rel = within_record_start(dele + runs)
    qspan = np.bincount(run_rec, weights=ins + runs).astype(np.int64)
    tspan = np.bincount(run_rec, weights=dele + runs).astype(np.int64)

    def place(span):
        slack = seq_len - int(span.sum())
        assert slack > n_records, "records do not fit the sequences"
        gaps = rng.integers(0, slack // n_records, n_records)
        return np.cumsum(gaps + span) - span
    qs, ts = place(qspan), place(tspan)
    rev_rec = np.zeros(n_records, dtype=bool)
    rev_rec[rng.permutation(n_records)[: int(np.ceil(REV_SHARE * n_records))]] = True
    rev = rev_rec[run_rec]
    qpos = np.where(rev, (qs + qspan - 1)[run_rec] - q_rel,
                    qs[run_rec] + q_rel)
    tpos = ts[run_rec] + t_rel

    tok_len = np.stack([gap, runs], axis=1).ravel()
    tok_op = np.stack([np.where(is_ins, "I", "D"),
                       np.full(n_runs, "M")], axis=1).ravel()
    keep = tok_len > 0
    tokens = np.char.add(tok_len[keep].astype(str), tok_op[keep])
    tok_rec = np.repeat(run_rec, 2)[keep]
    bounds = np.searchsorted(tok_rec, np.arange(n_records + 1))
    mcols = np.bincount(run_rec, weights=runs).astype(np.int64)
    lines = []
    for r in range(n_records):
        cigar = "".join(tokens[bounds[r]: bounds[r + 1]].tolist())
        lines.append(
            f"q_chr\t{seq_len}\t{qs[r]}\t{qs[r] + qspan[r]}\t"
            f"{'-' if rev_rec[r] else '+'}\tt_chr\t{seq_len}\t{ts[r]}\t"
            f"{ts[r] + tspan[r]}\t{mcols[r]}\t{max(qspan[r], tspan[r])}\t60"
            f"\tAS:i:{2 * mcols[r]}\tcg:Z:{cigar}\n")
    return dict(runs=runs, run_rec=run_rec, rev=rev, qpos=qpos, tpos=tpos,
                n_rev=int(rev_rec.sum()), n_ins=int(np.count_nonzero(ins)),
                n_del=int(np.count_nonzero(dele)), lines=lines)


def soft_mask(rng, seq, n_stretches, n_runs_of_n, max_n_run):
    """Runs of N, then lowercase stretches, in place."""
    L = len(seq)
    for s in rng.integers(0, L - max_n_run - 10_000, n_runs_of_n):
        seq[s: s + int(rng.integers(1_000, max_n_run))] = ord("N")
    starts = rng.integers(0, L, n_stretches)
    ends = np.minimum(starts + rng.integers(50, 3_000, n_stretches), L)
    d = np.zeros(L + 1, dtype=np.int32)
    np.add.at(d, starts, 1)
    np.add.at(d, ends, -1)
    lower = np.cumsum(d[:-1], dtype=np.int32) > 0
    seq[lower] |= 0x20
    return float(lower.mean())


def write_fasta(fh, name, seq, width=80):
    fh.write(f">{name}\n".encode())
    full = len(seq) // width
    body = np.empty((full, width + 1), dtype=np.uint8)
    body[:, :width] = seq[: full * width].reshape(full, width)
    body[:, width] = ord("\n")
    fh.write(body.tobytes())
    if len(seq) % width:
        fh.write(seq[full * width:].tobytes() + b"\n")


def build_files(d, native, seq_len=SEQ_LEN, n_records=N_RECORDS,
                m_columns=M_COLUMNS):
    """Write the seeded workload as ``d``/seqs.fa and ``d``/in.paf, with
    ``native`` (a module with ``synth_query_pool``) copying the target
    through the alignment map into the query.  The defaults are the
    chromosome scale; soft-masking scales with ``seq_len``."""
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    w = synth_workload(rng, seq_len, n_records, m_columns)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = acgt[rng.integers(0, 4, 2 * seq_len, dtype=np.uint8)]
    tseq, qseq = seqs[:seq_len], seqs[seq_len:]        # views into seqs
    scale = seq_len / SEQ_LEN
    max_n_run = min(50_000, seq_len // 100)
    t_lower = soft_mask(rng, tseq, int(30_000 * scale),
                        max(int(30 * scale), 1), max_n_run)
    # query bytes through the alignment map (~96.5% of columns copied)
    native.synth_query_pool(seqs, w["runs"], w["qpos"] + seq_len, w["tpos"],
                            w["rev"], keep_per_mille=965, seed=SEED + 7)
    q_lower = soft_mask(rng, qseq, int(20_000 * scale),
                        max(int(20 * scale), 1), max_n_run)
    fa, paf = os.path.join(d, "seqs.fa"), os.path.join(d, "in.paf")
    with open(fa, "wb") as fh:
        write_fasta(fh, "t_chr", tseq)
        write_fasta(fh, "q_chr", qseq)
    with open(paf, "w") as fh:
        fh.writelines(w["lines"])
    log(f"synth: {n_records} records, {int(w['runs'].sum())} M columns in "
        f"{len(w['runs'])} runs (median {int(np.median(w['runs']))}), "
        f"{w['n_rev']} '-' records, {2 * seq_len} sequence bytes, lowercase share "
        f"t {t_lower:.3f} q {q_lower:.3f}, {time.perf_counter() - t0:.1f} s")
    return fa, paf, w


def k1_edge_cases(seed=SEED):
    """K1's edge cases as M runs over a small unguarded pool:
    {label: dict(pool, lens, qpos0, tpos0, rev, rec, n_records)}.

    * every residue: runs of 1, 15, 16, 17, 511, 512 and 513 columns (one
      warp step of 512 target bytes and its edges), 1100, and 4095, 4096,
      4097 and 9000 (the host's cut every 4096 columns), whose target and
      query starts take every pair of residues mod 16, on one strand; only
      every other record has runs, so records without any (empty or
      M-free records) stay at 0.
    * both ends of ext: reverse runs that walk down to pool position 0 (the
      last byte of ext) and forward runs that end at the pool's end.
    """
    rng = np.random.default_rng(seed)
    L = 1 << 15
    pool = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)[
        rng.integers(0, 9, L)].copy()
    lengths = np.array([1, 15, 16, 17, 511, 512, 513, 1100, 4095, 4096, 4097,
                        9000], dtype=np.int64)
    cases = {}
    for label, reverse in zip(K1_EDGE_LABELS[:2], (False, True)):
        lens = np.repeat(lengths, 256)
        k = len(lens)
        t_res = np.tile(np.repeat(np.arange(16), 16), len(lengths))
        q_res = np.tile(np.arange(16), 16 * len(lengths))
        span = (L - int(lengths.max()) - 32) // 16
        tpos0 = 16 * rng.integers(0, span, k) + t_res
        qpos0 = 16 * rng.integers(0, span, k) + q_res
        if reverse:
            qpos0 = qpos0 + lens    # the walk goes down from here
        rec = 2 * (np.arange(k) // 7)
        cases[label] = dict(pool=pool, lens=lens, qpos0=qpos0, tpos0=tpos0,
                            rev=np.full(k, reverse), rec=rec,
                            n_records=int(rec[-1]) + 3)
    lens = np.array([1, 15, 16, 17, 511, 512, 513, 4097, 1, 17, 5000],
                    dtype=np.int64)
    rev = np.arange(len(lens)) < 8
    cases[K1_EDGE_LABELS[2]] = dict(
        pool=pool, lens=lens, qpos0=np.where(rev, lens - 1, L - lens),
        tpos0=np.where(rev, L - lens - 16 * (np.arange(len(lens)) % 3),
                       np.arange(len(lens))),
        rev=rev, rec=np.arange(len(lens)) // 2, n_records=6)
    return cases


def k4_edge_cases(seed=SEED, residues=range(16)):
    """K4's edge cases as M runs over small unguarded pools:
    {label: dict(pool, lens, qpos0, tpos0, rev)}.

    * every residue: k1_edge_cases' runs (1 to 9000 columns, every pair of
      target and query residues mod 16) over its random pool, where about a
      third of the columns flip the match state, so flips fall on, before
      and after the 4096-column cuts and 512-byte window edges alike.
    * placed flips: 9000-column runs at every pair of residues (of
      ``residues``) whose query is the target's copy (its reverse
      complement on the - strand), with one mismatching column at d in
      {-1, 0, +1} (a run per d) from every window edge and cut: the columns
      512 w - (target start mod 16) of the run, w >= 1.
    """
    cases = {k: {f: v for f, v in c.items() if f not in ("rec", "n_records")}
             for k, c in k1_edge_cases(seed).items() if k in K4_EDGE_LABELS}
    rng = np.random.default_rng(seed + 1)
    n_cols = 9000
    res = np.array(list(residues), dtype=np.int64)
    t_res = np.repeat(res, len(res))
    q_res = np.tile(res, len(res))
    comp = dict(zip(b"ACGT", b"TGCA"))
    comp_lut = np.arange(256, dtype=np.uint8)
    for a, b in comp.items():
        comp_lut[a] = b
    for label, reverse in zip(K4_EDGE_LABELS[2:], (False, True)):
        k = 3 * len(t_res)
        stride = 16 * (-(-(n_cols + 32) // 16))
        pool = np.frombuffer(b"ACGT", dtype=np.uint8)[
            rng.integers(0, 4, stride * (k + 1))].copy()
        tpos0 = np.tile(t_res, 3)            # the target: the first stride
        d = np.repeat(np.array([-1, 0, 1]), len(t_res))
        lens = np.full(k, n_cols, dtype=np.int64)
        qpos0 = np.empty(k, dtype=np.int64)
        for j in range(k):
            q0 = stride * (j + 1) + np.tile(q_res, 3)[j]
            tgt = pool[tpos0[j]: tpos0[j] + n_cols]
            edges = np.arange(512, n_cols + 512, 512) - tpos0[j] % 16 + d[j]
            edges = edges[(edges >= 0) & (edges < n_cols)]
            qry = tgt.copy()
            qry[edges] = np.where(qry[edges] == ord("A"), ord("C"), ord("A"))
            if reverse:   # walked down from q0 + n - 1, complemented
                pool[q0: q0 + n_cols] = comp_lut[qry][::-1]
                qpos0[j] = q0 + n_cols - 1
            else:
                pool[q0: q0 + n_cols] = qry
                qpos0[j] = q0
        cases[label] = dict(pool=pool, lens=lens, qpos0=qpos0, tpos0=tpos0,
                            rev=np.full(k, reverse))
    return cases


def tile_input(encoded: bytes, seed=SEED) -> bytes:
    """The tile input made from add_mismatches' output: every record, then
    TILE_COPIES copies of all of them, each copy's qstart and qend shifted
    by one seeded offset in [-TILE_SHIFT, TILE_SHIFT], clamped to keep the
    record inside [0, qlen), and every record's AS drawn anew from the
    seed.  The copies overlap the originals on the query, so the levels
    span more than one value."""
    rng = np.random.default_rng(seed + 11)
    lines = encoded.decode("latin-1").splitlines()
    n = len(lines) * (TILE_COPIES + 1)
    shift = rng.integers(-TILE_SHIFT, TILE_SHIFT + 1, n)
    shift[: len(lines)] = 0
    score = rng.integers(0, 10**6, n)
    out = []
    for r in range(n):
        f = lines[r % len(lines)].split("\t")
        qlen, qs, qe = int(f[1]), int(f[2]), int(f[3])
        sh = min(max(int(shift[r]), -qs), qlen - qe)
        f[2], f[3] = str(qs + sh), str(qe + sh)
        f = [f"AS:i:{score[r]}" if x.startswith("AS:i:") else x for x in f]
        out.append("\t".join(f) + "\n")
    return "".join(out).encode("latin-1")


def chain_input(w, seq_len=SEQ_LEN) -> bytes:
    """The chain input: one gapless record per M run of the synthesis
    ``w`` (build_files), in order, byte for byte paffy_tpu's ``shatter``
    of in.paf: '-' records walk down the query, the run length in fields
    10-11, MAPQ 60, the parent's AS, s1:i:0 and cg:Z:<len>M."""
    runs, rev = w["runs"], w["rev"]
    qs = np.where(rev, w["qpos"] - runs + 1, w["qpos"])
    score = 2 * np.bincount(w["run_rec"], weights=runs).astype(np.int64)
    cols = zip(qs.tolist(), np.where(rev, "-", "+").tolist(),
               w["tpos"].tolist(), runs.tolist(),
               score[w["run_rec"]].tolist())
    return "".join(
        f"q_chr\t{seq_len}\t{q}\t{q + n}\t{s}\tt_chr\t{seq_len}\t{t}\t"
        f"{t + n}\t{n}\t{n}\t60\tAS:i:{a}\ts1:i:0\tcg:Z:{n}M\n"
        for q, s, t, n, a in cols).encode()


def record_bed(paf: bytes) -> str:
    """faffy extract's BED for the host phase: each record's query interval,
    then its target interval, one line each.  Extract pads and coalesces
    them, so every record lies inside one fragment and upconvert can move
    it there."""
    rows = []
    for line in paf.decode("latin-1").splitlines():
        f = line.split("\t")
        rows.append(f"{f[0]}\t{f[2]}\t{f[3]}\n{f[5]}\t{f[7]}\t{f[8]}\n")
    return "".join(rows)


def chunk_digest(listing: bytes, chunk_dir: str) -> str:
    """SHA-256 of faffy chunk's output: its listing with ``chunk_dir``
    written as "chunks", then each listed file's bytes in listing order."""
    h = hashlib.sha256(listing.replace(chunk_dir.encode(), b"chunks"))
    for path in listing.decode().split():
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def files_digest(paths, root: str) -> str:
    """SHA-256 over files: each one's name relative to ``root``, then its
    bytes, in the order given."""
    h = hashlib.sha256()
    for path in paths:
        h.update(os.path.relpath(path, root).encode() + b"\0")
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def host_phase(d, paf, fa, cpaf, tpaf, pipe_tile, paffy, faffy):
    """The host-only commands at full size, through ``paffy`` and ``faffy``
    (a package's ``paffy_main`` and ``faffy_main``), in the directory
    ``d``: invert of in.paf and of chain.paf; dedupe -a of chain.paf
    followed by its inversion (twins.paf: every record has an inverse
    twin); filter -w 1 and -u 0.97 of the pipeline's tile output; to_bed,
    to_bed -b -n and to_bed -e -m 100 of tile.paf; split_file -q -m of
    twins.paf (two contigs, each in a small file of its own); faffy chunk
    of seqs.fa (default sizes), its listing and chunk files; faffy merge of
    the listing; faffy extract of record_bed(in.paf); upconvert of in.paf
    onto those fragments, and dechunk of that.  Returns ({pin: SHA-256 of
    the output}, {pin: wall seconds}); raises unless every command exits
    0."""
    digests, walls = {}, {}

    def run(pin, main, argv, out=None):
        """One command; its output is ``out`` in d, or its stdout."""
        buf = io.TextIOWrapper(io.BytesIO(), encoding="latin-1",
                               write_through=True)
        args = [*argv, "-o", os.path.join(d, out)] if out else argv
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(args)
        walls[pin] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{pin} exited with {rc}")
        if out:
            digests[pin] = sha256_file(os.path.join(d, out))
        return buf.buffer.getvalue()

    def path(name):
        return os.path.join(d, name)

    run("invert in.paf", paffy, ["invert", "-i", paf], "inv_in.paf")
    run("invert chain.paf", paffy, ["invert", "-i", cpaf], "inv_chain.paf")
    twins = path("twins.paf")
    with open(twins, "wb") as fh:
        for src in (cpaf, path("inv_chain.paf")):
            with open(src, "rb") as f:
                fh.write(f.read())
    run("dedupe -a", paffy, ["dedupe", "-a", "-i", twins], "deduped.paf")
    for flags in (["-w", "1"], ["-u", "0.97"]):
        run(f"filter {' '.join(flags)}", paffy,
            ["filter", *flags, "-i", pipe_tile], "filtered.paf")
    for flags in ([], ["-b", "-n"], ["-e", "-m", "100"]):
        run(" ".join(["to_bed", *flags]), paffy,
            ["to_bed", *flags, "-i", tpaf], "cov.bed")
    split_dir = path("split")
    os.makedirs(split_dir)
    run("split_file -q -m", paffy,
        ["split_file", "-q", "-m", str(SPLIT_MIN_LENGTH), "-p",
         os.path.join(split_dir, "part_"), "-i", twins])
    digests["split_file -q -m"] = files_digest(
        sorted(os.path.join(split_dir, f) for f in os.listdir(split_dir)),
        split_dir)
    chunk_dir = path("chunks")
    listing = run("faffy chunk", faffy, ["chunk", "-d", chunk_dir, fa])
    digests["faffy chunk"] = chunk_digest(listing, chunk_dir)
    with open(path("chunks.txt"), "wb") as fh:
        fh.write(listing)
    run("faffy merge", faffy, ["merge", "-i", path("chunks.txt")],
        "merged.fa")
    with open(paf, "rb") as fh, open(path("records.bed"), "w") as out:
        out.write(record_bed(fh.read()))
    run("faffy extract", faffy, ["extract", "-i", path("records.bed"), fa],
        "fragments.fa")
    run("upconvert", paffy, ["upconvert", "-i", paf, path("fragments.fa")],
        "up.paf")
    run("dechunk", paffy, ["dechunk", "-i", path("up.paf")], "dechunked.paf")
    return digests, walls


def with_provenance(paf: bytes) -> bytes:
    """Each record's query and target names as faffy chunk writes a chunk's
    (``name|length|0``): dechunk of the result is ``paf`` again."""
    out = []
    for line in paf.splitlines(keepends=True):
        f = line.split(b"\t")
        f[0] = b"%s|%s|0" % (f[0], f[1])
        f[5] = b"%s|%s|0" % (f[5], f[6])
        out.append(b"\t".join(f))
    return b"".join(out)


# Starts one command and times it from its start to its exit, from a small
# process of its own, as a user's shell starts it: not from chip_smoke.py's
# process, which holds the card's context and gigabytes of pages.  Reads
# [argv, env] as JSON on stdin, writes [seconds, exit code, stderr].
_SPAWN_TIMER = """
import json, subprocess, sys, time
argv, env = json.load(sys.stdin)
t0 = time.perf_counter()
r = subprocess.run(argv, env=env, stdout=subprocess.DEVNULL,
                   stderr=subprocess.PIPE)
json.dump([time.perf_counter() - t0, r.returncode,
           r.stderr.decode("latin-1")], sys.stdout)
"""


def fast_lane_phase(d, files, reps=FAST_REPS):
    """The native fast lane through the dispatcher bin/paffy-torch, in
    subprocesses, in the directory ``d``; ``files`` maps each input name of
    FAST_RUNS to its path.  Each run of FAST_RUNS must exec the binary and
    no Python (PYTHONVERBOSE shows none); each command of FAST_TIMED on
    in.paf and chain.paf is timed from process start to exit (by
    _SPAWN_TIMER), ``reps`` times in each of three lanes: the binary run
    directly ("binary"), through the dispatcher ("fast") and the Python
    lane ("python", PAFFY_TPU_NO_FAST=1), each run exiting 0 with the same
    output in all three; one Python-lane run under PYTHONPROFILEIMPORTTIME
    must import the port's command modules and no torch module (its
    largest imports are printed).  Returns ({pin: SHA-256 of the output},
    {"<lane> <command> <input>": [wall seconds]})."""
    dispatcher = os.path.join(REPO, "bin", "paffy-torch")
    binary = os.path.join(REPO, "paffy_tpu_torch", "_build", "paffy_fast")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PAFFY_TPU_NO_FAST", "PAFFY_TPU_PROFILE",
                        "PAFFY_TPU_FAST_MAX_BYTES", "PAFFY_TPU_PLATFORM",
                        "PYTHONVERBOSE", "PYTHONPROFILEIMPORTTIME")}

    def run(argv, out, extra=None, program=dispatcher):
        """``program argv`` writing ``out`` (a file, or split_file's
        directory), started and timed by _SPAWN_TIMER; returns (wall
        seconds, stderr)."""
        if argv[0] == "split_file":
            os.makedirs(out)
            argv = [*argv, "-p", os.path.join(out, "part_")]
        else:
            argv = [*argv, "-o", out]
        timer = subprocess.run(
            [sys.executable, "-S", "-c", _SPAWN_TIMER], capture_output=True,
            text=True, timeout=600, input=json.dumps(
                [[program, *argv], {**env, **(extra or {})}]))
        if timer.returncode != 0:
            raise AssertionError(timer.stderr[-2000:])
        wall, rc, err = json.loads(timer.stdout)
        if rc != 0:
            raise AssertionError(f"{program} {' '.join(argv)} exited with "
                                 f"{rc}: {err[-2000:]}")
        return wall, err

    def digest(argv, out):
        if argv[0] == "split_file":
            return files_digest(sorted(os.path.join(out, f)
                                       for f in os.listdir(out)), out)
        return sha256_file(out)

    digests, walls = {}, {}
    for k, (pin, argv, name) in enumerate(FAST_RUNS):
        out = os.path.join(d, f"fast_{k}")
        _, err = run([*argv, "-i", files[name]], out, {"PYTHONVERBOSE": "1"})
        if "import '" in err:
            raise AssertionError(f"the fast lane's {pin} ran Python")
        digests[pin] = digest(argv, out)
    for name in ("in.paf", "chain.paf"):
        with open(files[name], "rb") as fh:
            prov = os.path.join(d, f"prov_{name}")
            with open(prov, "wb") as out:
                out.write(with_provenance(fh.read()))
        for label, argv in FAST_TIMED.items():
            src = prov if argv[0] == "dechunk" else files[name]
            seen = set()
            for lane, program, extra in (
                    ("binary", binary, {}), ("fast", dispatcher, {}),
                    ("python", dispatcher, {"PAFFY_TPU_NO_FAST": "1"})):
                key = f"{lane} {label} {name}"
                walls[key] = []
                for r in range(reps):
                    out = os.path.join(d, "timed")
                    walls[key].append(
                        run([*argv, "-i", src], out, extra, program)[0])
                    seen.add(digest(argv, out))
                    if os.path.isdir(out):
                        shutil.rmtree(out)
                    else:
                        os.remove(out)
            if len(seen) != 1:
                raise AssertionError(f"{label} of {name}: the lanes' "
                                     f"outputs differ")
    _, err = run(["dedupe", "-a", "-i", files["in.paf"]],
                 os.path.join(d, "importtime.paf"),
                 {"PAFFY_TPU_NO_FAST": "1", "PYTHONPROFILEIMPORTTIME": "1"})
    rows = [ln.split(":", 1)[1].split("|") for ln in err.splitlines()
            if ln.startswith("import time:")][1:]     # after the header
    mods = [name.strip() for _, _, name in rows]
    # a module's depth in the import tree is its name's indent, 2 a level
    top = sorted(((int(cum), name.strip()) for _, cum, name in rows
                  if len(name) - len(name.lstrip()) <= 3), reverse=True)
    log("the Python lane's dedupe, largest imports of depth 0 and 1 "
        "(cumulative us): " + ", ".join(f"{n} {us}" for us, n in top[:10]))
    if "paffy_tpu_torch.commands.simple" not in mods:
        raise AssertionError("the Python lane's import times name no command "
                             "module of the port")
    torch_mods = [m for m in mods if m == "torch" or m.startswith("torch.")]
    if torch_mods:
        raise AssertionError(f"the Python lane's dedupe imported "
                             f"{torch_mods[:5]}")
    return digests, walls


def k6_edge_cases(seed=SEED, scale=1.0):
    """K6's edge cases: {label: (groups, (gap_open, gap_extend, max_gap))},
    a group being (qs, qe, ts, te, score) int64 arrays in processing order
    (ascending qs).  ``scale`` shrinks the record counts (the CPU tests).

    * wide windows: dense records, so the windows grow from 1 to past
      K6_WIDE at scale 1;
    * ties, zero gaps, g == score: coordinates in [0, 64), scores 3, 4 and
      6 and g = 1 + qgap + tgap: equal values at equal te and qe (the slot
      decides), candidates with a zero total gap, and with g == score;
    * tgap at max_gap: targets on a 50-grid moved by 0 or 1, so tgap hits
      max_gap - 1, max_gap (kept) and max_gap + 1 (dropped);
    * mirrored coordinates: negative query coordinates, as the '-' strand
      set's;
    * past 2^40: colinear chains of records scored ~2^37;
    * groups of 0 and 1: empty and single-record groups among others;
    * many groups and a large one: 2,000 small groups next to one large
      group, in one launch.
    """
    rng = np.random.default_rng(seed + 13)

    def size(n, least=2):
        return max(int(n * scale), least)

    def group(qs, ln, ts, tlen, score):
        order = np.argsort(qs, kind="stable")
        qs, ln, ts, tlen, score = (np.asarray(a, dtype=np.int64)[order]
                                   for a in (qs, ln, ts, tlen, score))
        return qs, qs + ln, ts, ts + tlen, score

    def dense(n, span, max_len, jitter, top, negative=False):
        qs = rng.integers(0, span, n) - (span if negative else 0)
        ln = rng.integers(0, max_len + 1, n)
        ts = qs + (span if negative else 0) + rng.integers(0, jitter, n)
        return group(qs, ln, ts, ln + rng.integers(0, 2, n),
                     rng.integers(1, top, n))

    cases = {}
    cases[K6_EDGE_LABELS[0]] = ([dense(size(3000), size(2000), 4, 8, 3000)],
                                (10, 1, 1000))
    n = size(1000)
    ln = rng.integers(0, 3, n)
    qs = rng.integers(0, 64, n)
    cases[K6_EDGE_LABELS[1]] = ([group(qs, ln, qs + rng.integers(0, 2, n),
                                       ln, rng.choice([3, 4, 6], n))],
                                (1, 1, 6))
    n = size(800)
    qs = 50 * rng.integers(0, 40, n)
    ts = 50 * rng.integers(0, 40, n) + rng.integers(0, 2, n)
    cases[K6_EDGE_LABELS[2]] = ([group(qs, np.full(n, 50), ts,
                                       50 - rng.integers(0, 2, n),
                                       np.full(n, 1000))], (10, 1, 100))
    cases[K6_EDGE_LABELS[3]] = ([dense(size(1000), size(1500), 6, 30, 2000,
                                       negative=True)], (10, 1, 400))
    n = size(200, least=12)
    i = np.arange(n)
    cases[K6_EDGE_LABELS[4]] = ([group(1000 * i, np.full(n, 900),
                                       1000 * i + 7, np.full(n, 900),
                                       (1 << 37) + rng.integers(0, 1000, n))],
                                (5000, 1, 1_000_000))
    cases[K6_EDGE_LABELS[5]] = (
        [dense(k, 30, 3, 4, 40) if k else group(*[[]] * 5)
         for k in (0, 1, 0, 5, 1, 0, 3, 1)], (2, 1, 20))
    small = [dense(k, 40, 3, 4, 40) if k else group(*[[]] * 5)
             for k in rng.integers(0, 6, size(2000, least=20))]
    big = dense(size(2000), size(3000), 4, 8, 3000)
    cases[K6_EDGE_LABELS[6]] = (small[: len(small) // 2] + [big]
                                + small[len(small) // 2:], (10, 1, 1000))
    return cases


def k5_edge_cases(seed=SEED, scale=1.0):
    """K5's edge cases: {label: (order, arena_off, run_off, istart, iend,
    cap, tile)}, int64 arrays but cap and tile: records with ascending,
    disjoint intervals on sequences laid end to end, an order that leaves
    some records out.  ``scale`` shrinks the record counts and spans (the
    CPU tests).

    * records across many tiles: spans of ~6,000 bases at tile 64;
    * saturation inside one tile: 400 records over the same 300 bases of
      one 4,096-base tile, cap 3;
    * zero-length intervals and empty records: a third of the intervals
      of length 0, records without intervals and records whose intervals
      all have length 0, at tile 256;
    * several sequences, tiles across their borders: sequences of 1000,
      37, 5000, 1 and 777 bases at tile 512, so tiles hold the end of one
      sequence and the start of the next.
    """
    rng = np.random.default_rng(seed + 17)

    def size(n, least=2):
        return max(int(n * scale), least)

    def sweep(seq_lens, n, max_iv, span, cap, tile, zero=0.0, empty=0.0,
              at=None):
        seq_lens = np.asarray(seq_lens, dtype=np.int64)
        seq_off = np.cumsum(seq_lens) - seq_lens
        seq = rng.integers(0, len(seq_lens), n)
        starts, ends, counts = [], [], []
        for r in range(n):
            length = int(seq_lens[seq[r]])
            width = min(span, length)
            lo = at if at is not None else int(rng.integers(0, length - width
                                                            + 1))
            k = 0 if rng.random() < empty else int(rng.integers(1, max_iv + 1))
            cuts = np.sort(rng.integers(lo, lo + width + 1, 2 * k))
            s, e = cuts[0::2], cuts[1::2]
            e = np.where(rng.random(k) < zero, s, e)
            if r % 7 == 3:                    # every interval of length 0
                e = s
            starts.append(s)
            ends.append(e)
            counts.append(k)
        run_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        order = rng.permutation(n)[: n - max(n // 20, 1)].astype(np.int64)
        return (order, seq_off[seq].astype(np.int64), run_off,
                np.concatenate(starts).astype(np.int64),
                np.concatenate(ends).astype(np.int64), cap, tile)

    sat = 32766
    return {
        K5_EDGE_LABELS[0]: sweep([size(20_000, 200)], size(300), 40,
                                 size(6_000, 100), sat, 64),
        K5_EDGE_LABELS[1]: sweep([5_000], size(400, 20), 6, 300, 3, 4096,
                                 at=1_000),
        K5_EDGE_LABELS[2]: sweep([size(3_000, 300)] * 2, size(500), 10,
                                 size(2_000, 100), sat, 256, zero=0.3,
                                 empty=0.2),
        K5_EDGE_LABELS[3]: sweep([1000, 37, 5000, 1, 777], size(600), 12,
                                 size(5_000, 500), sat, 512),
    }


# ------------------------------------------------------------------- helpers

def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps, warm=2, batch=1):
    """Milliseconds of one call of ``fn`` on the current stream: the median
    over ``reps`` of CUDA-event times around ``batch`` calls in a row, over
    ``batch``.  With batch=1 the time includes the host's launch work while
    the device waits; back-to-back calls hide it when the device work is
    the longer."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def expect_equal(what, a, b, detail=""):
    if a != b:
        raise AssertionError(f"{what}: {a!r} != {b!r}\n{detail}".rstrip())
    log(f"ok: {what}")


def expect_pin(what, path, pin=None):
    """The digest of ``path`` is PINS[pin or what]."""
    expect_equal(f"SHA-256 of {what} is the pinned one", sha256_file(path),
                 PINS[pin or what])


def run_world(argv, n_proc, timeout, log_dir):
    """``python -m paffy_tpu_torch.parallel.distributed *argv`` as
    ``n_proc`` processes of one gloo group on a free localhost port; raise
    unless every one exits 0 within ``timeout`` seconds in all.  Every
    process is killed on the way out if it still runs."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs = [], [os.path.join(log_dir, f"proc{i}.log")
                       for i in range(n_proc)]
    try:
        for i in range(n_proc):
            env = dict(os.environ, PAFFY_TPU_COORDINATOR=f"localhost:{port}",
                       PAFFY_TPU_NUM_PROCESSES=str(n_proc),
                       PAFFY_TPU_PROCESS_ID=str(i))
            with open(logs[i], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "paffy_tpu_torch.parallel.distributed", *argv],
                    cwd=REPO, env=env, stdout=fh, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, path) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(path) as fh:
                raise AssertionError(f"process {i} of {n_proc} exited with "
                                     f"{p.returncode}:\n{fh.read()[-3000:]}")


# ---------------------------------------------------------------------- main

def k4_check(torch, devconf, native, runs, mismatch_device, pool, lens,
             qpos0, tpos0, rev):
    """K4 on one set of M runs over a guarded or unguarded host ``pool``:
    count and fill against their plain versions on the card and against
    the C passes.  Returns (ext, table, counts, first_out, n_runs, max
    abs error); raises on any difference."""
    dev = devconf.device()
    lens = np.asarray(lens, dtype=np.int64)
    col_off = np.cumsum(lens) - lens
    table_np, piece_off = runs.build_run_table(lens, qpos0, tpos0, rev,
                                               col_off, len(pool))
    ext = mismatch_device.build_ext_pool(devconf.upload(pool, dev))
    table = devconf.upload(table_np, dev)
    counts = runs.run_counts(ext, table)
    counts_plain = runs.run_counts_plain(ext, table)
    err = int((counts.long() - counts_plain.long()).abs().max()) \
        if counts.numel() else 0
    if not torch.equal(counts, counts_plain):
        raise AssertionError("K4 count != its plain version")
    per_piece = devconf.to_host_i64(counts)
    cs = np.concatenate([[0], np.cumsum(per_piece)])
    runs_per_mop = cs[piece_off[1:]] - cs[piece_off[:-1]]
    if not np.array_equal(runs_per_mop, native.encode_runs_per_mop(
            pool, lens, qpos0, tpos0, rev)):
        raise AssertionError("K4 count != native.encode_runs_per_mop")
    n_runs = int(cs[-1])
    first_out = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    starts, states = runs.run_fill(ext, table, first_out, n_runs)
    starts_p, states_p = runs.run_fill_plain(ext, table, first_out, n_runs)
    if n_runs:
        err = max(err, int((starts - starts_p).abs().max()),
                  int((states.int() - states_p.int()).abs().max()))
    if not (torch.equal(starts, starts_p) and torch.equal(states, states_p)):
        raise AssertionError("K4 fill != its plain version")
    new_ops = np.empty(n_runs, dtype=np.uint8)
    new_lens = np.empty(n_runs, dtype=np.int64)
    native.encode_runs_fill_cigar(pool, lens, qpos0, tpos0, rev,
                                  np.cumsum(runs_per_mop) - runs_per_mop,
                                  new_ops, new_lens)
    st = devconf.download(starts)
    if not (np.array_equal(np.where(devconf.download(states) != 0, 3, 4),
                           new_ops)
            and np.array_equal(np.diff(st, append=np.int64(lens.sum())),
                               new_lens)):
        raise AssertionError("K4 fill != native.encode_runs_fill_cigar")
    return ext, table, counts, first_out, n_runs, err


def k5_check(torch, devconf, native, tile_device, host, cap, tile,
             plain_device=None):
    """K5 at ``tile`` on one sweep's host arguments (order, arena_off,
    run_off, istart, iend): its levels against its plain version (on the
    card, or on ``plain_device``) and the C sweep.  Returns (device
    arguments, levels on the host, max abs error); raises on any
    difference."""
    dev = devconf.device()
    args = [devconf.upload(a, dev) for a in host]
    lv = tile_device.tile_sweep(*args, cap, tile)
    plain_args = args if plain_device is None else [
        torch.from_numpy(a).to(plain_device) for a in host]
    lv_p = tile_device.tile_sweep_plain(*plain_args, cap).to(lv.device)
    err = int((lv - lv_p).abs().max()) if lv.numel() else 0
    if not torch.equal(lv, lv_p):
        raise AssertionError("K5 != its plain version")
    order, arena_off, run_off, istart, iend = host
    size = int(arena_off.max(initial=0)) + int(iend.max(initial=0))
    lv_c = np.full(len(run_off) - 1, 32767, dtype=np.int64)
    native.tile_sweep(order, arena_off, run_off, istart, iend,
                      np.zeros(max(size, 1), dtype=np.uint16), cap, lv_c)
    lv_h = devconf.to_host_i64(lv)
    if not np.array_equal(lv_h, lv_c):
        raise AssertionError("K5 != native.tile_sweep")
    return args, lv_h, err


def k6_check(devconf, native, chain, chain_device, groups, costs,
             plain=True, k=None):
    """K6 on one launch's ``groups`` (both strand sets, or an edge case),
    with ``k`` recent candidates (None: the default): (cs, pred) against
    the C DP group by group and, with ``plain``, against its plain version
    on the card.  Returns (device arguments, the host arguments, cs, max
    abs error); raises on any difference."""
    dev = devconf.device()
    host = chain.dp_arguments(groups, costs[2])
    args = [devconf.upload(a, dev) for a in host]
    cs, pred = chain_device.chain_dp_groups(
        *args, *costs, k=k or chain_device.K6_RECENT)
    err = 0
    if plain:
        cs_p, pred_p = chain_device.chain_dp_groups_plain(*args, *costs)
        if len(cs):
            err = max(int((cs - cs_p).abs().max()),
                      int((pred - pred_p).abs().max()))
        if not (cs.equal(cs_p) and pred.equal(pred_p)):
            raise AssertionError("K6 != its plain version on the card")
    want_cs, want_pred = [np.zeros(0, dtype=np.int64)], [
        np.zeros(0, dtype=np.int64)]
    for g, c0 in zip(groups, host[0][:-1]):
        qe_order, lo, hi = chain._window_bounds(g[0], g[1], costs[2])
        c, p = native.chain_dp(*g, qe_order, lo, hi, *costs)
        want_cs.append(c)
        want_pred.append(np.where(p >= 0, p + c0, -1))
    if not (np.array_equal(devconf.to_host_i64(cs), np.concatenate(want_cs))
            and np.array_equal(devconf.to_host_i64(pred),
                               np.concatenate(want_pred))):
        raise AssertionError("K6 != native.chain_dp")
    return args, host, cs, err


def k7_check(torch, devconf, group_stats, pipeline, ext, table_np, n_slots):
    """K7 over one piece table cut into K7_SEQ_RANGES seq ranges, every
    range added into the same outputs, against its plain version on the
    card.  Returns (match, cols, totals, whether some slot's pieces lie in
    two ranges, max abs error); raises on any difference."""
    outs = [[torch.zeros(k, dtype=torch.int64, device=ext.device)
             for k in (n_slots, n_slots, 2)] for _ in range(2)]
    straddles = False
    for lo, hi in pipeline.seq_ranges(table_np[2], K7_SEQ_RANGES):
        part = devconf.upload(table_np[:, lo:hi], ext.device)
        group_stats.group_stats(ext, part, *outs[0])
        group_stats.group_stats_plain(ext, part, *outs[1])
        straddles |= bool(0 < lo < hi and
                          table_np[3, lo - 1] == table_np[3, lo])
    err = max(int((a - b).abs().max()) for a, b in zip(*outs))
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("K7 != its plain version on the card")
    return (*(devconf.to_host_i64(o) for o in outs[0]), straddles, err)


def device_busy(trace_path, kernel):
    """(busy seconds, {kind: device microseconds}, microseconds and count
    of the events of ``kernel``) of a Chrome trace of torch.profiler:
    busy is the union of the device events' intervals (kernels, copies
    and sets)."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                 "gpu_memset")
           and "dur" in e]
    by_cat: dict = {}
    for e in dev:
        by_cat[e["cat"]] = by_cat.get(e["cat"], 0.0) + float(e["dur"])
    mine = [float(e["dur"]) for e in dev
            if e["cat"] == "kernel" and kernel in e.get("name", "")]
    busy, end = 0.0, None
    for ts, dur in sorted((float(e["ts"]), float(e["dur"])) for e in dev):
        if end is None or ts >= end:
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    return busy / 1e6, by_cat, sum(mine), len(mine)


def run(torch) -> dict:
    import argparse
    from paffy_tpu_torch import devconf, kernels, native, phases
    from paffy_tpu_torch.cli import faffy_main, paffy_main
    from paffy_tpu_torch.commands import common
    from paffy_tpu_torch.core import pafio
    from paffy_tpu_torch.ops import (chain, chain_device, compare,
                                     group_stats, mismatch, mismatch_device,
                                     runs, tile, tile_device)
    from paffy_tpu_torch.ops.coverage import SATURATION
    from paffy_tpu_torch.ops.segments import build_m_column_batch
    from paffy_tpu_torch.parallel import pipeline, runner

    os.environ.pop("PAFFY_TPU_PLATFORM", None)
    dev = devconf.device()
    gpu = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; python {sys.version.split()[0]}; "
        f"numpy {np.__version__}")

    log("== build")
    cached = kernels.library_path().exists()
    t0 = time.perf_counter()
    kernels.build()
    log(f"nvcc {'build found in the cache:' if cached else 'built'} "
        f"{kernels.library_path().name} from "
        f"{[p.name for p in kernels.sources()]} in "
        f"{time.perf_counter() - t0:.1f} s:")
    log(kernels.build_log().rstrip())
    t0 = time.perf_counter()
    fast = native.build_fast()
    log(f"g++ {fast.name} (the fast lane) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    native.get_lib()
    log(f"g++ {native.library_path().name} in {time.perf_counter() - t0:.1f} s")

    walls, phase_split, launches, peaks = {}, {}, {}, {}

    def measure(tag, fn):
        """``fn()`` in process, its launch counts set to 0 just before and
        read just after; its wall, phases and peak device memory (above
        this script's own tensors) are kept under ``tag``."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        phases.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        launches[tag] = dict(kernels.LAUNCHES)
        phase_split[tag] = dict(phases.SECONDS)
        peaks[tag] = torch.cuda.max_memory_allocated() - held
        return out

    def drive(tag, argv, out, pin=None):
        """One command of the port through ``measure``; its output's
        digest must be PINS[pin or tag]."""
        rc = measure(tag, lambda: paffy_main([*argv, "-o", out]))
        expect_equal(f"port {tag} exit code", rc, 0)
        expect_pin(tag, out, pin)
        log(f"launches during the port's {tag}: {launches[tag]}")

    def launched(tag, names, once=()):
        """Each kernel of ``names`` was launched by the port's ``tag``, and
        each of ``once`` exactly once."""
        for k in names:
            if launches[tag][k] <= 0:
                raise AssertionError(f"kernel {k} was not launched by the "
                                     f"port's {tag}")
        for k in once:
            expect_equal(f"{k} launches during the port's {tag}",
                         launches[tag][k], 1)

    with tempfile.TemporaryDirectory(prefix="paffy_smoke_") as d:
        log("== synth")
        fa, paf, w = build_files(d, native)
        expect_pin("seqs.fa", fa)
        expect_pin("in.paf", paf)

        log("== view")
        for tag, flags in (("view -s", ["-s"]), ("view -s -t", ["-s", "-t"])):
            ours = os.path.join(d, "ours.txt")
            drive(tag, ["view", "-i", paf, *flags, fa], ours)
            with open(ours, "rb") as fh:
                last = fh.read().decode().splitlines()[-1]
            log(f"{tag}: {last}")
        fields = dict(kv.split(":", 1) for kv in last.split("\t")
                      if ":" in kv)
        expect_equal("Total-alignments", int(fields["Total-alignments"]),
                     N_RECORDS)
        expect_equal("Query-inserts", int(fields["Query-inserts"]),
                     w["n_ins"])
        expect_equal("Query-deletes", int(fields["Query-deletes"]),
                     w["n_del"])
        expect_equal("Aligned-bases == M columns",
                     int(fields["Aligned-bases"]), int(w["runs"].sum()))
        launched("view -s", ("piece_compare", "build_ext"))

        log("== counts")
        pool = mismatch.SequencePool.from_fasta_files([fa])
        g = pool._guard
        qoff, toff = pool.index["q_chr"][0] + g, pool.index["t_chr"][0] + g
        with open(paf, "rb") as fh:
            t = pafio.parse_paf_data(fh.read())
        m_port, x_port = mismatch.column_match_counts(t, pool)
        m_c, x_c = native.column_compare_counts(
            pool.host_pool, w["runs"], w["qpos"] + qoff, w["tpos"] + toff,
            w["rev"], w["run_rec"], N_RECORDS)
        expect_equal("per-record matches == C loop",
                     np.array_equal(m_port, m_c), True)
        expect_equal("per-record mismatches == C loop",
                     np.array_equal(x_port, x_c), True)
        match_rate = m_c.sum() / (m_c.sum() + x_c.sum())
        log(f"column match rate {match_rate:.4f}")

        raw = devconf.upload(pool.host_pool, dev)
        ext = mismatch_device.build_ext_pool(raw)
        ext_plain = mismatch_device.build_ext_pool_plain(raw)
        k2_err = int((ext.int() - ext_plain.int()).abs().max())
        expect_equal("K2 == plain on the card", torch.equal(ext, ext_plain),
                     True)
        del ext_plain
        b = build_m_column_batch(t, pool.offsets_for(t.qname, "query"),
                                 pool.offsets_for(t.tname, "target"))
        k = b.n_mops
        table_np = compare.build_piece_table(
            b.lens[:k], b.qpos0[:k], b.tpos0[:k], b.rev[:k], b.rec[:k],
            pool.pool_len, len(t))
        table = devconf.upload(table_np, dev)
        m_k = compare.piece_match_counts(ext, table, len(t))
        m_p = compare.piece_match_counts_plain(ext, table, len(t))
        k1_err = int((m_k - m_p).abs().max())
        expect_equal("K1 == plain on the card", torch.equal(m_k, m_p), True)
        expect_equal("K1 == C loop", np.array_equal(devconf.to_host_i64(m_k),
                                                    m_c), True)
        n_cols, n_pieces = int(b.n_cols), int(table_np.shape[1])

        for label, c in k1_edge_cases().items():
            tab = compare.build_piece_table(
                c["lens"], c["qpos0"], c["tpos0"], c["rev"], c["rec"],
                len(c["pool"]), c["n_records"])
            e = mismatch_device.build_ext_pool(devconf.upload(c["pool"], dev))
            tab_d = devconf.upload(tab, dev)
            got = compare.piece_match_counts(e, tab_d, c["n_records"])
            plain = compare.piece_match_counts_plain(e, tab_d,
                                                     c["n_records"])
            m_edge, _ = native.column_compare_counts(
                c["pool"], c["lens"], c["qpos0"], c["tpos0"], c["rev"],
                c["rec"], c["n_records"])
            k1_err = max(k1_err, int((got - plain).abs().max()))
            expect_equal(f"K1 == plain == C loop on its edge case {label} "
                         f"({tab.shape[1]} pieces)",
                         torch.equal(got, plain) and np.array_equal(
                             devconf.to_host_i64(got), m_edge), True)

        log("== add_mismatches")
        am = os.path.join(d, "am.paf")
        drive("add_mismatches", ["add_mismatches", "-i", paf, fa], am)
        launched("add_mismatches", ("build_ext", "run_counts", "run_fill"))
        drive("add_mismatches -a", ["add_mismatches", "-a", "-i", am],
              os.path.join(d, "am_a.paf"))
        with open(am, "rb") as fh:
            encoded = fh.read()
        log(f"add_mismatches wrote {len(encoded)} bytes")

        log("== batches")
        # view -s and add_mismatches again, in.paf in several streaming
        # batches
        bb = os.path.getsize(paf) // (MIN_BATCHES + 1)
        n_batches = sum(1 for _ in common.stream_tables(
            argparse.Namespace(inputFile=paf), batch_bytes=bb,
            parse_cigars=False))
        expect_equal(f"in.paf spans {MIN_BATCHES} or more batches of {bb} "
                     f"bytes ({n_batches})", n_batches >= MIN_BATCHES, True)
        saved = common.BATCH_BYTES
        common.BATCH_BYTES = bb
        try:
            drive("view -s in batches", ["view", "-i", paf, "-s", fa],
                  os.path.join(d, "ours.txt"), pin="view -s")
            drive("add_mismatches in batches", ["add_mismatches", "-i", paf,
                                                fa],
                  os.path.join(d, "am_batches.paf"), pin="add_mismatches")
        finally:
            common.BATCH_BYTES = saved
        launched("view -s in batches", ("piece_compare", "build_ext"))
        launched("add_mismatches in batches", ("build_ext", "run_counts",
                                               "run_fill"))

        log("== runs")
        k = b.n_mops
        _, table4, counts4, first_out4, n_runs, k4_err = k4_check(
            torch, devconf, native, runs, mismatch_device, pool.host_pool,
            b.lens[:k], b.qpos0[:k], b.tpos0[:k], b.rev[:k])
        n_pieces4 = int(table4.shape[1])
        log(f"ok: K4 count and fill == plain on the card == C passes at full "
            f"size: {n_runs} runs over {n_cols} columns in {n_pieces4} "
            f"pieces")
        for label, c in k4_edge_cases().items():
            *_, n_edge, err = k4_check(
                torch, devconf, native, runs, mismatch_device, c["pool"],
                c["lens"], c["qpos0"], c["tpos0"], c["rev"])
            k4_err = max(k4_err, err)
            log(f"ok: K4 count and fill == plain == C passes on its edge case "
                f"{label} ({len(c['lens'])} runs, {n_edge} =/X runs)")

        log("== tile")
        tpaf = os.path.join(d, "tile.paf")
        with open(tpaf, "wb") as fh:
            fh.write(tile_input(encoded))
        expect_pin("tile.paf", tpaf)
        drive("tile", ["tile", "-i", tpaf], os.path.join(d, "tiled.paf"))
        launched("tile", ("tile_sweep",), once=("tile_sweep",))
        with open(tpaf, "rb") as fh:
            tt = pafio.parse_paf_data(fh.read())
        k5_host = (tile.tile_sort_order(tt), *tile.sweep_arguments(tt)[:4])
        k5_args, lv_h, k5_err = k5_check(torch, devconf, native, tile_device,
                                         k5_host, SATURATION,
                                         tile_device.TILE)
        log("ok: K5 levels == plain on the card == C sweep on tile_input")
        levels_seen = np.unique(lv_h)
        expect_equal("K5 levels span more than one value",
                     len(levels_seen) > 1, True)
        istart, iend = k5_host[3], k5_host[4]
        n_bases = int((iend - istart).sum())
        n_iv = len(istart)
        log(f"tile: {len(tt)} records, {n_iv} intervals, {n_bases} aligned "
            f"bases, levels {levels_seen.tolist()}")
        plan = tile_device.tile_plan(*k5_args)
        log(f"K5 plan on tile_input at tile {tile_device.TILE}: "
            f"{plan.tile_ids.numel()} tiles, {plan.pair_rec.numel()} (tile, "
            f"record) pairs, histogram rows {4 * plan.n_bins} bytes")
        for label, (*host, cap, tl) in k5_edge_cases().items():
            for at in (tl, K5_EDGE_TILE):
                *_, err = k5_check(torch, devconf, native, tile_device, host,
                                   cap, at)
                k5_err = max(k5_err, err)
                plan = tile_device.tile_plan(
                    *(devconf.upload(a, dev) for a in host), cap, at)
                log(f"ok: K5 == plain == C sweep on its edge case {label} at "
                    f"tile {at} (cap {cap}, {len(host[2]) - 1} records, "
                    f"{len(host[3])} intervals, {plan.pair_rec.numel()} "
                    f"(tile, record) pairs over {plan.tile_ids.numel()} "
                    f"tiles)")

        log("== chain")
        # the chain input is the port's shatter of in.paf; chain_input
        # writes the same bytes from the synthesis
        cpaf = os.path.join(d, "chain.paf")
        drive("shatter", ["shatter", "-i", paf], cpaf, pin="chain.paf")
        with open(cpaf, "rb") as fh:
            expect_equal("the port's shatter of in.paf == chain_input",
                         fh.read() == chain_input(w), True)
        drive("chain", ["chain", "-i", cpaf], os.path.join(d, "chained.paf"))
        launched("chain", ("chain_dp",), once=("chain_dp",))
        with open(cpaf, "rb") as fh:
            tc = pafio.parse_paf_data(fh.read(), parse_cigars=False)
        # both strand sets' groups in one launch, '+' first, as the chain
        groups = [g for gs in chain.chain_groups(tc) for g in gs]
        k6_full, host, cs, _ = k6_check(devconf, native, chain, chain_device,
                                        groups, CHAIN_COSTS, plain=False)
        k6_windows, k6_records = int(host[8].sum()), len(host[1])
        log(f"ok: K6 == C chain DP at full size, both strand sets in one "
            f"launch: groups of {np.diff(host[0]).tolist()} records, sum of "
            f"window widths {k6_windows} (median {int(np.median(host[8]))}, "
            f"max {int(host[8].max())}), largest chain score "
            f"{int(cs.max())}")
        prefix = [tuple(a[:K6_PREFIX] for a in g) for g in groups]
        k6_prefix, *_, k6_err = k6_check(devconf, native, chain,
                                         chain_device, prefix, CHAIN_COSTS)
        log(f"ok: K6 == plain on the card == C chain DP on the first "
            f"{K6_PREFIX} records of each group")
        for label, (groups, costs) in k6_edge_cases().items():
            _, host, _, err = k6_check(devconf, native, chain, chain_device,
                                       groups, costs)
            k6_err = max(k6_err, err)
            log(f"ok: K6 == plain == C chain DP on its edge case {label} "
                f"({len(groups)} groups, {int(host[0][-1])} records, "
                f"widest window {int(host[8].max(initial=0))})")
        for k in K6_OTHER_K:
            k6_check(devconf, native, chain, chain_device, prefix,
                     CHAIN_COSTS, plain=False, k=k)
            for label, (groups, costs) in k6_edge_cases().items():
                k6_check(devconf, native, chain, chain_device, groups, costs,
                         plain=False, k=k)
            log(f"ok: K6 at K = {k} == C chain DP on the prefixes and every "
                f"edge case")

        log("== pipeline")
        steps = (("add_mismatches", [fa]), ("chain", []), ("tile", []),
                 ("trim", []))
        src = cpaf
        for cmd, extra in steps:
            out = os.path.join(d, f"pipe_{cmd}.paf")
            drive(f"pipeline {cmd}", [cmd, "-i", src, *extra], out)
            src = out
        launched("pipeline add_mismatches", ("build_ext", "run_counts",
                                             "run_fill"))
        launched("pipeline chain", ("chain_dp",), once=("chain_dp",))
        launched("pipeline tile", ("tile_sweep",), once=("tile_sweep",))
        # K5 on the pipeline's tile input, the chained chain_input
        with open(os.path.join(d, "pipe_chain.paf"), "rb") as fh:
            tpc = pafio.parse_paf_data(fh.read())
        k5_pipe_host = (tile.tile_sort_order(tpc),
                        *tile.sweep_arguments(tpc)[:4])
        t0 = time.perf_counter()
        k5_pipe_args, _, err = k5_check(
            torch, devconf, native, tile_device, k5_pipe_host, SATURATION,
            tile_device.TILE, plain_device=torch.device("cpu"))
        k5_err = max(k5_err, err)
        plan = tile_device.tile_plan(*k5_pipe_args)
        log(f"ok: K5 == plain (on the host) == C sweep on the pipeline's "
            f"tile input, {len(tpc)} records ({time.perf_counter() - t0:.1f}"
            f" s); at tile {tile_device.TILE}: {plan.tile_ids.numel()} "
            f"tiles, {plan.pair_rec.numel()} (tile, record) pairs, "
            f"histogram rows {4 * plan.n_bins} bytes")
        del tpc, plan
        with open(cpaf, "rb") as fh:
            tp = pafio.parse_paf_data(fh.read())
        piped = measure("run_pipeline", lambda: runner.run_pipeline(
            tp, mismatch.SequencePool.from_fasta_files([fa]), n_shards=1))
        rp = os.path.join(d, "run_pipeline.paf")
        with open(rp, "wb") as fh:
            fh.write(pafio.serialize_paf_bytes(piped))
        expect_pin("run_pipeline", rp)
        launched("run_pipeline", ("build_ext", "run_counts", "run_fill",
                                  "chain_dp", "tile_sweep"),
                 once=("chain_dp", "tile_sweep"))
        log(f"launches during run_pipeline: {launches['run_pipeline']}")
        log(f"run_pipeline: {len(tp)} records in "
            f"{walls['run_pipeline']:.4f} s, "
            f"{len(tp) / walls['run_pipeline']:.1f} records/s")
        del piped

        log("== host")
        hd = os.path.join(d, "host")
        os.makedirs(hd)
        kernels.reset_launch_counts()
        digests, host_walls = host_phase(
            hd, paf, fa, cpaf, tpaf, os.path.join(d, "pipe_tile.paf"),
            paffy_main, faffy_main)
        for pin, digest in digests.items():
            expect_equal(f"SHA-256 of the port's {pin} is the pinned one",
                         digest, PINS[pin])
        expect_equal("kernel launches during the host commands",
                     sum(kernels.LAUNCHES.values()), 0)
        for pin, sec in host_walls.items():
            log(f"host {pin}: {sec:.4f} s wall")
        log(f"host commands: {sum(host_walls.values()):.4f} s wall in all")

        log("== fast lane")
        expect_equal("the fast lane's link", native.build_fast(), fast)
        expect_equal("the fast lane is newer than its sources",
                     native.fast_is_fresh(), True)
        fd = os.path.join(d, "fast")
        os.makedirs(fd)
        digests, fast_walls = fast_lane_phase(fd, {
            "in.paf": paf, "chain.paf": cpaf,
            "twins.paf": os.path.join(hd, "twins.paf"),
            "up.paf": os.path.join(hd, "up.paf"),
            "pipe_tile.paf": os.path.join(d, "pipe_tile.paf")})
        for pin, digest in digests.items():
            expect_equal(f"SHA-256 of the fast lane's {pin} is the pinned one",
                         digest, PINS[pin])
        for key, secs in fast_walls.items():
            log(f"{key}: median {statistics.median(secs)} s from process "
                f"start to exit (host time), runs {secs}")
        log("fast lane walls: " + json.dumps(
            {"gpu": gpu, "host_seconds": fast_walls}))
        # the dispatcher's Python lane (python3 -S, site-packages put back
        # by bin/paffy-torch-py) runs the device commands on the card
        for pin, argv in (("view -s", ["view", "-s", "-i", paf, fa]),
                          ("chain", ["chain", "-i", cpaf])):
            out = os.path.join(fd, "device.out")
            t0 = time.perf_counter()
            r = subprocess.run(
                [os.path.join(REPO, "bin", "paffy-torch"), *argv, "-o", out],
                capture_output=True, timeout=600,
                env={k: v for k, v in os.environ.items()
                     if not k.startswith("PAFFY_TPU_")})
            wall = time.perf_counter() - t0
            expect_equal(f"bin/paffy-torch {pin} exit code", r.returncode, 0,
                         r.stderr[-2000:].decode(errors="replace"))
            expect_pin(f"bin/paffy-torch {pin}", out, pin)
            log(f"bin/paffy-torch {pin}: {wall} s from process start to "
                f"exit")
        shutil.rmtree(fd)
        shutil.rmtree(hd)

        log("== profile")
        # CUPTI's start-up on the process's first profiler run (seconds)
        # stays out of the command's wall: a warm-up run first
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).sum().item()
        log(f"profiler warm-up: {time.perf_counter() - t0:.4f} s")
        prof_dir = os.path.join(d, "traces")
        os.environ["PAFFY_TPU_PROFILE"] = prof_dir
        try:
            drive("chain under the profiler", ["chain", "-i", cpaf],
                  os.path.join(d, "chained.paf"), pin="chain")
        finally:
            os.environ.pop("PAFFY_TPU_PROFILE")
        launched("chain under the profiler", ("chain_dp",),
                 once=("chain_dp",))
        traces = os.listdir(prof_dir)
        expect_equal("traces written", len(traces), 1)
        busy, by_cat, k6_us, k6_n = device_busy(
            os.path.join(prof_dir, traces[0]), "chain_dp")
        expect_equal("K6 device events in the trace", k6_n >= 1, True)
        prof_wall = walls["chain under the profiler"]
        log(f"profile of chain: {traces[0]}; device busy {busy:.6f} s of "
            f"the command's {prof_wall:.4f} s wall under the profiler: "
            f"busy share {busy / prof_wall:.4%}, idle share "
            f"{1 - busy / prof_wall:.4%}; of chain's {walls['chain']:.4f} s "
            f"without it: {busy / walls['chain']:.4%}; K6 {k6_us / 1e3:.4f} "
            f"ms in {k6_n} event(s); device time by kind (ms): "
            f"{ {k: round(v / 1e3, 4) for k, v in by_cat.items()} }")

        log("== mesh")
        cards = devconf.devices()
        log(f"distinct cards: {len(cards)} "
            f"{[torch.cuda.get_device_name(c) for c in cards]}")
        slots = [cards[i % len(cards)] for i in range(8)]
        for dp, sp in MESH_SHAPES:
            tag = f"column_counts_multichip {dp}x{sp}"
            mesh = pipeline.make_mesh(slots[: dp * sp], dp=dp, sp=sp)
            with_pieces = sum(
                hi > lo for tab in pipeline.shard_records(t, pool, dp).tables
                for lo, hi in pipeline.seq_ranges(tab[2], sp))
            m_mesh, x_mesh, tot_mesh = measure(
                tag, lambda: pipeline.column_counts_multichip(t, pool, mesh))
            expect_equal(f"{tag} on {mesh.devices}: matches and mismatches "
                         f"== K1's == C loop",
                         np.array_equal(m_mesh, m_port)
                         and np.array_equal(x_mesh, x_port)
                         and np.array_equal(m_mesh, m_c)
                         and np.array_equal(x_mesh, x_c), True)
            expect_equal(f"{tag}: totals", tot_mesh.tolist(),
                         [int(m_c.sum()), int(x_c.sum())])
            expect_equal(f"{tag}: K7 launches == slots with pieces",
                         launches[tag]["group_stats"], with_pieces)
        b1 = pipeline.shard_records(t, pool, 1)
        tab7 = b1.tables[0]
        m7, c7, tot7, straddles, k7_err = k7_check(
            torch, devconf, group_stats, pipeline, pool.ext, tab7,
            b1.rec_pad)
        expect_equal(f"K7 == plain on the card == C loop at full size, "
                     f"{K7_SEQ_RANGES} seq ranges of {tab7.shape[1]} pieces",
                     np.array_equal(m7[:N_RECORDS], m_c)
                     and np.array_equal(c7[:N_RECORDS], m_c + x_c)
                     and not m7[N_RECORDS:].any()
                     and tot7.tolist() == [m_c.sum(), x_c.sum()], True)
        expect_equal("a record's pieces lie in two seq ranges", straddles,
                     True)
        for label, c in k1_edge_cases().items():
            tab = compare.build_piece_table(
                c["lens"], c["qpos0"], c["tpos0"], c["rev"], c["rec"],
                len(c["pool"]), c["n_records"])
            e = mismatch_device.build_ext_pool(devconf.upload(c["pool"], dev))
            m_e, c_e, tot_e, _, err = k7_check(
                torch, devconf, group_stats, pipeline, e, tab,
                c["n_records"])
            m_edge, x_edge = native.column_compare_counts(
                c["pool"], c["lens"], c["qpos0"], c["tpos0"], c["rev"],
                c["rec"], c["n_records"])
            k7_err = max(k7_err, err)
            expect_equal(f"K7 == plain == C loop on K1's edge case {label} "
                         f"in {K7_SEQ_RANGES} seq ranges",
                         np.array_equal(m_e, m_edge)
                         and np.array_equal(c_e, m_edge + x_edge)
                         and tot_e.tolist() == [m_edge.sum(), x_edge.sum()],
                         True)
        mesh42 = pipeline.make_mesh(slots, dp=4, sp=2)
        tag = "sharded_pipeline_stage 4x2"
        staged = measure(tag, lambda: runner.sharded_pipeline_stage(
            tp, mismatch.SequencePool.from_fasta_files([fa]), mesh42))
        sp_out = os.path.join(d, "sharded_stage.paf")
        with open(sp_out, "wb") as fh:
            fh.write(pafio.serialize_paf_bytes(staged))
        expect_pin(tag, sp_out, pin="run_pipeline")
        launched(tag, ("chain_dp", "tile_sweep"))
        tag = "run_pipeline 4x2"
        piped = measure(tag, lambda: runner.run_pipeline(
            tp, mismatch.SequencePool.from_fasta_files([fa]), n_shards=1,
            mesh=mesh42))
        rp_out = os.path.join(d, "run_pipeline_mesh.paf")
        with open(rp_out, "wb") as fh:
            fh.write(pafio.serialize_paf_bytes(piped))
        expect_pin(tag, rp_out, pin="run_pipeline")
        launched(tag, ("build_ext", "run_counts", "run_fill", "chain_dp",
                       "tile_sweep"))
        log(f"launches during {tag}: {launches[tag]}")
        del staged, piped, tp

        log("== multiprocess")
        mp_out = os.path.join(d, "multiprocess.paf")
        t0 = time.perf_counter()
        run_world([cpaf, fa, mp_out, "--shards", "2", "--workdir",
                   os.path.join(d, "mp_shards")], 2, MP_TIMEOUT_S, d)
        mp_wall = time.perf_counter() - t0
        expect_pin("two processes of parallel.distributed", mp_out,
                   pin="run_pipeline")
        log(f"two processes of parallel.distributed on chain.paf: "
            f"{mp_wall:.4f} s wall, from their start to their exit")

        log("== timing")

        def k1():
            return compare.piece_match_counts(ext, table, len(t))

        def k2():
            return mismatch_device.build_ext_pool(raw)

        def k4c():
            return runs.run_counts(ext, table4)

        def k4f():
            return runs.run_fill(ext, table4, first_out4, n_runs)

        def k5(args, tl=tile_device.TILE):
            return lambda: tile_device.tile_sweep(*args, SATURATION, tl)

        def k6(args, k=chain_device.K6_RECENT,
               threads=chain_device.K6_THREADS):
            # the K6 work of one chain run: one launch
            return lambda: chain_device.chain_dp_groups(
                *args, *CHAIN_COSTS, k=k, threads=threads)

        # K7: the (1,1) mesh's one launch; the (4,2) mesh's 8 launches
        tab7_d = devconf.upload(tab7, dev)
        out7 = [torch.zeros(k, dtype=torch.int64, device=dev)
                for k in (b1.rec_pad, b1.rec_pad, 2)]
        slot_args = []
        for tab in pipeline.shard_records(t, pool, 4).tables:
            row_out = [torch.zeros_like(o) for o in out7]
            slot_args += [(devconf.upload(tab[:, lo:hi], dev), row_out)
                          for lo, hi in pipeline.seq_ranges(tab[2], 2)
                          if hi > lo]

        def k7_slots():
            for tab_d, o in slot_args:
                group_stats.group_stats(ext, tab_d, *o)
        timed = {
            "piece_compare": (k1, lambda: compare.piece_match_counts_plain(
                ext, table, len(t))),
            "build_ext": (k2, lambda: mismatch_device.build_ext_pool_plain(
                raw)),
            "run_counts": (k4c, lambda: runs.run_counts_plain(ext, table4)),
            "run_fill": (k4f, lambda: runs.run_fill_plain(
                ext, table4, first_out4, n_runs)),
            "tile_sweep": (k5(k5_args), lambda: tile_device.tile_sweep_plain(
                *k5_args)),
            "chain_dp": (k6(k6_full), lambda: chain_device.
                         chain_dp_groups_plain(*k6_prefix, *CHAIN_COSTS)),
            "group_stats": (
                lambda: group_stats.group_stats(ext, tab7_d, *out7),
                lambda: group_stats.group_stats_plain(ext, tab7_d, *out7)),
        }
        # bytes each kernel must move: K1 reads 2 bytes of ext per column
        # and 32 bytes of table per piece and writes 8 bytes per record; K2
        # reads the pool (L) and writes ext (2L); K4 count reads 2 bytes
        # per column and 40 of table per piece and writes 4 per piece; the
        # fill reads the same plus 8 bytes of first index per piece and
        # writes 9 bytes per run; K5 reads 16 bytes per interval (istart,
        # iend) and 8 each of run_off, arena_off and the order per record,
        # and writes 8 of level per record (its counts are the kernel's own
        # and never need to leave the chip); K6 reads 9 int64 per record
        # (qs, ts, score, lo, w, pos; qe_s, te_s, idx_s) and writes 2 (cs,
        # pred); K7 reads K1's bytes and writes 16 per slot (match, cols)
        # and 16 of totals
        nbytes = {
            "piece_compare": 2 * n_cols + table_np.nbytes + 8 * len(t),
            "build_ext": 3 * raw.numel(),
            "run_counts": (2 * n_cols + table4.numel() * 8
                           + 4 * n_pieces4),
            "run_fill": (2 * n_cols + table4.numel() * 8 + 8 * n_pieces4
                         + 9 * n_runs),
            "tile_sweep": 16 * n_iv + 32 * len(tt),
            "chain_dp": 88 * k6_records,
            "group_stats": 2 * n_cols + tab7.nbytes + 16 * b1.rec_pad + 16,
        }
        n_ops = {"chain_dp": K6_OPS_PER_CANDIDATE * k6_windows}
        ms, row_ms, in_a_row, plain_ms, bound_ms, bound_by = (
            {}, {}, {}, {}, {}, {})
        for name, (fn, plain) in timed.items():
            ms[name] = cuda_ms(torch, fn, reps=20)
            # 20 in a row, unless 3 batches of 20 would pass 15 s
            in_a_row[name] = (20 if ms[name] <= 250 else
                              max(2, int(15_000 / (3 * ms[name]))))
            row_ms[name] = cuda_ms(torch, fn, reps=7, batch=in_a_row[name])
            plain_ms[name] = cuda_ms(torch, plain, reps=5, warm=1)
            by_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
            by_ops = n_ops.get(name, 0) / INT32_OPS_PER_S * 1e3
            bound_ms[name] = max(by_bytes, by_ops)
            bound_by[name] = "operations" if by_ops > by_bytes else "bytes"
            log(f"{name}: {ms[name]:.4f} ms one call at a time "
                f"({bound_ms[name] / ms[name]:.2%} of bound), "
                f"{row_ms[name]:.4f} ms a call {in_a_row[name]} in a row "
                f"({bound_ms[name] / row_ms[name]:.2%}), plain "
                f"{plain_ms[name]:.4f} ms; {nbytes[name]} bytes "
                f"({by_bytes:.4f} ms at 3.35 TB/s), {n_ops.get(name, 0)} "
                f"integer operations ({by_ops:.4f} ms at "
                f"{INT32_OPS_PER_S:.4g}/s); bound {bound_ms[name]:.4f} ms "
                f"by {bound_by[name]}")
        k7_slots_ms = cuda_ms(torch, k7_slots, reps=7, batch=20)
        log(f"group_stats over the (4,2) mesh's {len(slot_args)} slots: "
            f"{k7_slots_ms:.4f} ms for the {len(slot_args)} launches, 20 in "
            f"a row, against {row_ms['group_stats']:.4f} ms for the (1,1) "
            f"mesh's one launch")
        k6_prefix_ms = cuda_ms(torch, k6(k6_prefix), reps=5)
        k6_plain_records = int(k6_prefix[1].numel())
        log(f"chain_dp on the prefix ({k6_plain_records} records, where "
            f"plain_ms is taken): {k6_prefix_ms:.4f} ms; at full size "
            f"{k6_records} records, {k6_windows} candidates in the windows, "
            f"{K6_OPS_PER_CANDIDATE} integer operations each")
        sweep_ms = {}
        for k in K6_SWEEP_K:
            for threads in K6_SWEEP_THREADS:
                sweep_ms[f"chain_dp K={k} threads={threads}"] = cuda_ms(
                    torch, k6(k6_full, k, threads), reps=5)
        for tl in K5_TILES:
            for what, args in (("tile_input", k5_args),
                               ("the pipeline's tile input", k5_pipe_args)):
                sweep_ms[f"tile_sweep tile={tl} on {what}"] = cuda_ms(
                    torch, k5(args, tl), reps=7)
        for what, args in (("tile_input", k5_args),
                           ("the pipeline's tile input", k5_pipe_args)):
            sweep_ms[f"tile_sweep's plan alone on {what}"] = cuda_ms(
                torch, lambda: tile_device.tile_plan(*args), reps=7)
        for what, t_ms in sweep_ms.items():
            log(f"{what}: {t_ms:.4f} ms one call at a time")
        log(f"K1 over {n_cols} columns, {n_pieces} pieces; K2 over "
            f"{raw.numel()} pool bytes; K4 over {n_cols} columns, "
            f"{n_pieces4} pieces, {n_runs} runs; K5 over {len(tt)} records, "
            f"{n_iv} intervals, {n_bases} aligned bases (the old kernel's "
            f"count traffic, 4 bytes per aligned base, would be "
            f"{4 * n_bases / HBM_BYTES_PER_S * 1e3:.4f} ms more at 3.35 "
            f"TB/s), its plan inside its timed call; K6 over {k6_records} "
            f"records in one launch")
        for tag in walls:
            split = ", ".join(f"{k} {v:.4f}" for k, v in
                              phase_split[tag].items())
            log(f"port {tag}: {walls[tag]:.4f} s wall ({split}); peak device "
                f"memory {peaks[tag] / 2**20:.1f} MiB above what this script "
                f"held before it")
        log(f"view -s: {n_cols / walls['view -s'] / 1e6:.1f} Mcol/s end to "
            f"end")
        log(f"two processes of parallel.distributed: {mp_wall:.4f} s wall")
        log(gpu)

    errs = {"piece_compare": k1_err, "build_ext": k2_err,
            "run_counts": k4_err, "run_fill": k4_err, "tile_sweep": k5_err,
            "chain_dp": k6_err, "group_stats": k7_err}
    sources = {"piece_compare": "piece_compare.cu", "build_ext": "ext_pool.cu",
               "run_counts": "encode_runs.cu", "run_fill": "encode_runs.cu",
               "tile_sweep": "tile_sweep.cu", "chain_dp": "chain_dp.cu",
               "group_stats": "group_stats.cu"}
    replaces = {"piece_compare": "paffy_tpu/ops/pallas_compare.py:161",
                "build_ext": "paffy_tpu/ops/mismatch_device.py:47",
                "run_counts": "paffy_tpu/ops/tiled.py:302",
                "run_fill": "paffy_tpu/ops/tiled.py:307",
                "tile_sweep": "paffy_tpu/ops/tile_device.py:23",
                "chain_dp": "paffy_tpu/ops/chain_device.py:26",
                "group_stats": "paffy_tpu/parallel/pipeline.py:126"}
    path_of = {"piece_compare": "view -s", "build_ext": "view -s",
               "run_counts": "add_mismatches", "run_fill": "add_mismatches",
               "tile_sweep": "tile", "chain_dp": "chain",
               "group_stats": "column_counts_multichip 1x1"}
    # K6's plain version runs on the prefix only
    sweeps = {name: {k: v for k, v in sweep_ms.items() if k.startswith(name)}
              for name in ("tile_sweep", "chain_dp")}
    extra = {"tile_sweep": {"sweep_ms": sweeps["tile_sweep"]},
             "chain_dp": {"plain_records": k6_plain_records,
                          "ms_at_plain_records": k6_prefix_ms,
                          "sweep_ms": sweeps["chain_dp"]},
             "group_stats": {"ms_8_slots_in_a_row": k7_slots_ms,
                             "slot_launches": len(slot_args)}}
    return {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"paffy_tpu_torch/csrc/{sources[name]}",
         "replaces": replaces[name],
         "launches": launches[path_of[name]][name],
         "max_abs_err": errs[name], "ms": ms[name],
         "ms_in_a_row": row_ms[name], "in_a_row": in_a_row[name],
         "plain_ms": plain_ms[name], "bound_ms": bound_ms[name],
         "bound_by": bound_by[name], "library_ms": None,
         **extra.get(name, {})}
        for name in timed]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "paffy_tpu_torch", "csrc")):
        print("chip_smoke: run from the root of a paffy-tpu checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    record = run(torch)
    loaded = sorted(m for m in sys.modules if m == "jax"
                    or m.startswith("jax.") or m == "paffy_tpu"
                    or m.startswith("paffy_tpu."))
    if loaded:
        raise AssertionError(f"modules of JAX or paffy_tpu were loaded: "
                             f"{loaded[:5]}")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
