#!/usr/bin/env python3
"""Smoke run of paffy_tpu_torch on one NVIDIA GPU: ``paffy view -s`` (also
over full 256 MiB streaming batches) and ``view -a``, ``add_mismatches``,
``tile``, ``chain`` and ``trim``, the fused ``add_mismatches | chain | tile
| trim`` pipeline (also in worker threads and on a mesh over a many-contig
genome), the package's library surface, the (data, seq) mesh path and the
multi-process runner, at chromosome scale through the port's CUDA
kernels; every host-only paffy and faffy command at the same scale, in
process and through the native fast lane (bin/paffy-torch); and ``chain``
under the profiler hook (PAFFY_TPU_PROFILE).

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
   render  -- ``view -a`` of the first records of in.paf whose rendering
              passes RENDER_SLICES - 1 slices of commands.view's 64 MiB
              (render_input): its digest pinned, the rendering cut into
              RENDER_SLICES slices or more (native.view_render_batch
              counted), K1 and K2 launched.
6. runs    -- K4 (the count, and the fill of the =/X cigar at its final
              slots) at full size, in in.paf's cigar, and on its edge cases
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
              at K5_EDGE_TILE; then tile_input and the edge cases again
              with tile_device.HIST_BUDGET cut so that each sweep runs in
              several batches (k5_batched_check), their counts carried
              between the launches.
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
   library -- library_phase: the package's exports as a program uses
              them (pt.pafio.read_paf_file, pt.fasta.load_sequences into a
              SequencePool, column_match_counts, encode_mismatches into
              pt.pafio.write_paf_file, shatter and pipeline_stage into
              pt.pafio.serialize_paf, and name_ids, copy, record_ops and
              n_ops on the shattered table): the counts equal the C loop's
              and sum to the pinned view -s totals, the encoded file and
              the pipeline's text equal the add_mismatches and
              run_pipeline pins, the table's facts are known integers, the
              pool is on the card, and K1, K2, K4's count and fill, K5 and
              K6 each launch; each step's wall and launches printed.
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
   genome  -- run_pipeline on a many-contig genome (build_genome: 24
              contig pairs of uneven length, 2 x 135 Mbp, each query
              contig aligned to its target as in the synthesis above,
              shattered into its 216,913 gapless records, both files
              pinned), with a pool made from the FASTA inside each run,
              at PAFFY_TPU_PIPELINE_THREADS = GENOME_THREADS in turns
              (1, 4): each output pinned to paffy_tpu's run_pipeline
              on the CPU, K2 launched once and K4's count and fill, K6 and
              K5 once per contig group; each run's wall, records/s and
              phases (summed over the workers) printed.  Then once at 4
              workers under PAFFY_TPU_PROFILE (the port's CommandTimer
              hook): its busy share, and how many of K6's launches overlap
              in time and on which streams, K6 on worker streams and not
              on K2's (the caller's).  Then run_pipeline on it over a
              (4,2) mesh of slots (its data rows split each group's chain
              groups and tile sequences), pinned to the same digest; and
              ``view -s`` of genome.paf's lines repeated (repeat_lines)
              past BIG_BATCHES - 1 batches of the default BATCH_BYTES,
              pinned, one K1 launch a batch, BIG_BATCHES or more.
   deep tile -- ``tile`` on deep_tile_input, made on the genome: the
              gapless records of DEEP_GENOMES target genomes on its query
              contigs and DEEP_LOCI repeat loci under DEEP_STACK records
              each (1,367,652 records), pinned, its output pinned to
              paffy_tpu's tile; K5's histogram rows pass 2 x HIST_BUDGET,
              so it launches once per batch, DEEP_BATCHES or more; then
              K5 alone on its arguments against native.tile_sweep, with
              its plan, walks and medians timed apart, beside its bound.
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
              (4,2) mesh's 8 launches, 20 times in a row, per 8.  K4's
              count and fill are printed beside the threaded C passes
              they replace (native.encode_runs_per_mop and
              encode_runs_fill_cigar on up to 8 host threads, host wall,
              median of 5): ``c_pass_ms`` in their records.

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
import re
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
# paffy_tpu's commands; of its view -a of render_input(in.paf); of the
# many-contig genome (build_genome), of paffy_tpu's run_pipeline on it, of
# its view -s of genome.paf repeated (repeat_lines), and of the deep tile
# input made on it (deep_tile_input) and paffy_tpu's tile on it; made by
# tests/test_torch_host.py --pins
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
    "genome.fa": "fa7c4f43fbb8c3537bccca8b583e85e410613b4289216b7b5cb92cc724fbdaee",
    "genome.paf": "a5b6398f6f4bc5b82a88ac31ee74f9507cb1daa257b9fd4c830812263672e05a",
    "run_pipeline genome": "17523d674f25a24bf0cb425cb62ed65db436b39ae27414a682fd08ecae08d7e7",
    "view -a": "cfe62ec55131efaecb84060535922cabb5689ad688a5c8feb0d2c4b04a611cdd",
    "view -s genome repeated": "76172a928c822731419a34e6c7d9e800aced8365015708f8b522c5debf4eae8b",
    "deep.paf": "4cb9306a522f27c4b54716b980d540b78d11f2b5169f7bdb2dddbea3ed7d77e0",
    "deep tile": "96b684268e95c7bc6e9dae23b8a9cab7ce08a0912b2a69b00cb3e85d53691d67",
}

# the many-contig genome, see build_genome: its contig count, the factor
# between its longest and its shortest contig, and the worker counts of
# its run_pipeline runs (PAFFY_TPU_PIPELINE_THREADS), in turns (two runs,
# not four, to make room for the library, render and full-batch phases)
GENOME_CONTIGS = 24
GENOME_SPREAD = 12
GENOME_THREADS = (1, 4)
# the K1 edge cases, see k1_edge_cases
K1_EDGE_LABELS = ("every residue, + strand", "every residue, - strand",
                  "both ends of ext")
# the K4 edge cases, see k4_edge_cases
K4_EDGE_LABELS = K1_EDGE_LABELS[:2] + (
    "placed flips, + strand", "placed flips, - strand",
    "long runs, + strand", "long runs, - strand",
    "adjacent, empty and all-mismatch ops", "no M ops")
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
# the deep tile input, see deep_tile_input: its target genomes, the shift
# of the records of genomes 1.. on the query, its repeat loci, the records
# stacked on each, their query span and how far their starts stray; its
# K5 sweep must take DEEP_BATCHES launches or more
DEEP_GENOMES = 4
DEEP_SHIFT = 1_000
DEEP_LOCI = 200
DEEP_STACK = 2_500
DEEP_LEN = 300
DEEP_JITTER = 30
DEEP_BATCHES = 3
# the small-budget K5 checks cut each sweep into about this many batches
K5_SMALL_BATCHES = 6
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
# view -a of the first records of in.paf whose rendering passes
# RENDER_SLICES - 1 slices of commands.view's 64 MiB (its _render_sliced's
# max_bytes), so that it is cut into RENDER_SLICES slices or more
RENDER_SLICE_BYTES = 64 << 20
RENDER_SLICES = 3
# view -s of genome.paf's lines repeated past BIG_BATCHES - 1 streaming
# batches of commands.common.BATCH_BYTES's default, so BIG_BATCHES or more
FULL_BATCH_BYTES = 256 << 20
BIG_BATCHES = 3
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

def synth_workload(rng, seq_len, n_records, m_columns, names=("q_chr",
                                                              "t_chr")):
    """Alignment structure of the records: per-run (record, length, query
    and target start relative to the sequences) and the PAF lines, between
    the query and target sequences ``names``."""
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
            f"{names[0]}\t{seq_len}\t{qs[r]}\t{qs[r] + qspan[r]}\t"
            f"{'-' if rev_rec[r] else '+'}\t{names[1]}\t{seq_len}\t{ts[r]}\t"
            f"{ts[r] + tspan[r]}\t{mcols[r]}\t{max(qspan[r], tspan[r])}\t60"
            f"\tAS:i:{2 * mcols[r]}\tcg:Z:{cigar}\n")
    return dict(runs=runs, run_rec=run_rec, rev=rev, qpos=qpos, tpos=tpos,
                n_rev=int(rev_rec.sum()), n_ins=int(np.count_nonzero(ins)),
                n_del=int(np.count_nonzero(dele)), lines=lines, names=names)


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


def build_genome(d, native, n_contigs=GENOME_CONTIGS, seq_len=SEQ_LEN,
                 n_records=N_RECORDS, m_columns=M_COLUMNS):
    """Write a seeded genome pair as ``d``/genome.fa, ``n_contigs`` target
    contigs (t_chr1..) then as many query contigs (q_chr1..), and the
    gapless records of its alignment as ``d``/genome.paf.  Each genome
    holds ``seq_len`` bases; contig i of both has the same length, the
    lengths log-uniform over a factor of GENOME_SPREAD in a seeded order.
    Query contig i aligns to target contig i through synth_workload, with
    its share by length of ``n_records`` records (at least one) and of
    ``m_columns`` M columns; each genome is soft-masked, with runs of N,
    at build_files' density, and the query copied through the alignment
    map as there.  The records are chain_input's for each contig (one per
    M run), contig after contig.  Returns (fasta, paf, contig lengths,
    [synth_workload's dict per contig])."""
    rng = np.random.default_rng(SEED + 23)
    t0 = time.perf_counter()
    share = np.geomspace(1, GENOME_SPREAD, n_contigs)[
        rng.permutation(n_contigs)]
    lens = (seq_len * share / share.sum()).astype(np.int64)
    total = int(lens.sum())
    works = [synth_workload(rng, n, max(1, round(n_records * n / total)),
                            int(m_columns * n / total),
                            (f"q_chr{i + 1}", f"t_chr{i + 1}"))
             for i, n in enumerate(lens.tolist())]
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = acgt[rng.integers(0, 4, 2 * total, dtype=np.uint8)]
    tseq, qseq = seqs[:total], seqs[total:]            # views into seqs
    scale = total / SEQ_LEN
    max_n_run = min(50_000, total // 100)
    t_lower = soft_mask(rng, tseq, int(30_000 * scale),
                        max(int(30 * scale), 1), max_n_run)
    # every contig's runs at once, offset to its place in the genomes
    shift = np.repeat(np.cumsum(lens) - lens, [len(w["runs"]) for w in works])

    def runs_of(key):
        return np.concatenate([w[key] for w in works])
    native.synth_query_pool(seqs, runs_of("runs"),
                            runs_of("qpos") + shift + total,
                            runs_of("tpos") + shift, runs_of("rev"),
                            keep_per_mille=965, seed=SEED + 7)
    q_lower = soft_mask(rng, qseq, int(20_000 * scale),
                        max(int(20 * scale), 1), max_n_run)
    fa, paf = os.path.join(d, "genome.fa"), os.path.join(d, "genome.paf")
    with open(fa, "wb") as fh:
        for seq, k in ((tseq, 1), (qseq, 0)):
            for w, a, n in zip(works, np.cumsum(lens) - lens, lens):
                write_fasta(fh, w["names"][k], seq[a: a + n])
    with open(paf, "wb") as fh:
        for w, n in zip(works, lens.tolist()):
            fh.write(chain_input(w, seq_len=n))
    n_runs = [len(w["runs"]) for w in works]
    log(f"genome: {n_contigs} contigs of {int(lens.min())}-{int(lens.max())}"
        f" bp, {sum(len(w['lines']) for w in works)} gapped records, "
        f"{sum(int(w['runs'].sum()) for w in works)} M columns in "
        f"{sum(n_runs)} gapless records ({min(n_runs)}-{max(n_runs)} a "
        f"contig), {sum(w['n_rev'] for w in works)} '-' gapped records, "
        f"lowercase share t {t_lower:.3f} q {q_lower:.3f}, "
        f"{time.perf_counter() - t0:.1f} s")
    return fa, paf, lens, works


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


def k4_runs(seed, groups):
    """M runs over one ACGT pool, from ``groups`` of (target residue mod
    16, reverse, [(n, kind), ...]): a group's runs follow one another
    with no gap in the target and in the query walk, as the M ops of
    "5M5M" do; kind is "copy" (the query is the target's copy), "all
    mismatch" (every column differs), "random" (independent bases) or a
    tuple of columns of the run where the copy flips.  Returns dict(pool,
    lens, qpos0, tpos0, rev)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    other = np.arange(256, dtype=np.uint8)     # a base that differs
    other[acgt] = np.roll(acgt, -1)
    comp = np.arange(256, dtype=np.uint8)
    comp[acgt] = acgt[::-1]
    sizes = [sum(n for n, _ in runs) for _, _, runs in groups]
    stride = 16 * (-(-(max(sizes) + 32) // 16))
    pool = acgt[rng.integers(0, 4, 2 * stride * len(groups))].copy()
    lens, qpos0, tpos0, rev = [], [], [], []
    for g, ((t_res, reverse, group), size) in enumerate(zip(groups, sizes)):
        t0 = stride * g + t_res
        q0 = stride * (len(groups) + g) + (7 * g + 3) % 16
        tgt = pool[t0: t0 + size]
        qry = tgt.copy()
        c = 0
        for n, kind in group:
            seg = slice(c, c + n)
            if kind == "all mismatch":
                qry[seg] = other[tgt[seg]]
            elif kind == "random":
                qry[seg] = acgt[rng.integers(0, 4, n)]
            elif kind != "copy":
                at = c + np.asarray(kind, dtype=np.int64)
                qry[at] = other[qry[at]]
            lens.append(n)
            tpos0.append(t0 + c)
            # a reverse run walks down from its first column's byte
            qpos0.append(q0 + size - 1 - c if reverse else q0 + c)
            rev.append(reverse)
            c += n
        pool[q0: q0 + size] = comp[qry][::-1] if reverse else qry
    return dict(pool=pool, lens=np.array(lens, dtype=np.int64),
                qpos0=np.array(qpos0, dtype=np.int64),
                tpos0=np.array(tpos0, dtype=np.int64),
                rev=np.array(rev, dtype=bool))


def k4_paf(c, name="s"):
    """PAF text of one record per M run of a K4 edge case whose pool is
    one sequence ``name`` (k4_runs' cases): the run, then 2 inserted and
    1 deleted bases (cigar nM2I1D), on the run's strand."""
    size = len(c["pool"])
    lines = []
    for n, q, t, r in zip(c["lens"], c["qpos0"], c["tpos0"], c["rev"]):
        q0 = q + 1 - (n + 2) if r else q    # a reverse walk starts at qend-1
        lines.append(f"{name}\t{size}\t{q0}\t{q0 + n + 2}\t{'-+'[not r]}\t"
                     f"{name}\t{size}\t{t}\t{t + n + 1}\t{n}\t{n + 3}\t60"
                     f"\tcg:Z:{n}M2I1D")
    return "\n".join(lines) + "\n"


def k4_edge_cases(seed=SEED, residues=range(16)):
    """K4's edge cases as M runs over small unguarded pools:
    {label: dict(pool, lens, qpos0, tpos0, rev[, ops, op_lens])}; where
    ops and op_lens are given they are the cigar (op codes of
    core.model) whose M ops are the runs, in order, else the cigar is
    the runs alone.

    * every residue: k1_edge_cases' runs (1 to 9000 columns, every pair of
      target and query residues mod 16) over its random pool, where about a
      third of the columns flip the match state, so flips fall on, before
      and after the 4096-column cuts and 512-byte window edges alike.
    * placed flips: 9000-column runs at every pair of residues (of
      ``residues``) whose query is the target's copy (its reverse
      complement on the - strand), with one mismatching column at d in
      {-1, 0, +1} (a run per d) from every window edge and cut: the columns
      512 w - (target start mod 16) of the run, w >= 1.
    * long runs: runs of identical bases over 4, 10 and 18 pieces of 4096
      columns (the last two crossing the 8-piece groups a warp takes, the
      18 pieces one =/X run), flips on a piece's first column and inside
      it, a run whose every column mismatches over 3 pieces, and short
      runs between them.
    * adjacent, empty and all-mismatch ops: "5M5M" on both strands (one
      state across the two ops, which stay two runs), a 0-length M op
      between two adjacent ones, adjacent all-mismatch ops, and
      one-column ops, in a cigar with I, D, = and X ops between them.
    * no M ops: a cigar of I, D, = and X only.
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
    for label, reverse in zip(K4_EDGE_LABELS[2:4], (False, True)):
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
    P = 8 * 512    # the host's cut (ops/compare.py PIECE_COLS)
    for label, reverse in zip(K4_EDGE_LABELS[4:6], (False, True)):
        cases[label] = k4_runs(seed + 2, [
            (0, reverse, [(3 * P + 100, "copy")]),
            (3, reverse, [(5, "random")]),
            # the op's piece k starts at column k P - 5
            (5, reverse, [(9 * P + 7, (5 * P - 5, 5 * P + 3))]),
            (15, reverse, [(2 * P + 1, "all mismatch")]),
            (1, reverse, [(1, "copy")]),
            (9, reverse, [(17 * P, "copy")]),
            (2, reverse, [(40, "random")])])
    groups = [(0, False, [(5, "copy"), (5, "copy")]),
              (7, True, [(5, "copy"), (5, "copy")]),
              (3, False, [(6, "copy"), (0, "copy"), (6, "copy")]),
              (11, True, [(20, "all mismatch"), (P + 3, "all mismatch")]),
              (1, False, [(1, "copy"), (1, "all mismatch"), (1, "copy")])]
    c = k4_runs(seed + 3, groups)
    ops, op_lens = [3, 4], [2, 1]        # =, X
    for g, (_, _, group) in enumerate(groups):
        ops += [0] * len(group) + [1 + g % 2]   # the group's M ops, I or D
        op_lens += [n for n, _ in group] + [g + 1]
    cases[K4_EDGE_LABELS[6]] = dict(c, ops=np.array(ops, dtype=np.uint8),
                                    op_lens=np.array(op_lens, dtype=np.int64))
    empty = np.zeros(0, dtype=np.int64)
    cases[K4_EDGE_LABELS[7]] = dict(
        pool=np.frombuffer(b"ACGT" * 8, dtype=np.uint8).copy(), lens=empty,
        qpos0=empty, tpos0=empty, rev=np.zeros(0, dtype=bool),
        ops=np.array([1, 2, 3, 4], dtype=np.uint8),
        op_lens=np.array([3, 2, 4, 1], dtype=np.int64))
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


def gapless_records(w):
    """(qstart, strand, tstart, length, AS) arrays of the gapless records
    of the synthesis ``w`` (build_files), one per M run, in order: '-'
    records walk down the query, and each has its parent's AS."""
    runs, rev = w["runs"], w["rev"]
    qs = np.where(rev, w["qpos"] - runs + 1, w["qpos"])
    score = 2 * np.bincount(w["run_rec"], weights=runs).astype(np.int64)
    return (qs, np.where(rev, "-", "+"), w["tpos"], runs,
            score[w["run_rec"]])


def chain_input(w, seq_len=SEQ_LEN) -> bytes:
    """The chain input: one gapless record per M run of the synthesis
    ``w`` (build_files, gapless_records), in order, byte for byte
    paffy_tpu's ``shatter`` of in.paf: the run length in fields 10-11,
    MAPQ 60, the parent's AS, s1:i:0 and cg:Z:<len>M."""
    qname, tname = w["names"]
    cols = zip(*(a.tolist() for a in gapless_records(w)))
    return "".join(
        f"{qname}\t{seq_len}\t{q}\t{q + n}\t{s}\t{tname}\t{seq_len}\t{t}\t"
        f"{t + n}\t{n}\t{n}\t60\tAS:i:{a}\ts1:i:0\tcg:Z:{n}M\n"
        for q, s, t, n, a in cols).encode()


def deep_tile_input(works, lens, loci=DEEP_LOCI, stack=DEEP_STACK,
                    seed=SEED) -> bytes:
    """The deep tile input over build_genome's genome (``works``, its
    synth_workload dicts, and ``lens``, its contig lengths): the gapless
    records of DEEP_GENOMES target genomes aligned to its query contigs,
    then ``loci`` repeat loci, each under a stack of ``stack`` records.

    Genome 0's records are genome.paf's.  Genome g's (target contigs
    g<g>.t_chr..) are the same records, each moved along its query
    contig by a seeded offset in [-DEEP_SHIFT, DEEP_SHIFT] (clamped to
    the contig), with its AS drawn anew.  A locus is a seeded position
    on a query contig, drawn by length; each record of its stack spans
    DEEP_LEN +- DEEP_LEN // 6 query bases from within DEEP_JITTER of it,
    aligned to a seeded place on a target contig of a seeded genome,
    gapless or with one insertion or deletion of 1-8 bases, on a seeded
    strand.  Every AS drawn is uniform up to genome.paf's largest, so
    the best-first order interleaves the stacks with each other and with
    the genomes' records."""
    rng = np.random.default_rng(seed + 29)
    lens = np.asarray(lens, dtype=np.int64)
    cols = [gapless_records(w) for w in works]
    contig = np.repeat(np.arange(len(works)), [len(c[0]) for c in cols])
    qs, strand, ts, n, score = (np.concatenate([c[k] for c in cols])
                                for k in range(5))
    top = int(score.max())
    qname = np.array([w["names"][0] for w in works])
    tname = np.array([[f"g{g}." * (g > 0) + w["names"][1] for w in works]
                      for g in range(DEEP_GENOMES)])
    out = []

    def emit(c, q, q_len, s, g, tc, t, t_len, n_match, block, a, cigar):
        out.extend(
            f"{qn}\t{ql}\t{x}\t{x + m}\t{sd}\t{tn}\t{tl}\t{y}\t{y + tm}\t"
            f"{nm}\t{bl}\t60\tAS:i:{sc}\ts1:i:0\tcg:Z:{cg}\n"
            for qn, ql, x, m, sd, tn, tl, y, tm, nm, bl, sc, cg in zip(
                qname[c].tolist(), lens[c].tolist(), q.tolist(),
                q_len.tolist(), s.tolist(), tname[g, tc].tolist(),
                lens[tc].tolist(), t.tolist(), t_len.tolist(),
                n_match.tolist(), block.tolist(), a.tolist(), cigar))

    for g in range(DEEP_GENOMES):
        q, a = qs, score
        if g:
            q = np.clip(qs + rng.integers(-DEEP_SHIFT, DEEP_SHIFT + 1,
                                          len(qs)), 0, lens[contig] - n)
            a = rng.integers(0, top + 1, len(qs))
        emit(contig, q, n, strand, np.full(len(qs), g), contig, ts, n, n, n,
             a, [f"{m}M" for m in n.tolist()])
    # the stacks
    k, wide = loci * stack, DEEP_LEN // 6
    at = rng.choice(len(lens), loci, p=lens / lens.sum())
    locus = rng.integers(DEEP_JITTER, lens[at] - DEEP_LEN - wide - DEEP_JITTER)
    c = np.repeat(at, stack)
    q_len = rng.integers(DEEP_LEN - wide, DEEP_LEN + wide + 1, k)
    q = np.repeat(locus, stack) + rng.integers(-DEEP_JITTER, DEEP_JITTER + 1,
                                                k)
    kind = rng.integers(0, 3, k)          # gapless, insertion, deletion
    gap = rng.integers(1, 9, k)
    m1 = rng.integers(q_len // 4, 3 * q_len // 4)
    m2 = np.where(kind == 1, q_len - gap - m1, q_len - m1)
    t_len = np.where(kind == 2, q_len + gap, m1 + m2)
    g = rng.integers(0, DEEP_GENOMES, k)
    tc = rng.integers(0, len(lens), k)
    t = rng.integers(0, lens[tc] - t_len)
    s = np.where(rng.integers(0, 2, k) == 1, "-", "+")
    a = rng.integers(0, top + 1, k)
    cigar = [f"{ln}M" if kd == 0 else f"{x}M{gp}{'ID'[kd - 1]}{y}M"
             for kd, ln, x, gp, y in zip(kind.tolist(), q_len.tolist(),
                                         m1.tolist(), gap.tolist(),
                                         m2.tolist())]
    emit(c, q, q_len, s, g, tc, t, t_len, m1 + m2,
         m1 + m2 + np.where(kind > 0, gap, 0), a, cigar)
    return "".join(out).encode()


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


def render_input(paf: bytes, min_bytes: int) -> bytes:
    """The first lines of ``paf`` whose ``view -a`` rendering passes
    ``min_bytes``: it is at least 3 bytes a cigar column (commands.view's
    size model), so the shortest prefix whose columns times 3 pass it."""
    size, out = 0, []
    for line in paf.splitlines(keepends=True):
        out.append(line)
        cg = line[line.index(b"cg:Z:") + 5:].split(b"\t")[0]
        size += 3 * sum(map(int, re.findall(rb"(\d+)[MID]", cg)))
        if size > min_bytes:
            return b"".join(out)
    raise ValueError(f"the rendering of all of paf is {size} bytes, not "
                     f"more than {min_bytes}")


def repeat_lines(src: str, dst: str, min_bytes: int) -> int:
    """Write ``src``'s bytes to ``dst`` again and again until ``dst`` holds
    more than ``min_bytes``; returns the number of copies."""
    with open(src, "rb") as fh:
        data = fh.read()
    copies = min_bytes // len(data) + 1
    with open(dst, "wb") as fh:
        for _ in range(copies):
            fh.write(data)
    return copies


def library_phase(paf, fa, out_dir):
    """The port's library surface, as a user's program drives it: the
    package's exports (``import paffy_tpu_torch as pt``) and the device
    steps of ops.mismatch, ops.transforms and parallel.runner, on in.paf
    and seqs.fa.  Steps: ``pt.pafio.read_paf_file``;
    ``pt.fasta.load_sequences`` into a ``SequencePool``;
    ``column_match_counts`` (K2 on its first ``pool.ext``, K1);
    ``encode_mismatches`` (K4 count and fill) into
    ``pt.pafio.write_paf_file`` (out_dir/library_am.paf); ``shatter`` and
    ``pipeline_stage`` on its gapless records (K4, K6, K5) into
    ``pt.pafio.serialize_paf``; and ``name_ids``, ``copy``,
    ``record_ops`` and ``n_ops`` on the shattered table (name_ids held to
    a plain loop over the table, copy to be a deep one, record_ops to
    give views).  Returns (results, {step: wall seconds},
    {step: {kernel: launches}}): results holds the counts, the encoded
    file's path, the pipeline's text and the shattered table's facts.
    Launch counts are set to 0 just before each step and read just
    after."""
    import paffy_tpu_torch as pt
    from paffy_tpu_torch import kernels
    from paffy_tpu_torch.ops.mismatch import (SequencePool,
                                              column_match_counts,
                                              encode_mismatches)
    from paffy_tpu_torch.ops.transforms import shatter
    from paffy_tpu_torch.parallel.runner import pipeline_stage

    walls, launches = {}, {}

    def step(name, fn):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t0
        launches[name] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        return out

    t = step("read_paf_file", lambda: pt.pafio.read_paf_file(paf))
    pool = step("load_sequences, SequencePool",
                lambda: SequencePool(pt.fasta.load_sequences([fa])))
    m, x = step("column_match_counts", lambda: column_match_counts(t, pool))
    am = os.path.join(out_dir, "library_am.paf")
    step("encode_mismatches, write_paf_file",
         lambda: pt.pafio.write_paf_file(encode_mismatches(t, pool), am))
    gapless = step("shatter", lambda: shatter(t))
    piped = step("pipeline_stage, serialize_paf",
                 lambda: pt.pafio.serialize_paf(pipeline_stage(gapless,
                                                               pool)))

    qid, tid, names = step("name_ids", gapless.name_ids)
    c = step("copy", gapless.copy)
    last = len(gapless) - 1
    ops, lens = step("record_ops", lambda: gapless.record_ops(last))
    n_ops = step("n_ops", lambda: gapless.n_ops)
    seen: dict = {}
    for i in range(len(gapless)):
        if (qid[i] != seen.setdefault(gapless.qname[i], len(seen))
                or tid[i] != seen.setdefault(gapless.tname[i], len(seen))):
            raise AssertionError(f"name_ids differs from the plain loop at "
                                 f"record {i}")
    if names != list(seen):
        raise AssertionError(f"name_ids' names {names} != {list(seen)}")
    c.lens += 1
    c.qname[0] = "copied"
    if (gapless.lens == c.lens).any() or gapless.qname[0] == "copied":
        raise AssertionError("copy shares an array with its source")
    if not (np.shares_memory(ops, gapless.ops)
            and np.shares_memory(lens, gapless.lens)):
        raise AssertionError("record_ops made copies, not views")
    facts = {"records": len(gapless), "ops": int(n_ops.sum()),
             "ops per record": sorted(set(n_ops.tolist())),
             "names": names, "query ids": sorted(set(qid.tolist())),
             "target ids": sorted(set(tid.tolist())),
             "last record's ops": (ops.tolist(), lens.tolist())}
    return ({"matches": m, "mismatches": x, "add_mismatches": am,
             "pipeline": piped, "shattered": facts,
             "device": str(pool.device)}, walls, launches)


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


def host_ms(fn, reps, warm=1):
    """Milliseconds of one call of the host function ``fn``: the median of
    ``reps`` wall times after ``warm`` calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
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
             qpos0, tpos0, rev, ops=None, op_lens=None):
    """K4 on one set of M runs over a guarded or unguarded host ``pool``,
    in the cigar ``ops`` / ``op_lens`` whose M ops are those runs in order
    (default: the runs alone): the count against its plain version on the
    card and the C count pass, and the fill of the rebuilt cigar (its other
    ops placed as encode_mismatches places them, every other slot set to a
    value no run has) against its plain version on the card and the C
    passes' cigar.  Returns (ext, table, first_dest, new_ops, new_lens,
    n_runs, max abs error); raises on any difference."""
    dev = devconf.device()
    lens = np.asarray(lens, dtype=np.int64)
    if ops is None:
        ops, op_lens = np.zeros(len(lens), dtype=np.uint8), lens
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
    per_mop = runs.runs_per_mop(per_piece, piece_off)
    if not np.array_equal(per_mop, native.encode_runs_per_mop(
            pool, lens, qpos0, tpos0, rev)):
        raise AssertionError("K4 count != native.encode_runs_per_mop")
    out_off, m_out_off, slot, keep_ops, keep_lens = (
        native.encode_rebuild_slots(ops, op_lens, per_mop))
    total = int(out_off[-1])
    dest = devconf.upload(
        runs.piece_first_dest(per_piece, piece_off, m_out_off), dev)
    got, plain = [], []
    for fill, out in ((runs.run_fill_cigar, got),
                      (runs.run_fill_cigar_plain, plain)):
        new_ops, new_lens = runs.placed_cigar(total, slot, keep_ops,
                                              keep_lens, dev)
        runs_slot = torch.ones(total, dtype=torch.bool, device=dev)
        runs_slot[devconf.upload(slot, dev)] = False
        new_ops[runs_slot] = 255
        new_lens[runs_slot] = -1
        fill(ext, table, dest, new_ops, new_lens)
        out += [new_ops, new_lens]
    if total:
        err = max(err, int((got[0].int() - plain[0].int()).abs().max()),
                  int((got[1] - plain[1]).abs().max()))
    if not (torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])):
        raise AssertionError("K4 fill != its plain version")
    _, _, want_ops, want_lens = native.encode_rebuild_offsets(
        ops, op_lens, per_mop, total)
    native.encode_runs_fill_cigar(pool, lens, qpos0, tpos0, rev, m_out_off,
                                  want_ops, want_lens)
    if not (np.array_equal(devconf.download(got[0]), want_ops)
            and np.array_equal(devconf.download(got[1]), want_lens)):
        raise AssertionError("K4 fill != native.encode_runs_fill_cigar")
    return ext, table, dest, got[0], got[1], int(per_mop.sum()), err


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


def k5_batched_check(torch, devconf, native, kernels, tile_device, host,
                     cap, tile):
    """k5_check with tile_device.HIST_BUDGET cut, for the call, to about
    1 / K5_SMALL_BATCHES of the sweep's rows (never below its widest row),
    so that the sweep runs in several batches: one launch per batch, 2 or
    more.  Returns (batches, budget in bytes, max abs error)."""
    dev = devconf.device()
    plan = tile_device.tile_plan(*(devconf.upload(a, dev) for a in host), cap,
                                 tile)
    widest = int(torch.diff(plan.row_off).max())
    budget = 4 * max(widest, -(-plan.n_bins // K5_SMALL_BATCHES))
    saved, tile_device.HIST_BUDGET = tile_device.HIST_BUDGET, budget
    try:
        before = kernels.LAUNCHES["tile_sweep"]
        *_, err = k5_check(torch, devconf, native, tile_device, host, cap,
                           tile)
        batches = kernels.LAUNCHES["tile_sweep"] - before
    finally:
        tile_device.HIST_BUDGET = saved
    if batches < 2:
        raise AssertionError(f"K5 at a budget of {budget} bytes took "
                             f"{batches} batch(es), not several")
    return batches, budget, err


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


def kernel_overlap(trace_path, kernel):
    """(events, events that overlap another in time, most running at once,
    distinct streams) of the device events of ``kernel`` in a Chrome trace
    of torch.profiler; each event's stream is its "stream" argument."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("cat") == "kernel" and "dur" in e
                  and kernel in e.get("name", "")]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events)
    overlapping = set()
    for i, (a, b) in enumerate(spans):
        for j in range(i + 1, len(spans)):
            if spans[j][0] >= b:
                break
            overlapping |= {i, j}
    # an end sorts before a start at the same time
    at_once = most = 0
    for _, step in sorted([(a, 1) for a, _ in spans]
                          + [(b, -1) for _, b in spans]):
        at_once += step
        most = max(most, at_once)
    streams = sorted({e.get("args", {}).get("stream", e.get("tid"))
                      for e in events}, key=str)
    return len(spans), len(overlapping), most, streams


@contextlib.contextmanager
def entry_ms(torch, kernels, names):
    """Inside the block, kernels.load() gives the kernel library with each
    C entry point of ``names`` timed by CUDA events recorded on the current
    stream around its call.  Yields {name: [milliseconds of each call, in
    the order of the calls]}, filled when the block ends.  Events are
    recorded on the stream itself, so no call goes unseen, as a profiler's
    trace can let one go."""
    lib, load = kernels.load(), kernels.load
    marks = {name: [] for name in names}

    class Timed:
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if name not in marks:
                return fn

            def call(*args):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                rc = fn(*args)
                b.record()
                marks[name].append((a, b))
                return rc
            return call

    ms = {name: [] for name in names}
    kernels.load = Timed
    try:
        yield ms
        torch.cuda.synchronize()
    finally:
        kernels.load = load
    for name, pairs in marks.items():
        ms[name] += [a.elapsed_time(b) for a, b in pairs]


def run(torch) -> dict:
    import argparse
    from paffy_tpu_torch import devconf, kernels, native, phases
    from paffy_tpu_torch.cli import faffy_main, paffy_main
    from paffy_tpu_torch.commands import common
    from paffy_tpu_torch.commands import view as view_cmd
    from paffy_tpu_torch.core import pafio
    from paffy_tpu_torch.ops import (chain, chain_device, compare,
                                     group_stats, mismatch, mismatch_device,
                                     runs, tile, tile_device)
    from paffy_tpu_torch.ops.coverage import SATURATION
    from paffy_tpu_torch.ops.segments import build_m_column_batch
    from paffy_tpu_torch.parallel import pipeline, runner
    from paffy_tpu_torch.utils.logging import CommandTimer

    t_start = time.perf_counter()
    os.environ.pop("PAFFY_TPU_PLATFORM", None)
    dev = devconf.device()
    gpu = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; python {sys.version.split()[0]}; "
        f"numpy {np.__version__}")

    log(f"== build (t+{time.perf_counter() - t_start:.1f} s)")
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
        log(f"== synth (t+{time.perf_counter() - t_start:.1f} s)")
        fa, paf, w = build_files(d, native)
        expect_pin("seqs.fa", fa)
        expect_pin("in.paf", paf)

        log(f"== view (t+{time.perf_counter() - t_start:.1f} s)")
        for tag, flags in (("view -s", ["-s"]), ("view -s -t", ["-s", "-t"])):
            ours = os.path.join(d, "ours.txt")
            drive(tag, ["view", "-i", paf, *flags, fa], ours)
            with open(ours, "rb") as fh:
                last = fh.read().decode().splitlines()[-1]
            log(f"{tag}: {last}")
        view_fields = dict(kv.split(":", 1) for kv in last.split("\t")
                           if ":" in kv)
        expect_equal("Total-alignments",
                     int(view_fields["Total-alignments"]), N_RECORDS)
        expect_equal("Query-inserts", int(view_fields["Query-inserts"]),
                     w["n_ins"])
        expect_equal("Query-deletes", int(view_fields["Query-deletes"]),
                     w["n_del"])
        expect_equal("Aligned-bases == M columns",
                     int(view_fields["Aligned-bases"]),
                     int(w["runs"].sum()))
        launched("view -s", ("piece_compare", "build_ext"))

        log(f"== counts (t+{time.perf_counter() - t_start:.1f} s)")
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

        log(f"== add_mismatches (t+{time.perf_counter() - t_start:.1f} s)")
        am = os.path.join(d, "am.paf")
        drive("add_mismatches", ["add_mismatches", "-i", paf, fa], am)
        launched("add_mismatches", ("build_ext", "run_counts",
                                     "run_fill_cigar"))
        drive("add_mismatches -a", ["add_mismatches", "-a", "-i", am],
              os.path.join(d, "am_a.paf"))
        with open(am, "rb") as fh:
            encoded = fh.read()
        log(f"add_mismatches wrote {len(encoded)} bytes")

        log(f"== batches (t+{time.perf_counter() - t_start:.1f} s)")
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
                                               "run_fill_cigar"))

        log(f"== render (t+{time.perf_counter() - t_start:.1f} s)")
        # view -a over RENDER_SLICES slices or more of _render_sliced
        expect_equal("commands.view's slice size", view_cmd._render_sliced.
                     __defaults__[0], RENDER_SLICE_BYTES)
        rpaf = os.path.join(d, "render.paf")
        with open(paf, "rb") as fh, open(rpaf, "wb") as out:
            out.write(render_input(fh.read(),
                                   (RENDER_SLICES - 1) * RENDER_SLICE_BYTES))
        sliced, render = [], native.view_render_batch

        def counted(sl, *args):
            sliced.append(len(sl))
            return render(sl, *args)
        native.view_render_batch = counted
        try:
            rendered = os.path.join(d, "rendered.txt")
            drive("view -a", ["view", "-a", "-i", rpaf, fa], rendered)
        finally:
            native.view_render_batch = render
        launched("view -a", ("piece_compare", "build_ext"))
        expect_equal(f"view -a rendered in {RENDER_SLICES} slices or more "
                     f"(records a slice: {sliced})",
                     len(sliced) >= RENDER_SLICES, True)
        log(f"view -a: {sum(sliced)} records, "
            f"{os.path.getsize(rendered)} bytes in {len(sliced)} slices, "
            f"{walls['view -a']:.4f} s wall; {gpu}")
        os.remove(rendered)

        log(f"== runs (t+{time.perf_counter() - t_start:.1f} s)")
        k = b.n_mops
        _, table4, dest4, ops4, lens4, n_runs, k4_err = k4_check(
            torch, devconf, native, runs, mismatch_device, pool.host_pool,
            b.lens[:k], b.qpos0[:k], b.tpos0[:k], b.rev[:k], t.ops, t.lens)
        k4_c = (pool.host_pool, b.lens[:k], b.qpos0[:k], b.tpos0[:k],
                b.rev[:k])
        n_pieces4 = int(table4.shape[1])
        log(f"ok: K4 count and fill == plain on the card == C passes at full "
            f"size: {n_runs} runs over {n_cols} columns in {n_pieces4} "
            f"pieces, a cigar of {ops4.numel()} ops")
        for label, c in k4_edge_cases().items():
            *_, n_edge, err = k4_check(
                torch, devconf, native, runs, mismatch_device, c["pool"],
                c["lens"], c["qpos0"], c["tpos0"], c["rev"], c.get("ops"),
                c.get("op_lens"))
            k4_err = max(k4_err, err)
            log(f"ok: K4 count and fill == plain == C passes on its edge case "
                f"{label} ({len(c['lens'])} runs, {n_edge} =/X runs)")

        log(f"== tile (t+{time.perf_counter() - t_start:.1f} s)")
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
            f"{plan.tile_ids.numel()} tiles, {plan.pair_pos.numel()} (tile, "
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
                    f"{len(host[3])} intervals, {plan.pair_pos.numel()} "
                    f"(tile, record) pairs over {plan.tile_ids.numel()} "
                    f"tiles)")
        # the same in several batches, the counts carried between them
        small = [("tile_input", k5_host, SATURATION, tile_device.TILE)]
        small += [(label, host, cap, at)
                  for label, (*host, cap, tl) in k5_edge_cases().items()
                  for at in (tl, K5_EDGE_TILE)]
        for label, host, cap, at in small:
            batches, budget, err = k5_batched_check(
                torch, devconf, native, kernels, tile_device, host, cap, at)
            k5_err = max(k5_err, err)
            log(f"ok: K5 == plain == C sweep on {label} at tile {at} in "
                f"{batches} batches (HIST_BUDGET cut to {budget} bytes), "
                f"max abs error {err}")

        log(f"== chain (t+{time.perf_counter() - t_start:.1f} s)")
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

        log(f"== pipeline (t+{time.perf_counter() - t_start:.1f} s)")
        steps = (("add_mismatches", [fa]), ("chain", []), ("tile", []),
                 ("trim", []))
        src = cpaf
        for cmd, extra in steps:
            out = os.path.join(d, f"pipe_{cmd}.paf")
            drive(f"pipeline {cmd}", [cmd, "-i", src, *extra], out)
            src = out
        launched("pipeline add_mismatches", ("build_ext", "run_counts",
                                             "run_fill_cigar"))
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
            f"tiles, {plan.pair_pos.numel()} (tile, record) pairs, "
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
        launched("run_pipeline", ("build_ext", "run_counts",
                                  "run_fill_cigar", "chain_dp", "tile_sweep"),
                 once=("chain_dp", "tile_sweep"))
        log(f"launches during run_pipeline: {launches['run_pipeline']}")
        log(f"run_pipeline: {len(tp)} records in "
            f"{walls['run_pipeline']:.4f} s, "
            f"{len(tp) / walls['run_pipeline']:.1f} records/s")
        del piped

        log(f"== library (t+{time.perf_counter() - t_start:.1f} s)")
        lib, lib_walls, lib_launches = library_phase(paf, fa, d)
        expect_equal("the library's pool is on the card", lib["device"],
                     str(dev))
        for name, sec in lib_walls.items():
            log(f"library {name}: {sec:.4f} s wall, launches "
                f"{lib_launches[name]}; {gpu}")
        lm, lx = lib["matches"], lib["mismatches"]
        expect_equal("library column_match_counts == C loop per record",
                     np.array_equal(lm, m_c) and np.array_equal(lx, x_c),
                     True)
        tm, tx = int(lm.sum()), int(lx.sum())
        expect_equal("library counts: matches + mismatches == the pinned "
                     "view -s's Aligned-bases", tm + tx,
                     int(view_fields["Aligned-bases"]))
        expect_equal("library counts: the pinned view -s's Avg-Identity",
                     f"{float(np.float32(tm) / np.float32(tm + tx)):.6f}",
                     view_fields["Avg-Identity"])
        expect_pin("library encode_mismatches -> write_paf_file",
                   lib["add_mismatches"], pin="add_mismatches")
        lp = os.path.join(d, "library_pipeline.paf")
        with open(lp, "wb") as fh:
            fh.write(lib["pipeline"].encode("latin-1"))
        expect_pin("library pipeline_stage -> serialize_paf", lp,
                   pin="run_pipeline")
        n_runs_w = len(w["runs"])
        expect_equal("the shattered table's facts", lib["shattered"], {
            "records": n_runs_w, "ops": n_runs_w, "ops per record": [1],
            "names": ["q_chr", "t_chr"], "query ids": [0],
            "target ids": [1],
            "last record's ops": ([0], [int(w["runs"][-1])])})
        lib_total = {k: sum(c.get(k, 0) for c in lib_launches.values())
                     for k in kernels.LAUNCHES}
        for k in ("build_ext", "piece_compare", "run_counts",
                  "run_fill_cigar", "tile_sweep", "chain_dp"):
            expect_equal(f"{k} launched on the library path ({lib_total[k]})",
                         lib_total[k] >= 1, True)
        log("library walls: " + json.dumps({"gpu": gpu,
                                             "seconds": lib_walls,
                                             "launches": lib_launches}))
        os.remove(lp)
        os.remove(lib["add_mismatches"])
        del lib

        log(f"== host (t+{time.perf_counter() - t_start:.1f} s)")
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

        log(f"== fast lane (t+{time.perf_counter() - t_start:.1f} s)")
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

        log(f"== profile (t+{time.perf_counter() - t_start:.1f} s)")
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

        log(f"== genome (t+{time.perf_counter() - t_start:.1f} s)")
        gd = os.path.join(d, "genome")
        os.makedirs(gd)
        gfa, gpaf, glens, gworks = build_genome(gd, native)
        expect_pin("genome.fa", gfa)
        expect_pin("genome.paf", gpaf)
        with open(gpaf, "rb") as fh:
            tg = pafio.parse_paf_data(fh.read())
        n_groups = len(runner.split_by_contig(tg))
        expect_equal("contig groups of genome.paf", n_groups, GENOME_CONTIGS)
        expect_equal("its longest contig is GENOME_SPREAD times its "
                     "shortest or more",
                     int(glens.max()) >= 10 * int(glens.min()), True)

        def genome_pipeline(n_workers, tag, profile_dir=None):
            """run_pipeline on genome.paf with a pool made from genome.fa,
            in ``n_workers`` worker threads, through ``measure`` under
            ``tag`` (and the profiler hook when ``profile_dir`` is given);
            its output pinned, K2 launched once and K4's count and fill, K6
            and K5 once per contig group."""
            os.environ["PAFFY_TPU_PIPELINE_THREADS"] = str(n_workers)
            if profile_dir:
                os.environ["PAFFY_TPU_PROFILE"] = profile_dir

            def call():
                timer = CommandTimer("run_pipeline genome")
                out = runner.run_pipeline(
                    tg, mismatch.SequencePool.from_fasta_files([gfa]))
                timer.done()
                return out
            try:
                piped = measure(tag, call)
            finally:
                os.environ.pop("PAFFY_TPU_PIPELINE_THREADS")
                os.environ.pop("PAFFY_TPU_PROFILE", None)
            out = os.path.join(gd, "run_pipeline.paf")
            with open(out, "wb") as fh:
                fh.write(pafio.serialize_paf_bytes(piped))
            expect_pin(tag, out, pin="run_pipeline genome")
            expect_equal(f"build_ext launches during {tag}",
                         launches[tag]["build_ext"], 1)
            for k in ("run_counts", "run_fill_cigar", "chain_dp",
                      "tile_sweep"):
                expect_equal(f"{k} launches during {tag} == contig groups",
                             launches[tag][k], n_groups)
            split = ", ".join(f"{k} {v:.4f}"
                              for k, v in phase_split[tag].items())
            log(f"{tag}: {len(tg)} records in {walls[tag]:.4f} s, "
                f"{len(tg) / walls[tag]:.1f} records/s; phases summed over "
                f"the workers ({split}); peak device memory "
                f"{peaks[tag] / 2**20:.1f} MiB")

        genome_tags = []
        for i, n_workers in enumerate(GENOME_THREADS):
            genome_tags.append(f"run_pipeline genome, {n_workers} "
                               f"worker(s), run {i + 1}")
            genome_pipeline(n_workers, genome_tags[-1])
        n_workers = max(GENOME_THREADS)
        tag = f"run_pipeline genome, {n_workers} workers, profiled"
        gprof = os.path.join(d, "genome_traces")
        genome_pipeline(n_workers, tag, gprof)
        traces = os.listdir(gprof)
        expect_equal("genome traces written", len(traces), 1)
        trace = os.path.join(gprof, traces[0])
        busy, by_cat, k6_us, k6_n = device_busy(trace, "chain_dp")
        n6, over6, most6, streams6 = kernel_overlap(trace, "chain_dp")
        n2, *_, streams2 = kernel_overlap(trace, "build_ext")
        expect_equal("K2 device events in the genome trace", n2, 1)
        expect_equal("K6 device events in the genome trace == contig "
                     "groups", n6, n_groups)
        expect_equal("K6 ran on worker streams, not K2's (the caller's)",
                     len(streams6) > 1 and not set(streams6) & set(streams2),
                     True)
        prof_wall = walls[tag]
        log(f"profile of {tag}: device busy {busy:.6f} s of {prof_wall:.4f}"
            f" s wall: busy share {busy / prof_wall:.4%}, idle share "
            f"{1 - busy / prof_wall:.4%}; K6: {n6} launches, {over6} of them "
            f"overlapping another in time, at most {most6} at once, on "
            f"streams {streams6} (K2 on {streams2}), {k6_us / 1e3:.4f} ms "
            f"in all; device time by kind (ms): "
            f"{ {k: round(v / 1e3, 4) for k, v in by_cat.items()} }")
        log("genome walls: " + json.dumps({
            "gpu": gpu, "records": len(tg), "contig_groups": n_groups,
            "seconds": {tag: walls[tag] for tag in genome_tags},
            "device_busy_share_profiled": busy / prof_wall,
            "k6_overlapping": over6, "k6_most_at_once": most6}))
        genome_launches = launches[genome_tags[1]]

        log(f"== genome on a mesh (t+{time.perf_counter() - t_start:.1f} s)")
        # the 24 contig groups through sharded_pipeline_stage on a (4,2)
        # mesh of slots filled round robin from the cards: the mesh's data
        # rows split each group's chain groups and tile sequences
        cards = devconf.devices()
        mesh42 = pipeline.make_mesh([cards[i % len(cards)] for i in range(8)],
                                    dp=4, sp=2)
        tag = "run_pipeline genome 4x2"
        piped = measure(tag, lambda: runner.run_pipeline(
            tg, mismatch.SequencePool.from_fasta_files([gfa]), mesh=mesh42))
        out = os.path.join(gd, "run_pipeline_mesh.paf")
        with open(out, "wb") as fh:
            fh.write(pafio.serialize_paf_bytes(piped))
        expect_pin(tag, out, pin="run_pipeline genome")
        launched(tag, ("build_ext", "run_counts", "run_fill_cigar",
                       "chain_dp", "tile_sweep"))
        log(f"{tag} on {mesh42.devices}: {len(tg)} records in "
            f"{walls[tag]:.4f} s wall, launches {launches[tag]}; {gpu}")
        del piped

        log(f"== view -s in full batches (t+"
            f"{time.perf_counter() - t_start:.1f} s)")
        expect_equal("commands.common.BATCH_BYTES is its default",
                     common.BATCH_BYTES, FULL_BATCH_BYTES)
        big = os.path.join(gd, "genome_repeated.paf")
        copies = repeat_lines(gpaf, big, (BIG_BATCHES - 1) * FULL_BATCH_BYTES)
        tag = "view -s genome repeated"
        drive(tag, ["view", "-i", big, "-s", gfa],
              os.path.join(gd, "big_view.txt"))
        # one K1 launch a batch
        n_big = launches[tag]["piece_compare"]
        expect_equal(f"{tag}: {BIG_BATCHES} batches of {FULL_BATCH_BYTES} "
                     f"bytes or more ({n_big} K1 launches)",
                     n_big >= BIG_BATCHES, True)
        launched(tag, ("build_ext",), once=("build_ext",))
        log(f"{tag}: {copies} copies of genome.paf, {os.path.getsize(big)} "
            f"bytes, {copies * len(tg)} records, in {n_big} batches: "
            f"{walls[tag]:.4f} s wall; {gpu}")
        os.remove(big)

        log(f"== deep tile (t+{time.perf_counter() - t_start:.1f} s)")
        t0 = time.perf_counter()
        dpaf = os.path.join(gd, "deep.paf")
        with open(dpaf, "wb") as fh:
            fh.write(deep_tile_input(gworks, glens))
        deep_synth_s = time.perf_counter() - t0
        expect_pin("deep.paf", dpaf)
        tag = "deep tile"
        drive(tag, ["tile", "-i", dpaf], os.path.join(gd, "deep_tiled.paf"))
        n5 = launches[tag]["tile_sweep"]
        expect_equal(f"{tag}: {DEEP_BATCHES} or more K5 launches ({n5})",
                     n5 >= DEEP_BATCHES, True)
        # its K5 alone: the plan's rows and batches, each batch's walk and
        # medians timed by CUDA events, the levels against the C sweep
        with open(dpaf, "rb") as fh:
            td = pafio.parse_paf_data(fh.read())
        *d_sweep, d_len = tile.sweep_arguments(td)
        d_host = (tile.tile_sort_order(td), *d_sweep)
        d_args = [devconf.upload(a, dev) for a in d_host]
        plan = tile_device.tile_plan(*d_args)
        n_batches, rows = len(plan.batch_off) - 1, 4 * plan.n_bins
        expect_equal(f"{tag}: histogram rows ({rows} bytes) of 2 x "
                     f"HIST_BUDGET or more",
                     rows >= 2 * tile_device.HIST_BUDGET, True)
        expect_equal(f"{tag}: one K5 launch per batch", n5, n_batches)
        with entry_ms(torch, kernels,
                      ("paffy_tile_walk", "paffy_tile_median")) as split:
            lv = tile_device.tile_sweep(*d_args)
        walk_ms, median_ms = (split["paffy_tile_walk"],
                              split["paffy_tile_median"])
        expect_equal(f"{tag}: K5's walks and medians, one each a batch",
                     (len(walk_ms), len(median_ms)), (n_batches, n_batches))
        lv_c = np.full(len(td), 32767, dtype=np.int64)
        native.tile_sweep(*d_host, np.zeros(d_len, dtype=np.uint16),
                          SATURATION, lv_c)
        deep_err = int(np.abs(devconf.to_host_i64(lv) - lv_c).max())
        expect_equal(f"{tag}: K5's levels == native.tile_sweep's", deep_err, 0)
        k5_err = max(k5_err, deep_err)
        deep_ms = cuda_ms(torch, lambda: tile_device.tile_sweep(*d_args),
                          reps=3, warm=1)
        deep_plan_ms = cuda_ms(torch, lambda: tile_device.tile_plan(*d_args),
                               reps=3, warm=1)
        # the bound: the function's bytes, and with the carried counts (2
        # bytes read and 2 written per position of a tile for each batch
        # after its first that has pairs of it)
        pair_batch = torch.searchsorted(
            torch.tensor(plan.batch_off[1:-1], device=dev), plan.pair_pos,
            right=True)
        pair_tile = torch.repeat_interleave(
            torch.arange(plan.tile_ids.numel(), device=dev),
            torch.diff(plan.pair_off))
        tile_batches = torch.unique(pair_tile * n_batches + pair_batch).numel()
        carried = 4 * tile_device.TILE * (tile_batches
                                          - plan.tile_ids.numel())
        d_bytes = 16 * len(d_host[3]) + 32 * len(td)
        deep_bound = {
            "bytes": d_bytes, "carried_bytes": carried,
            "bound_ms": d_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_ms_with_carry": (d_bytes + carried) / HBM_BYTES_PER_S * 1e3}
        split = ", ".join(f"{k} {v:.4f}" for k, v in phase_split[tag].items())
        log(f"{tag}: {len(td)} records ({DEEP_GENOMES} genomes' gapless "
            f"records and {DEEP_LOCI} stacks of {DEEP_STACK}), "
            f"{len(d_host[3])} intervals, made in {deep_synth_s:.4f} s; "
            f"histogram rows {rows} bytes ({rows / 2**30:.4f} GiB) in "
            f"{n_batches} batches {plan.batch_off}; {walls[tag]:.4f} s wall "
            f"({split}); {n5} K5 launches; {gpu}")
        log(f"{tag} K5 alone: {deep_ms:.4f} ms one call (plan inside), plan "
            f"{deep_plan_ms:.4f} ms, walks {walk_ms} ms, medians {median_ms} "
            f"ms; {plan.tile_ids.numel()} tiles, {plan.pair_pos.numel()} "
            f"pairs, {tile_batches - plan.tile_ids.numel()} carried tile "
            f"counts; bound {deep_bound['bound_ms']:.4f} ms by bytes "
            f"({d_bytes}), {deep_bound['bound_ms_with_carry']:.4f} ms with "
            f"the carried counts ({carried} bytes); max abs error against "
            f"native.tile_sweep {deep_err}")
        deep = {"records": len(td), "rows_bytes": rows, "batches": n_batches,
                "launches": n5, "wall_s": walls[tag], "ms": deep_ms,
                "plan_ms": deep_plan_ms, "walk_ms": walk_ms,
                "median_ms": median_ms, **deep_bound,
                "max_abs_err_vs_c": deep_err}
        del td, d_args, lv, plan, pair_batch, pair_tile
        shutil.rmtree(gd)
        del tg

        log(f"== mesh (t+{time.perf_counter() - t_start:.1f} s)")
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
        launched(tag, ("build_ext", "run_counts", "run_fill_cigar",
                       "chain_dp", "tile_sweep"))
        log(f"launches during {tag}: {launches[tag]}")
        del staged, piped, tp

        log(f"== multiprocess (t+{time.perf_counter() - t_start:.1f} s)")
        mp_out = os.path.join(d, "multiprocess.paf")
        t0 = time.perf_counter()
        run_world([cpaf, fa, mp_out, "--shards", "2", "--workdir",
                   os.path.join(d, "mp_shards")], 2, MP_TIMEOUT_S, d)
        mp_wall = time.perf_counter() - t0
        expect_pin("two processes of parallel.distributed", mp_out,
                   pin="run_pipeline")
        log(f"two processes of parallel.distributed on chain.paf: "
            f"{mp_wall:.4f} s wall, from their start to their exit")

        log(f"== timing (t+{time.perf_counter() - t_start:.1f} s)")

        def k1():
            return compare.piece_match_counts(ext, table, len(t))

        def k2():
            return mismatch_device.build_ext_pool(raw)

        def k4c():
            return runs.run_counts(ext, table4)

        def k4f():
            return runs.run_fill_cigar(ext, table4, dest4, ops4, lens4)

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
        ops4_plain, lens4_plain = ops4.clone(), lens4.clone()
        timed = {
            "piece_compare": (k1, lambda: compare.piece_match_counts_plain(
                ext, table, len(t))),
            "build_ext": (k2, lambda: mismatch_device.build_ext_pool_plain(
                raw)),
            "run_counts": (k4c, lambda: runs.run_counts_plain(ext, table4)),
            "run_fill_cigar": (k4f, lambda: runs.run_fill_cigar_plain(
                ext, table4, dest4, ops4_plain, lens4_plain)),
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
        # fill reads the same plus 8 bytes of first slot per piece and
        # writes 9 bytes per run (op and length); K5 reads 16 bytes per interval (istart,
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
            "run_fill_cigar": (2 * n_cols + table4.numel() * 8
                               + 8 * n_pieces4 + 9 * n_runs),
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
            plain_ms[name] = cuda_ms(torch, plain, reps=3, warm=1)
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
        # the bar K4 must clear: the port's threaded C passes at full size
        c_threads = min(os.cpu_count() or 1, 8)
        per_mop4 = native.encode_runs_per_mop(*k4_c, n_threads=c_threads)
        _, m_out_off4, c_ops4, c_lens4 = native.encode_rebuild_offsets(
            t.ops, t.lens, per_mop4, ops4.numel())
        c_pass = {
            "run_counts": ("native.encode_runs_per_mop", host_ms(
                lambda: native.encode_runs_per_mop(
                    *k4_c, n_threads=c_threads), reps=5)),
            "run_fill_cigar": ("native.encode_runs_fill_cigar", host_ms(
                lambda: native.encode_runs_fill_cigar(
                    *k4_c, m_out_off4, c_ops4, c_lens4,
                    n_threads=c_threads), reps=5))}
        for name, (what, c_ms) in c_pass.items():
            log(f"{what} on {c_threads} threads at full size: {c_ms:.4f} ms "
                f"(host wall, median of 5), against {name}'s "
                f"{ms[name]:.4f} ms one call at a time")
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
                    torch, k6(k6_full, k, threads), reps=3)
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
            "run_counts": k4_err, "run_fill_cigar": k4_err,
            "tile_sweep": k5_err,
            "chain_dp": k6_err, "group_stats": k7_err}
    sources = {"piece_compare": "piece_compare.cu", "build_ext": "ext_pool.cu",
               "run_counts": "encode_runs.cu",
               "run_fill_cigar": "encode_runs.cu",
               "tile_sweep": "tile_sweep.cu", "chain_dp": "chain_dp.cu",
               "group_stats": "group_stats.cu"}
    replaces = {"piece_compare": "paffy_tpu/ops/pallas_compare.py:161",
                "build_ext": "paffy_tpu/ops/mismatch_device.py:47",
                "run_counts": "paffy_tpu/ops/tiled.py:302",
                "run_fill_cigar": "paffy_tpu/ops/tiled.py:307",
                "tile_sweep": "paffy_tpu/ops/tile_device.py:23",
                "chain_dp": "paffy_tpu/ops/chain_device.py:26",
                "group_stats": "paffy_tpu/parallel/pipeline.py:126"}
    path_of = {"piece_compare": "view -s", "build_ext": "view -s",
               "run_counts": "add_mismatches",
               "run_fill_cigar": "add_mismatches",
               "tile_sweep": "tile", "chain_dp": "chain",
               "group_stats": "column_counts_multichip 1x1"}
    # K6's plain version runs on the prefix only
    sweeps = {name: {k: v for k, v in sweep_ms.items() if k.startswith(name)}
              for name in ("tile_sweep", "chain_dp")}
    extra = {name: {"c_pass": what, "c_pass_ms": c_ms,
                    "c_pass_threads": c_threads}
             for name, (what, c_ms) in c_pass.items()}
    extra |= {"tile_sweep": {"sweep_ms": sweeps["tile_sweep"],
                             "deep_tile": deep},
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
         "launches_run_pipeline_genome": genome_launches[name],
         "launches_library": lib_total[name],
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
