#!/usr/bin/env python3
"""Smoke run of paffy_tpu_torch on one NVIDIA GPU: ``paffy view -s`` at
chromosome scale through the port's CUDA kernels.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (any failure exits non-zero and prints no result line):

1. build   -- nvcc builds csrc/*.cu for sm_90a (its -Xptxas -v lines are
              printed) and g++ the port's native host library.
2. synth   -- a seeded workload at the scale of a human-chimp chr10 pair:
              two 135 Mbp sequences (soft-masked, with runs of N), 208 PAF
              records, 1.25e8 M columns in runs of median ~420 columns split
              by 1-8 bp indels, 30% '-' strand; written as FASTA and PAF to
              a temporary directory.  Their SHA-256 digests must equal the
              pinned ones (PINS).
3. view    -- the port's ``view -s`` (the main path, launch counts reset
              before it) and ``view -s -t`` on cuda:0.  The digests of their
              outputs must equal the pinned digests of paffy_tpu's ``view``
              on the same files (its host C route), and the aggregate line
              must agree with the synthesized alignment.
4. counts  -- the port's per-record counts against the single-threaded C
              loop (native.column_compare_counts) over independently built
              run arrays; K1 and K2 against their plain PyTorch versions on
              the card at full size, and K1 against its plain version and
              the C loop on its edge cases (k1_edge_cases).  Exact equality:
              integer and byte outputs.
5. timing  -- K1 and K2 and their plain versions with CUDA events (median
              after warm-up), each beside its bound (the bytes it must move
              over 3.35 TB/s), the port's view wall time split by phase,
              peak device memory.  A kernel's ``ms`` is one call at a time
              between two events, so it includes the host's launch work;
              ``ms_20_in_a_row`` is the time per call of 20 calls between
              two events, which hides that work behind the kernels.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
This script uses only paffy_tpu_torch, and imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
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

# SHA-256 of the seed-0 synthesis and of paffy_tpu's view output on it
# (host C route); how they were made is in PERF.md
PINS = {
    "seqs.fa": "5e4d5d8787566cbba4677b110e206d3355fdabe151b45a21851ab56c9f6b9c80",
    "in.paf": "056d1e714c15d00b20db3ecc10efba39f4c2322ec8a4b15874d1f08514b2f769",
    "view -s": "c530168cf5970932616ad3eee0f20e7184f6bf0e000ba2ccbac65e6a9c7da473",
    "view -s -t": "91d9b93f69992fcd06510a7276c7d1be03fd3cf71b0d6a5d7638b5b7e0c428eb",
}

# the K1 edge cases, see k1_edge_cases
K1_EDGE_LABELS = ("every residue, + strand", "every residue, - strand",
                  "both ends of ext")


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


def expect_equal(what, a, b):
    if a != b:
        raise AssertionError(f"{what}: {a!r} != {b!r}")
    log(f"ok: {what}")


def expect_pin(what, path):
    expect_equal(f"SHA-256 of {what} is the pinned one", sha256_file(path),
                 PINS[what])


# ---------------------------------------------------------------------- main

def run(torch) -> dict:
    from paffy_tpu_torch import devconf, kernels, native, phases
    from paffy_tpu_torch.cli import paffy_main
    from paffy_tpu_torch.core import pafio
    from paffy_tpu_torch.ops import compare, mismatch, mismatch_device
    from paffy_tpu_torch.ops.segments import build_m_column_batch

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
    native.get_lib()
    log(f"g++ {native.library_path().name} in {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="paffy_smoke_") as d:
        log("== synth")
        fa, paf, w = build_files(d, native)
        expect_pin("seqs.fa", fa)
        expect_pin("in.paf", paf)

        log("== view")
        walls, phase_split = {}, {}
        for tag, flags in (("view -s", ["-s"]), ("view -s -t", ["-s", "-t"])):
            ours = os.path.join(d, "ours.txt")
            if tag == "view -s":
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
            phases.reset()
            t0 = time.perf_counter()
            rc = paffy_main(["view", "-i", paf, *flags, "-o", ours, fa])
            walls[tag] = time.perf_counter() - t0
            phase_split[tag] = dict(phases.SECONDS)
            if tag == "view -s":
                launches = dict(kernels.LAUNCHES)
                peak = torch.cuda.max_memory_allocated()
            expect_equal(f"port {tag} exit code", rc, 0)
            expect_pin(tag, ours)
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
        for k, n in launches.items():
            if n <= 0:
                raise AssertionError(f"kernel {k} was not launched by the "
                                     f"port's view -s")
        log(f"launches during the port's view -s: {launches}")

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

        log("== timing")

        def k1():
            return compare.piece_match_counts(ext, table, len(t))

        def k2():
            return mismatch_device.build_ext_pool(raw)
        k1_ms = cuda_ms(torch, k1, reps=20)
        k2_ms = cuda_ms(torch, k2, reps=20)
        k1_row_ms = cuda_ms(torch, k1, reps=7, batch=20)
        k2_row_ms = cuda_ms(torch, k2, reps=7, batch=20)
        k1_plain_ms = cuda_ms(torch, lambda: compare.piece_match_counts_plain(
            ext, table, len(t)), reps=5, warm=1)
        k2_plain_ms = cuda_ms(torch, lambda: mismatch_device.build_ext_pool_plain(
            raw), reps=5, warm=1)
        # bytes each kernel must move: K1 reads 2 bytes of ext per column
        # and 32 bytes of table per piece and writes 8 bytes per record; K2
        # reads the pool (L) and writes ext (2L)
        k1_bytes = 2 * n_cols + table_np.nbytes + 8 * len(t)
        k2_bytes = 3 * raw.numel()
        k1_bound_ms = k1_bytes / HBM_BYTES_PER_S * 1e3
        k2_bound_ms = k2_bytes / HBM_BYTES_PER_S * 1e3
        log(f"20 calls in a row, per call: K1 {k1_row_ms:.4f} ms "
            f"({k1_bound_ms / k1_row_ms:.1%} of bound), K2 {k2_row_ms:.4f} ms "
            f"({k2_bound_ms / k2_row_ms:.1%} of bound)")
        log(f"K1 piece_compare: {k1_ms:.4f} ms one call at a time "
            f"(plain {k1_plain_ms:.4f} ms) "
            f"over {n_cols} columns, {n_pieces} pieces: "
            f"{n_cols / (k1_ms / 1e3) / 1e9:.2f} Gcol/s; {k1_bytes} bytes, "
            f"bound {k1_bound_ms:.4f} ms at 3.35 TB/s = "
            f"{k1_bound_ms / k1_ms:.1%} of bound")
        log(f"K2 build_ext: {k2_ms:.4f} ms one call at a time "
            f"(plain {k2_plain_ms:.4f} ms) over "
            f"{raw.numel()} pool bytes (read L + write 2L = {k2_bytes} "
            f"bytes), bound {k2_bound_ms:.4f} ms = "
            f"{k2_bound_ms / k2_ms:.1%} of bound")
        for tag in walls:
            split = ", ".join(f"{k} {v:.4f}" for k, v in
                              phase_split[tag].items())
            dev_s = sum(v for k, v in phase_split[tag].items()
                        if k in ("pool upload", "K2", "upload", "kernel"))
            log(f"port {tag}: {walls[tag]:.4f} s wall ({split}; phases "
                f"holding device work {dev_s:.4f} s = "
                f"{dev_s / walls[tag]:.1%} of wall); "
                f"{n_cols / walls[tag] / 1e6:.1f} Mcol/s end to end")
        log(f"peak device memory during the port's view -s: "
            f"{peak / 2**20:.1f} MiB")
        log(gpu)

    return {"kernels": [
        {"name": "piece_compare", "route": "cuda",
         "source": "paffy_tpu_torch/csrc/piece_compare.cu",
         "replaces": "paffy_tpu/ops/pallas_compare.py:161",
         "launches": launches["piece_compare"], "max_abs_err": k1_err,
         "ms": k1_ms, "ms_20_in_a_row": k1_row_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound_ms, "bound_by": "bytes", "library_ms": None},
        {"name": "build_ext", "route": "cuda",
         "source": "paffy_tpu_torch/csrc/ext_pool.cu",
         "replaces": "paffy_tpu/ops/mismatch_device.py:47",
         "launches": launches["build_ext"], "max_abs_err": k2_err,
         "ms": k2_ms, "ms_20_in_a_row": k2_row_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound_ms, "bound_by": "bytes", "library_ms": None},
    ]}


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
