"""The port's multi-process pipeline, run for real: 2 and 4 processes of
``python -m paffy_tpu_torch.parallel.distributed`` in a torch.distributed
gloo group on localhost (PAFFY_TPU_PLATFORM=cpu), each running
``run_pipeline_multihost`` over a multi-contig workload (the four tests of
tests/test_multiprocess.py, ported).  Asserted:

  * the gathered output equals paffy_tpu's single-process run_pipeline
    byte for byte (the barrier, the file gather and the ``s % pcount``
    shard skip all run);
  * a rerun after a shard file is torn, and after a process is killed
    mid-run, gives the same bytes (the atomic shard writes);
  * ``use_mesh=False`` runs the mesh-less stage and equals paffy_tpu's
    ``run_pipeline_multihost(use_mesh=False)``, in one process and in two.

A test skips only when the localhost rendezvous itself fails."""

import os
import pathlib
import socket
import subprocess
import sys
import time

import pytest

from paffy_tpu.core import pafio
from paffy_tpu.parallel.runner import run_pipeline
from ref_native import paffy_tpu_lib  # noqa: F401
from synthdata import make_workload

REPO = pathlib.Path(__file__).resolve().parent.parent
N_PROC = 2
N_SHARDS = 4
N_PROC4 = 4
N_SHARDS7 = 7          # uneven: 7 shards round robin over 4 processes
# what a failed localhost rendezvous prints (the only reason to skip)
RENDEZVOUS_FAILED = ("DistNetworkError", "Address already in use",
                     "Connection refused")


def _free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _launch(pid: int, port: int, args: list[str], log_path: pathlib.Path,
            n_proc: int, cmd=("-m", "paffy_tpu_torch.parallel.distributed")):
    env = dict(os.environ, PAFFY_TPU_PLATFORM="cpu",
               PAFFY_TPU_COORDINATOR=f"localhost:{port}",
               PAFFY_TPU_NUM_PROCESSES=str(n_proc),
               PAFFY_TPU_PROCESS_ID=str(pid), OMP_NUM_THREADS="1")
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, *cmd, *args], env=env, cwd=REPO, stdout=log,
        stderr=subprocess.STDOUT)
    proc._log = log  # keep the handle alive
    return proc


def _run_world(args: list[str], tmp: pathlib.Path, tag: str,
               n_proc: int = N_PROC, kill_pid: int | None = None, **kw):
    """Run one world of ``n_proc`` processes (``_launch``'s ``cmd`` in
    ``kw``); their logs.  With ``kill_pid``, that process is killed 2 s in
    and the survivors get at most 30 s before they are killed too."""
    port = _free_port()
    procs = [_launch(pid, port, args, tmp / f"proc{pid}.{tag}.log", n_proc,
                     **kw)
             for pid in range(n_proc)]
    try:
        if kill_pid is not None:
            time.sleep(2.0)
            procs[kill_pid].kill()
        deadline = time.monotonic() + (30 if kill_pid is not None else 600)
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                if kill_pid is None:
                    raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            p._log.close()
    logs = [(tmp / f"proc{pid}.{tag}.log").read_text()
            for pid in range(n_proc)]
    if kill_pid is None and any(p.returncode != 0 for p in procs):
        joined = "\n".join(logs)
        if any(k in joined for k in RENDEZVOUS_FAILED):
            pytest.skip("the localhost rendezvous failed on this host")
        raise AssertionError(
            "multi-process run failed:\n" +
            "\n---\n".join(f"[proc {i} rc={p.returncode}]\n{lg}"
                           for i, (p, lg) in enumerate(zip(procs, logs))))
    return logs


def _write(tmp, seqs, lines, n_shards):
    (tmp / "in.paf").write_text("\n".join(lines) + "\n")
    with open(tmp / "seqs.fa", "w") as fh:
        for n, s in seqs.items():
            fh.write(f">{n}\n{s}\n")
    t = pafio.parse_paf_text((tmp / "in.paf").read_text())
    return pafio.serialize_paf(run_pipeline(t, seqs, n_shards=n_shards))


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    seqs, lines = make_workload(seed=11, length=16000, n_windows=16,
                                window=1800, step=950)
    return tmp, _write(tmp, seqs, lines, N_SHARDS)


def _args(tmp, out, shards, workdir):
    return [str(tmp / "in.paf"), str(tmp / "seqs.fa"), str(out),
            "--shards", str(shards), "--workdir", str(tmp / workdir)]


def test_two_process_pipeline_matches_single_process(workload):
    tmp, expected = workload
    out = tmp / "out.paf"
    _run_world(_args(tmp, out, N_SHARDS, "shards"), tmp, "run1")
    assert out.exists(), "process 0 did not write the gathered output"
    assert out.read_text() == expected
    # round robin over 4 shards of contiguous groups: each process wrote
    # at least one group's file, and both dropped their reach probes
    assert len(sorted((tmp / "shards").glob("shard_*.paf"))) >= 2
    for pid in range(N_PROC):
        assert (tmp / "shards" / f".reach_p{pid}").exists()


def test_rerun_after_corrupted_shard_is_idempotent(workload):
    tmp, expected = workload
    out = tmp / "out2.paf"
    args = _args(tmp, out, N_SHARDS, "shards2")
    _run_world(args, tmp, "run2")
    assert out.read_text() == expected
    # a killed process's torn shard file, then the world again
    victim = sorted((tmp / "shards2").glob("shard_*.paf"))[0]
    victim.write_text("garbage\tnot-a-paf\n")
    out.unlink()
    _run_world(args, tmp, "run3")
    assert out.read_text() == expected


@pytest.fixture(scope="module")
def workload7(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp4")
    seqs, lines = make_workload(seed=13, length=22000, n_windows=21,
                                window=1700, step=1000)
    # the records over 7 query contigs (renamed copies of the derived
    # sequence), so the contig sharder makes 7 groups of them
    out_lines = []
    for k, ln in enumerate(lines):
        f = ln.split("\t")
        if f[0] == "der.chr1":
            nm = f"der.chr1_{k % N_SHARDS7}"
            seqs.setdefault(nm, seqs["der.chr1"])
            f[0] = nm
        out_lines.append("\t".join(f))
    return tmp, _write(tmp, seqs, out_lines, N_SHARDS7)


def test_four_process_uneven_shards(workload7):
    """4 processes, 7 shards: process 3 runs one shard and the others two;
    the gathered output is single-process's, and every process ran."""
    tmp, expected = workload7
    out = tmp / "out4.paf"
    _run_world(_args(tmp, out, N_SHARDS7, "shards4"), tmp, "p4run1",
               n_proc=N_PROC4)
    assert out.read_text() == expected
    for pid in range(N_PROC4):
        assert (tmp / "shards4" / f".reach_p{pid}").exists()
    # one file per contig group (7 renamed + 2 reverse-strand contigs = 9)
    n_files = len(sorted((tmp / "shards4").glob("shard_*.paf")))
    assert n_files > N_PROC4 and n_files % N_PROC4 != 0, n_files


def test_killed_process_world_rerun(workload7):
    """One process killed mid-run: the survivors cannot finish (the barrier
    never clears) and are killed after 30 s; a fresh world over the same
    workdir then gives the exact bytes, reusing or rewriting what the dead
    world left."""
    tmp, expected = workload7
    out = tmp / "out5.paf"
    args = _args(tmp, out, N_SHARDS7, "shards5")
    _run_world(args, tmp, "p4kill", n_proc=N_PROC4, kill_pid=3)
    if out.exists():
        out.unlink()
    _run_world(args, tmp, "p4rerun", n_proc=N_PROC4)
    assert out.read_text() == expected


# run_pipeline_multihost(use_mesh=False) in a process of the group; a mesh
# would be built here (two processes), so a make_mesh that raises shows
# that the keyword skips it
NO_MESH = """
import sys

import torch.distributed as dist

import paffy_tpu_torch.parallel.distributed as d
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.distenv import initialize_from_env
from paffy_tpu_torch.ops.mismatch import SequencePool


def no_mesh(*args, **kw):
    raise AssertionError("use_mesh=False built a mesh")


d.make_mesh = no_mesh
paf, fasta, out, workdir, shards = sys.argv[1:6]
initialize_from_env()
with open(paf, "rb") as fh:
    t = pafio.parse_paf_data(fh.read())
res = d.run_pipeline_multihost(t, SequencePool.from_fasta_files([fasta]),
                               workdir, n_shards=int(shards), use_mesh=False)
if res is not None:
    with open(out, "wb") as fh:
        fh.write(pafio.serialize_paf_bytes(res))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("n_proc", [1, 2])
def test_use_mesh_false_matches_paffy_tpu(workload, n_proc, monkeypatch):
    from paffy_tpu.parallel.distributed import run_pipeline_multihost
    tmp, _ = workload
    lines = (tmp / "seqs.fa").read_text().split()
    seqs = {h[1:]: s for h, s in zip(lines[::2], lines[1::2])}
    t = pafio.parse_paf_text((tmp / "in.paf").read_text())
    want = pafio.serialize_paf(run_pipeline_multihost(
        t, seqs, str(tmp / f"ref_nomesh{n_proc}"), n_shards=N_SHARDS,
        use_mesh=False))
    out = tmp / f"nomesh{n_proc}.paf"
    args = [str(tmp / "in.paf"), str(tmp / "seqs.fa"), str(out),
            str(tmp / f"nomesh{n_proc}"), str(N_SHARDS)]
    if n_proc == 2:
        _run_world(args, tmp, "nomesh", cmd=("-c", NO_MESH))
        assert out.read_text() == want
        return
    # one process with two local devices: the default would build a mesh
    import torch

    import paffy_tpu_torch.parallel.distributed as d
    from paffy_tpu_torch import devconf
    from paffy_tpu_torch.core import pafio as port_pafio
    from paffy_tpu_torch.ops.mismatch import SequencePool
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(devconf, "devices",
                        lambda: [torch.device("cpu")] * 2)
    monkeypatch.setattr(d, "make_mesh", lambda *a, **k: pytest.fail(
        "use_mesh=False built a mesh"))
    res = d.run_pipeline_multihost(
        port_pafio.parse_paf_data((tmp / "in.paf").read_bytes()),
        SequencePool.from_fasta_files([str(tmp / "seqs.fa")]),
        args[3], n_shards=N_SHARDS, use_mesh=False)
    assert bytes(port_pafio.serialize_paf_bytes(res)).decode() == want
