"""The jobs of the benchmark's traffic mixes.  A mix
(perfbench/traffic/<name>.json) names its kind of job under ``job``, as
``module:Class`` of perfbench: a subclass of ``Traffic`` here, or in a
module of its own, that the harness builds from the mix and the cell's
inputs.  A closed loop with one client runs its jobs back to back.

Keys every mix has:

* ``job``     -- the kind of job, ``module:Class``.
* ``input``   -- which PAF of the cell the jobs read: ``gapped`` (a pair's
  in.paf) or ``gapless`` (one record per M run: chain.paf, genome.paf).
* ``env``     -- environment variables set before the program is imported.
* ``reference`` -- ``module:function`` of perfbench that gives the expected
  bytes of each job key from (records, sequences, keys): ({key: bytes},
  {key: [work of each launch]}); with ``control=True`` the control's.
* ``trace_jobs`` -- how many jobs of the window the device trace of a
  ``--trace 1`` run covers.

The kinds here:

* ``PaffyMain`` -- one ``paffy_tpu_torch.cli.paffy_main(argv)`` a job, the
  mix's ``argv`` with ``{fasta}``, ``{paf}`` and ``{out}`` filled in
  (``{out}`` one file in the run's directory, written anew by each job).
* ``Pipeline`` -- the ``SequencePool`` built from the FASTA, then
  ``parallel.runner.run_pipeline`` on the input table, parsed in set-up,
  then ``core.pafio.serialize_paf`` in memory.

Each job returns the SHA-256 of its output bytes under its key (here
always ``whole``).  The benchmark's own spans around the calls of a job
(``paffy_main``; ``pool``, ``run_pipeline``, ``serialize``) are timed in
every job and marked in the trace of a traced one.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time

import numpy as np


class Traffic:
    """The jobs of one cell: ``prepare`` in set-up (it sets ``job_keys``),
    then ``keys`` (the key of each job in turn, from the seed) and
    ``run(key)``, and ``release`` before the check."""

    def __init__(self, mix: dict, inputs: dict, seed: int, workdir: str):
        self.mix = mix
        self.inputs = inputs
        self.seed = seed
        self.workdir = workdir
        self.paf = inputs["files"][mix["input"]]
        self.span_s: dict[str, float] = {}   # the benchmark's spans' seconds
        self.record = None      # torch.profiler.record_function, if traced
        self.job_keys: list[str] = []

    @contextlib.contextmanager
    def spans(self, name: str):
        """Times the block into ``span_s[name]`` and, in a traced job,
        marks it in the trace as ``name``."""
        t0 = time.perf_counter()
        if self.record is None:
            yield
        else:
            with self.record(name):
                yield
        self.span_s[name] = self.span_s.get(name, 0.0) + (
            time.perf_counter() - t0)

    def prepare(self) -> None:
        raise NotImplementedError

    def run(self, key: str) -> str:
        raise NotImplementedError

    def keys(self):
        """The key of each job in turn: the job keys in a permutation drawn
        from the seed, cycled."""
        rng = np.random.default_rng([self.seed, 17])
        order = [self.job_keys[i] for i in rng.permutation(len(self.job_keys))]
        while True:
            yield from order

    def release(self) -> None:
        """Drop what the program built before the check."""
        self.__dict__.clear()


class PaffyMain(Traffic):
    """One ``paffy_main(argv)`` a job, reading the files as they are."""

    def prepare(self) -> None:
        from paffy_tpu_torch.cli import paffy_main
        self._main = paffy_main
        self.out_path = os.path.join(self.workdir, "out.paf")
        self._argv = [a.format(fasta=self.inputs["files"]["fasta"],
                               paf=self.paf, out=self.out_path)
                      for a in self.mix["argv"]]
        self.job_keys = ["whole"]

    def run(self, key: str) -> str:
        with self.spans("paffy_main"):
            rc = self._main(list(self._argv))
        if rc != 0:
            raise RuntimeError(f"paffy_main exited with {rc}")
        with open(self.out_path, "rb") as fh:
            return hashlib.file_digest(fh, "sha256").hexdigest()


class Pipeline(Traffic):
    """The pool built, ``run_pipeline`` and ``serialize_paf`` on the whole
    table a job; the table parsed in set-up."""

    def prepare(self) -> None:
        from paffy_tpu_torch.core import pafio
        from paffy_tpu_torch.ops.mismatch import SequencePool
        from paffy_tpu_torch.parallel import runner
        self._pafio, self._runner = pafio, runner
        self._pool_cls = SequencePool
        with open(self.paf, "rb") as fh:
            self.table = pafio.parse_paf_data(fh.read())
        self.job_keys = ["whole"]

    def run(self, key: str) -> str:
        with self.spans("pool"):
            pool = self._pool_cls.from_fasta_files(
                [self.inputs["files"]["fasta"]])
        with self.spans("run_pipeline"):
            out = self._runner.run_pipeline(self.table, pool)
        with self.spans("serialize"):
            text = self._pafio.serialize_paf(out)
        return hashlib.sha256(text.encode("latin-1")).hexdigest()
