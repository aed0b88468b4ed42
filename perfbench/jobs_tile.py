"""The job of the tile mix (perfbench/traffic/tile.json): one
``paffy_tpu_torch.cli.paffy_main(argv)`` a job, as ``jobs.PaffyMain``
runs it, on a cell whose inputs hold a PAF and no FASTA.  The mix's
``argv`` names ``{paf}`` (the mix's ``input``) and ``{out}`` (one file in
the run's directory, written anew by each job) and nothing else."""

from __future__ import annotations

import os

from jobs import PaffyMain


class PaffyTile(PaffyMain):
    """``PaffyMain`` with ``{paf}`` and ``{out}`` filled in, no FASTA."""

    def prepare(self) -> None:
        from paffy_tpu_torch.cli import paffy_main
        self._main = paffy_main
        self.out_path = os.path.join(self.workdir, "out.paf")
        self._argv = [a.format(paf=self.paf, out=self.out_path)
                      for a in self.mix["argv"]]
        self.job_keys = ["whole"]
