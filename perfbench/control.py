#!/usr/bin/env python3
"""The control of a cell: the plain reference put in the program's place,
computed with one guarantee of the configuration broken, run through the
harness's own run and comparison at the cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

Each job of the run gives the bytes of the mix's reference called with
``control=True`` in place of the program's: add_mismatches' compares the
bytes as they are, without paffy's case folding; the pipeline's computes
its trim's identities in float16, the precision below paffy's float32.
The harness then compares every job with the reference, as in any run,
and has to find the run not correct.  Prints one JSON line a seed:
``correct`` and each number compared.  The window is one job; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import run  # noqa: E402


def put_in_place(traffic) -> None:
    """Makes each job of ``traffic`` give the SHA-256 of the control's
    bytes for its key, worked out once a key."""
    fn = run.lookup(traffic.mix["reference"])
    recs = traffic.inputs["records"][traffic.mix["input"]]
    seqs = traffic.inputs["seqs"]
    digests = {}

    def job(key):
        if key not in digests:
            out, _ = fn(recs, seqs, [key], control=True)
            digests[key] = hashlib.sha256(out[key]).hexdigest()
        return digests[key]
    traffic.run = job


def reading(cell: str, seed: int, require_cuda: bool = True,
            config: dict | None = None) -> dict:
    """``correct``, ``jobs`` and the numbers compared of a run of ``cell``
    with the control in the program's place."""
    rc, res = run.run_cell(cell, seed, 0.0, False, require_cuda=require_cuda,
                           config=config, fault=put_in_place)
    if rc != 0:
        raise RuntimeError(f"the control's run of {cell} exited with {rc}")
    return {"correct": res["correct"], "jobs": res["attempted"],
            **{k: v["value"] for k, v in res["compared"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **reading(args.workload, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
