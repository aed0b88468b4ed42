"""Env-gated ``torch.distributed`` bring-up (counterpart of
paffy_tpu/distenv.py).

Set on every process, with the names paffy_tpu reads, so one launch script
drives either package:
  PAFFY_TPU_COORDINATOR    host:port of process 0
  PAFFY_TPU_NUM_PROCESSES  world size
  PAFFY_TPU_PROCESS_ID     this process's rank

The group is ``gloo``: a host collective that needs no card, as paffy_tpu's
coordination-service barrier needs none.  The pipeline's processes share
nothing but files and barriers (parallel/distributed.py).  With none of
the variables set this is a no-op and everything runs single-process.
"""

from __future__ import annotations

import os

import torch.distributed as dist


def initialize_from_env() -> bool:
    """Join the process group the environment names (idempotent); True
    when a multi-process group is active."""
    coord = os.environ.get("PAFFY_TPU_COORDINATOR")
    if coord is None:
        return False
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}",
            world_size=int(os.environ["PAFFY_TPU_NUM_PROCESSES"]),
            rank=int(os.environ["PAFFY_TPU_PROCESS_ID"]))
    return True


def coordination_barrier(name: str) -> bool:
    """Wait for every process of the group at the barrier ``name`` (the
    name is for the reader and the logs: gloo barriers are ordered);
    False when not running multi-process."""
    if not dist.is_initialized():
        return False
    dist.barrier()
    return True
