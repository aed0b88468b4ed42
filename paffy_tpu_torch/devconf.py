"""Device resolution for the port (counterpart of paffy_tpu/jaxconf.py).

One explicit ``torch.device`` for every command:

  * ``PAFFY_TPU_PLATFORM=cpu`` -> the CPU; every kernel wrapper then runs its
    plain PyTorch version (that is how the tests run the port);
  * unset, ``cuda`` or ``gpu`` -> ``cuda:0``; without a CUDA device this
    raises -- the port never falls back to the CPU on its own;
  * anything else raises.

Results cross back to the host as int64 numpy arrays (``to_host_i64``), the
PAF data model's integer type, or as they are through pinned memory
(``download``, for large outputs).
"""

from __future__ import annotations

import os

import numpy as np
import torch

PLATFORM_ENV = "PAFFY_TPU_PLATFORM"


def device() -> torch.device:
    """The device the port computes on, from ``PAFFY_TPU_PLATFORM``."""
    plat = os.environ.get(PLATFORM_ENV, "").strip().lower()
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        raise ValueError(
            f"{PLATFORM_ENV}={plat!r} is not a platform of paffy_tpu_torch "
            f"(use 'cpu', or leave it unset for cuda:0)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paffy_tpu_torch needs a CUDA device and none is available; "
            f"set {PLATFORM_ENV}=cpu to run the plain PyTorch versions on "
            "the CPU")
    return torch.device("cuda", 0)


def to_host_i64(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a host int64 numpy array (waits for the device)."""
    return t.to(device="cpu", dtype=torch.int64).numpy()


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Copy a host array to ``dev``; CUDA copies go through pinned memory."""
    host = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return host
    return host.pin_memory().to(dev, non_blocking=True)


def download(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array of its own type; CUDA copies go
    through pinned memory (waits for the device)."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()
