"""Device resolution for the port (counterpart of paffy_tpu/jaxconf.py).

One explicit ``torch.device`` for every command:

  * ``PAFFY_TPU_PLATFORM=cpu`` -> the CPU; every kernel wrapper then runs its
    plain PyTorch version (that is how the tests run the port);
  * unset, ``cuda`` or ``gpu`` -> ``cuda:0``; without a CUDA device this
    raises -- the port never falls back to the CPU on its own;
  * anything else raises.

``devices`` lists every device of that platform, for the mesh path.

Results cross back to the host as int64 numpy arrays (``to_host_i64``), the
PAF data model's integer type, as they are through pinned memory
(``download``, for large outputs), or as a list (``readback``, a few
values the host needs to go on).  While tracing (phases.py), each of them
counts a wait on the card and the bytes it brings down, and ``upload`` the
bytes it sends, on the innermost open span.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from paffy_tpu_torch import phases

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


def devices() -> list[torch.device]:
    """Every device the port may compute on, in order: ``[cpu]`` under
    ``PAFFY_TPU_PLATFORM=cpu``, else every visible CUDA device, cuda:0 to
    cuda:n-1 (raises without CUDA, as ``device`` does).  The mesh path
    (parallel/pipeline.py) lays its slots over them."""
    dev = device()
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def to_host_i64(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a host int64 numpy array (waits for the device)."""
    return _waited(t, lambda: t.to(device="cpu", dtype=torch.int64).numpy())


def readback(t: torch.Tensor) -> list:
    """A small device tensor's values as a list (waits for the device)."""
    return _waited(t, t.tolist)


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Copy a host array to ``dev``; CUDA copies go through pinned memory."""
    host = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return host
    phases.count(bytes_up=host.nbytes)
    return host.pin_memory().to(dev, non_blocking=True)


def download(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array of its own type; CUDA copies go
    through pinned memory (waits for the device)."""
    if t.device.type != "cuda":
        return t.numpy()

    def copy():
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return host.numpy()
    return _waited(t, copy)


def _waited(t: torch.Tensor, read):
    """``read()``, which brings ``t`` to the host; for a CUDA tensor while
    tracing, its seconds and ``t``'s bytes counted as a wait on the card."""
    if t.device.type != "cuda" or not phases.recording():
        return read()
    t0 = phases.time.perf_counter()
    out = read()
    phases.count(wait_s=phases.time.perf_counter() - t0, waits=1,
                 bytes_down=t.nbytes)
    return out
