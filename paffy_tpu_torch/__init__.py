"""paffy_tpu_torch: the PyTorch and CUDA port of paffy-tpu for NVIDIA Hopper.

The port runs every paffy and faffy command (``cli``), the fused pipeline
(``parallel.runner``), its (data, seq) mesh path (``parallel.pipeline``)
and the multi-process runner (``parallel.distributed``).  The device work
of ``view``, ``add_mismatches``, ``tile`` and ``chain`` runs in hand-written
CUDA kernels for ``sm_90a`` (``csrc/*.cu``, built with ``nvcc`` on first
use, see ``kernels``); the other commands are host code, as in paffy_tpu.
It imports ``torch``, never JAX, and nothing of ``paffy_tpu``.

It owns its host layer, each module a counterpart of paffy_tpu's of the same
name: the C++ helpers over ctypes (``native``, a copy of paffy_tpu's
``paffy_io.cpp`` that g++ builds on first use into ``_build/``), PAF parsing
and ``PafTable`` (``core``), the M-run column batch (``ops.segments``), the
cigar transforms (``ops.transforms``), the coverage map (``ops.coverage``),
the command plumbing (``commands.common``) and logging with its profiler
hook (``utils.logging``).  The tests hold each
against paffy_tpu's on the same inputs.  Unlike paffy_tpu it keeps no
numpy or Python second path: a failed g++ build raises, as a failed nvcc
build does.

Device rule (``devconf.device``): ``PAFFY_TPU_PLATFORM=cpu`` selects the CPU
and the kernels' plain PyTorch versions; otherwise the device is ``cuda:0``
(and the mesh's, ``devconf.devices``, every visible card), and a host
without a CUDA device raises instead of falling back.

Library use: ``import paffy_tpu_torch as pt`` gives ``pt.PafTable``,
``pt.pafio`` and ``pt.fasta``, as paffy_tpu exports them
(paffy_tpu/__init__.py:25-26); the device steps are in ``ops.mismatch``
(``SequencePool``, ``column_match_counts``, ``encode_mismatches``),
``ops.transforms`` and ``parallel.runner``.  The exports are imported on
first use (``__getattr__``), so that the command lines, which import this
package first, pay nothing for them; none of them loads torch.  Unlike
paffy_tpu, importing the package starts no distributed runtime
(paffy_tpu/__init__.py:18-23): JAX must join its cluster before any
backend starts, but gloo has no such order, and the multi-process runner
starts its group itself (``parallel.distributed``).
"""

import importlib

__version__ = "0.1.0"
__all__ = ["PafTable", "pafio", "fasta"]


def __getattr__(name: str):
    if name == "PafTable":
        return importlib.import_module("paffy_tpu_torch.core.model").PafTable
    if name in ("pafio", "fasta"):
        return importlib.import_module(f"paffy_tpu_torch.core.{name}")
    raise AttributeError(f"module 'paffy_tpu_torch' has no attribute "
                         f"{name!r}")
