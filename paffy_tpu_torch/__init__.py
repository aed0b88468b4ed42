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
"""

__version__ = "0.1.0"
