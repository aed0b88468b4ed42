"""Build and load the port's CUDA kernels (counterpart of the lazy g++
build in paffy_tpu/native/__init__.py).

On first use, every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per file, all started together, and the objects
are linked into one shared library with a plain C interface, which is
loaded with ``ctypes`` -- no PyTorch headers, so a build takes seconds.
The library's name carries a hash of the sources (``*.cu`` and ``*.cuh``)
and flags, so an edited source rebuilds; it lives in
``paffy_tpu_torch/_build/`` (git-ignored).  A failed build raises: nothing
falls back.

C interface (every entry point takes the CUDA device index of its tensors
first, makes that device current for the launch and then restores the
caller's (csrc/device_guard.cuh), launches on the given stream of that
device, allocates nothing, and returns ``cudaGetLastError()``; ``check``
raises on non-zero):

    int paffy_build_ext(int dev, const u8* pool, i64 L, u8* ext,
                        cudaStream_t s)
    int paffy_piece_counts(int dev, const u8* ext, i64 ext_len,
                           const i64* table, i64 n_pieces, u64* match,
                           cudaStream_t s)
    int paffy_run_counts(int dev, const u8* ext, i64 ext_len,
                         const i64* table, i64 n_pieces, i32* counts,
                         cudaStream_t s)
    int paffy_run_fill_cigar(int dev, const u8* ext, i64 ext_len,
                             const i64* table, i64 n_pieces,
                             const i64* first_dest, u8* new_ops,
                             i64* new_lens, cudaStream_t s)
    int paffy_tile_walk(int dev, i64 n_tiles, const i64* tile_ids,
                        const i64* pair_off, const i64* pair_pos,
                        const i64* order, const i64* arena_off,
                        const i64* run_off, const i64* istart,
                        const i64* iend, const i64* row_off, u32* hist,
                        i64 hist_base, i64 pos_lo, i64 pos_hi, u16* carry,
                        i64 cap, i64 tile, cudaStream_t s)
    int paffy_tile_median(int dev, i64 pos_lo, i64 pos_hi, const i64* order,
                          const i64* row_off, const u32* hist,
                          i64 hist_base, i64* levels, cudaStream_t s)
    int paffy_chain_dp(int dev, i64 n_groups, const i64* goff, const i64* qs,
                       const i64* ts, const i64* score, const i64* qe_s,
                       const i64* te_s, const i64* idx_s, const i64* lo,
                       const i64* w, const i64* pos, i64 gap_open,
                       i64 gap_extend, i64 max_gap, i64 k, i64 ring,
                       i64 threads, i64* cs_sorted, i64* cs, i64* pred,
                       cudaStream_t s)
    int paffy_group_stats(int dev, const u8* ext, i64 ext_len,
                          const i64* table, i64 n_pieces, u64* match,
                          u64* cols, u64* totals, cudaStream_t s)
    const char* paffy_error_string(int code)

``LAUNCHES`` counts kernel launches per kernel name.  Each wrapper adds one
(``count_launch``, under a lock: the pipeline's worker threads launch at
once) where it launches its kernel and nowhere else, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"piece_compare": 0, "build_ext": 0, "run_counts": 0,
            "run_fill_cigar": 0, "tile_sweep": 0, "chain_dp": 0,
            "group_stats": 0}

_lock = threading.Lock()
_lib = None
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to ``LAUNCHES``."""
    with _count_lock:
        LAUNCHES[name] += 1


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of paffy_tpu_torch cannot be built")


def library_path() -> Path:
    return BUILD_DIR / f"libpaffy_torch_kernels_{_digest()}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; their joined output, or raise on the first
    that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {p.returncode}:"
                               f"\n{' '.join(c)}\n{o}")
    return "".join(outs)


def build() -> Path:
    """Compile the sources unless a library of the same hash exists: one
    nvcc per source, all at once, then one link.  ``nvcc``'s output
    (``-Xptxas -v``: registers, shared memory, spills per kernel) is kept
    beside the library; see ``build_log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out.with_name(f"{p.stem}.{tag}.o") for p in sources()]
    tmp = out.with_name(f"{out.name}.{tag}")
    nvcc = _nvcc()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                        for p, o in zip(sources(), objs)])
        # the link names the same target, or nvcc assumes an old default
        log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                          *map(str, objs)]])
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """nvcc's output from the build of the current sources ('' if none)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i64, dev = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.paffy_build_ext.argtypes = [dev, vp, i64, vp, vp]
            lib.paffy_piece_counts.argtypes = [dev, vp, i64, vp, i64, vp, vp]
            lib.paffy_run_counts.argtypes = [dev, vp, i64, vp, i64, vp, vp]
            lib.paffy_run_fill_cigar.argtypes = [dev, vp, i64, vp, i64, vp,
                                                 vp, vp, vp]
            lib.paffy_tile_walk.argtypes = [dev, i64, *[vp] * 10, i64, i64,
                                            i64, vp, i64, i64, vp]
            lib.paffy_tile_median.argtypes = [dev, i64, i64, vp, vp, vp, i64,
                                              vp, vp]
            lib.paffy_chain_dp.argtypes = [dev, i64, *[vp] * 10, *[i64] * 6,
                                           vp, vp, vp, vp]
            lib.paffy_group_stats.argtypes = [dev, vp, i64, vp, i64, vp, vp,
                                              vp, vp]
            for fn in (lib.paffy_build_ext, lib.paffy_piece_counts,
                       lib.paffy_run_counts, lib.paffy_run_fill_cigar,
                       lib.paffy_tile_walk, lib.paffy_tile_median,
                       lib.paffy_chain_dp, lib.paffy_group_stats):
                fn.restype = ctypes.c_int
            lib.paffy_error_string.argtypes = [ctypes.c_int]
            lib.paffy_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = load().paffy_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {rc} ({msg})")


def check_device(dev) -> int:
    """The index of ``dev``, a CUDA device of this process; raise for any
    other device.  Each entry point of the library takes this index and
    launches on that device, in its primary context, which it shares with
    PyTorch (streams and memory included)."""
    import torch
    n = torch.cuda.device_count()
    if dev.type == "cuda" and n:
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if 0 <= index < n:
            return index
    raise ValueError(f"the CUDA kernels run on a CUDA device of this "
                     f"process ({n} visible), not on {dev}")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
