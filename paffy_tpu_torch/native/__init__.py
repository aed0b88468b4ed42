"""ctypes bindings of the port's native C++ host library (counterpart of
paffy_tpu/native/__init__.py, for the entry points the port calls), and the
build of the port's native fast lane.

``paffy_io.cpp`` here is the port's own copy of paffy_tpu's.  On first use
it is compiled by ``g++`` into ``paffy_tpu_torch/_build/`` (git-ignored)
under a name that carries a hash of the source, the flags and the CPU's
features, so an edited source or another CPU rebuilds, as ``kernels`` does
for the CUDA sources.  A failed build raises: the port has no second, numpy
path for any of these passes.

The same first use also builds ``paffy_fast`` (``build_fast``): the
executable of ``paffy_fast.cpp`` and ``paffy_io.cpp`` that ``bin/paffy-torch``
runs for the seven host-only commands, so the first call of such a command
runs the Python lane and later calls run the binary.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import stat
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "paffy_io.cpp"
_FAST_SRC = _SRC.with_name("paffy_fast.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
FAST_FLAGS = ("-O3", "-march=native", "-std=c++17", "-pthread")
# the fixed name bin/paffy-torch tests and execs: a link to fast_path()
FAST_LINK = BUILD_DIR / "paffy_fast"

_lock = threading.Lock()
_lib = None

_I64P = ctypes.POINTER(ctypes.c_longlong)
_I32P = ctypes.POINTER(ctypes.c_int)
_U8P = ctypes.POINTER(ctypes.c_ubyte)
_U16P = ctypes.POINTER(ctypes.c_ushort)
_LL = ctypes.c_longlong
_CP = ctypes.c_char_p
_VPP = ctypes.POINTER(ctypes.c_void_p)
# leading arguments of encode_serialize_sizes / _fill
_ENC_COMMON = [_LL, _I64P, _U8P, _U8P, _I64P, _I64P, _CP, _U8P, _I64P, _I64P,
               _U8P, _I64P, _I64P]
# leading arguments of shatter_serialize_sizes / _fill
_SHAT_COMMON = [_LL, _I64P, _U8P, _U8P, _I64P, _I64P, _CP, _U8P, _I64P, _I64P]


def _cpu_features() -> bytes:
    """The CPU's feature flags: ``-march=native`` code built for one CPU
    may not run on another, so a copied build directory must not be
    reused on a different machine."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            for line in fh:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.machine().encode()


def _hashed(stem: str, suffix: str, flags, sources) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(_cpu_features())
    for src in sources:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}{suffix}"


def library_path() -> Path:
    return _hashed("libpaffy_io", ".so", GXX_FLAGS, (_SRC,))


def fast_path() -> Path:
    return _hashed("paffy_fast", "", FAST_FLAGS, (_FAST_SRC, _SRC))


def _compile(out: Path, flags, sources) -> Path:
    """``g++ flags sources -o out``, unless ``out`` exists.  Processes that
    build at once take turns on a lock file and each writes its own
    temporary name, so none loads or replaces a half-written file."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():                  # built while this one waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *flags, *map(str, sources), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except OSError as e:
            raise RuntimeError(f"g++ not found ({e}); the host code of "
                               f"paffy_tpu_torch cannot be built") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed with exit code {proc.returncode}:"
                               f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _build() -> Path:
    return _compile(library_path(), GXX_FLAGS, (_SRC,))


def build_fast() -> Path:
    """Build the native fast lane if its sources, flags or CPU changed, and
    point ``FAST_LINK`` at it; returns the binary's path.  A failed build
    raises.  The binary's time is made newer than both sources, which is
    what ``bin/paffy-torch`` checks before it execs the link."""
    out = _compile(fast_path(), FAST_FLAGS, (_FAST_SRC, _SRC))
    if not (FAST_LINK.is_symlink() and os.readlink(FAST_LINK) == out.name):
        tmp = FAST_LINK.with_name(f"{FAST_LINK.name}.{os.getpid()}.tmp")
        tmp.unlink(missing_ok=True)
        tmp.symlink_to(out.name)
        os.replace(tmp, FAST_LINK)
    # sh's -nt compares whole seconds: a binary kept from before a source
    # was touched, or built in the second of a source's last write, is
    # moved past it
    newest = int(max(_SRC.stat().st_mtime, _FAST_SRC.stat().st_mtime))
    if int(out.stat().st_mtime) <= newest:
        os.utime(out, (newest + 1, newest + 1))
    return out


def fast_is_fresh() -> bool:
    """Whether ``bin/paffy-torch`` execs the fast lane: its own ``sh`` test
    that ``FAST_LINK`` is executable and newer than both sources."""
    test = '[ -x "$0" ] && [ "$0" -nt "$1" ] && [ "$0" -nt "$2" ]'
    return subprocess.run(["sh", "-c", test, str(FAST_LINK), str(_FAST_SRC),
                           str(_SRC)]).returncode == 0


# (name, restype, argtypes) of every entry point bound here
_SIGNATURES = (
    ("paf_scan", _LL, [_CP, _LL, _I64P, _I64P, _I64P]),
    ("paf_fill", _LL, [_CP, _LL, _I64P, _U8P, _U8P, _I64P, _I64P, _CP, _U8P,
                       _I64P, _I64P]),
    ("paf_scan_mt", _LL, [_CP, _LL, _LL, _I64P, _I64P, _I64P, _I64P,
                          _I64P]),
    ("paf_fill_mt", _LL, [_CP, _LL, _LL, _I64P, _I64P, _I64P, _I64P, _I64P,
                          _I64P, _U8P, _U8P, _I64P, _I64P, _CP, _U8P, _I64P,
                          _I64P]),
    ("paf_scan_raw_mt", _LL, [_CP, _LL, _LL, _I64P, _I64P, _I64P, _I64P]),
    ("paf_fill_raw_mt", _LL, [_CP, _LL, _LL, _I64P, _I64P, _I64P, _I64P,
                              _I64P, _U8P, _U8P, _I64P, _I64P, _CP, _I64P,
                              _I64P, _LL, _I64P]),
    ("pack_ints13", None, [_LL, ctypes.POINTER(_I64P), _I64P, _LL]),
    ("cigar_stats", None, [_LL, _U8P, _I64P, _I64P, _I64P]),
    ("cigar_stats_raw", None, [_LL, _CP, _I64P, _I64P, _I64P, _LL]),
    ("paf_check_batch", _LL, [_LL, _I64P, _U8P, _I64P, _I64P, _I64P, _I64P,
                              _I64P, _I64P, _I64P, _U8P, _I64P]),
    ("copy_op_ranges", None, [_LL, _I64P, _I64P, _I64P, _U8P, _I64P, _U8P,
                              _I64P, _LL]),
    ("build_mop_batch", _LL, [_LL, _U8P, _I64P, _I64P, _U8P, _I64P, _I64P,
                              _I64P, _I64P, _I64P, _I64P, _I64P, _I64P,
                              _I64P, _U8P, _I64P, _I64P, _I64P]),
    ("view_stats_lines", _LL, [_LL, _I64P, _I64P, _CP, _I64P, _CP]),
    ("view_render_batch", None, [_LL, _I64P, _U8P, _I64P, _I64P, _I64P,
                                 _I64P, _U8P, _U8P, _I64P, _I64P, _I64P,
                                 _I64P, _CP, _I64P, _I64P, _CP, _LL]),
    ("fasta_scan", None, [_CP, _LL, _I64P, _I64P, _I64P]),
    ("fasta_fill_headers", None, [_CP, _LL, _CP, _I64P, _I64P]),
    ("fasta_pack_scan", _LL, [_LL, _VPP, _I64P, _LL, _I64P, _I64P]),
    ("fasta_pack_fill", None, [_VPP, _LL, _I64P, _LL, _U8P, _LL, _CP, _LL,
                               _I64P, _I64P, _I64P]),
    ("fasta_map", ctypes.c_void_p, [_CP, _I64P]),
    ("fasta_unmap", None, [ctypes.c_void_p, _LL]),
    ("column_compare_counts", None, [_U8P, _LL, _I64P, _I64P, _I64P, _U8P,
                                     _I64P, _I64P, _I64P]),
    ("synth_query_pool", None, [_U8P, _LL, _I64P, _I64P, _I64P, _U8P, _LL,
                                ctypes.c_ulonglong]),
    ("paf_serialize_sizes", None, [_LL, _I64P, _U8P, _U8P, _I64P, _I64P, _CP,
                                   _U8P, _I64P, _I64P, _I64P, _I64P, _I64P,
                                   _LL]),
    ("paf_serialize_fill", _LL, [_LL, _I64P, _U8P, _U8P, _I64P, _I64P, _CP,
                                 _U8P, _I64P, _I64P, _I64P, _CP, _I64P, _I64P,
                                 _I64P, _CP, _LL]),
    ("encode_rebuild_offsets", None, [_LL, _U8P, _I64P, _I64P, _I64P, _I64P,
                                      _U8P, _I64P, _I64P]),
    ("match_intervals", _LL, [_LL, _I64P, _U8P, _I64P, _I64P, _I64P, _I64P,
                              _I64P]),
    ("tile_intervals", _LL, [_LL, _I64P, _U8P, _I64P, _I64P, _I64P, _I64P,
                             _I64P, _I64P]),
    ("query_walk_violation", _LL, [_LL, _I64P, _U8P, _I64P, _I64P, _I64P,
                                   _I64P]),
    ("encode_runs_per_mop", None, [_U8P, _LL, _I64P, _I64P, _I64P, _U8P,
                                   _I64P, _LL]),
    ("encode_runs_fill_cigar", None, [_U8P, _LL, _I64P, _I64P, _I64P, _U8P,
                                      _I64P, _U8P, _I64P, _LL]),
    ("encode_serialize_sizes", None, _ENC_COMMON + [_I64P, _LL]),
    ("encode_serialize_fill", _LL, _ENC_COMMON + [_I64P, _CP, _LL]),
    ("tile_sweep", None, [_LL, _I64P, _I64P, _I64P, _I64P, _I64P, _U16P, _LL,
                          _I64P]),
    ("chain_dp", None, [_LL, _I64P, _I64P, _I64P, _I64P, _I64P, _I64P, _I64P,
                        _I64P, _LL, _LL, _LL, _I64P, _I64P]),
    ("chain_extract", _LL, [_LL] + [_I64P] * 7 + [_LL, _LL, _LL]
     + [_I64P] * 3),
    ("trim_tails_apply", None, [_LL, _I64P, _U8P, _I64P, _U8P, ctypes.c_float,
                                ctypes.c_float, _I64P, _I64P, _I64P, _I64P,
                                _I64P, _I64P, _LL]),
    ("trim_tails_raw", None, [_LL, _CP, _I64P, _I64P, _U8P, ctypes.c_float,
                              ctypes.c_float, _I64P, _I64P, _I64P, _I64P,
                              _I64P, _I64P, _LL]),
    ("shatter_violation", _LL, [_LL, _I64P, _U8P, _I64P, _U8P, _I64P, _I64P,
                                _I64P, _I64P, _I64P, _I64P, _I64P]),
    ("shatter_walk", None, [_LL, _I64P, _U8P, _I64P, _I64P, _I64P, _I64P,
                            _U8P, _I64P, _I64P, _I64P, _I64P, _I64P, _LL]),
    ("shatter_serialize_sizes", None, _SHAT_COMMON + [_I64P, _LL]),
    ("shatter_serialize_fill", _LL, _SHAT_COMMON + [_I64P, _CP, _LL]),
    ("invert_ops", None, [_LL, _I64P, _U8P, _I64P, _U8P, _U8P, _I64P, _LL]),
    ("invert_serialize_fill", _LL, [_LL, _I64P, _U8P, _U8P, _I64P, _I64P,
                                    _CP, _CP, _I64P, _I64P, _I64P, _CP, _LL]),
    ("coverage_add", None, [_I32P, _I64P, _I64P, _LL]),
    ("coverage_counts", None, [_I64P, _LL, _LL, _U16P]),
    ("coverage_counts32", None, [_I32P, _LL, _LL, _U16P]),
    ("rle_u16_count", _LL, [_U16P, _LL, _LL]),
    ("rle_u16_fill", None, [_U16P, _LL, _LL, _I64P, _I64P, _I64P]),
)


def get_lib():
    """The loaded library, built on first use together with the fast lane
    (``build_fast``)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, restype, argtypes in _SIGNATURES:
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            build_fast()
            _lib = lib
        return _lib


def _p_i64(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _p_u8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def _default_threads(n_threads):
    return min(os.cpu_count() or 1, 8) if n_threads is None else n_threads


class NativeParseError(ValueError):
    """Malformed PAF input.  ``line_no`` is the 1-based line number within
    the data passed to the failing parse call, so a streaming caller can
    emit the records before it (the reference writes record-at-a-time)."""

    def __init__(self, msg, line_no=None):
        super().__init__(msg)
        self.line_no = line_no


_PARSE_MT_BYTES = 4 << 20   # thread the parse above 4 MB of input


def _names(raw: bytes, qoff, toff, n):
    """Each record's query and target name (object arrays of str) from the
    fill pass's pool of NUL-terminated names: the pool decoded and split
    once, each name found by its offset among the names' starts."""
    parts = np.empty(raw.count(b"\0") + 1, dtype=object)
    parts[:] = raw.decode("latin-1").split("\0")
    starts = np.flatnonzero(np.frombuffer(raw, dtype=np.uint8) == 0) + 1
    starts = np.concatenate([[0], starts])
    return (parts[np.searchsorted(starts, qoff)],
            parts[np.searchsorted(starts, toff)])


def parse_paf_bytes(data: bytes, n_threads: int | None = None):
    """Parse PAF text with the native tokenizer (threaded above 4 MB:
    newline-aligned shards whose counts are cumsummed into the fill pass's
    base offsets; identical arrays and error line numbers).

    Returns (ints[n,13], flags[n], type[n], qnames, tnames, ops, lens, off).
    """
    lib = get_lib()
    nt = _default_threads(n_threads) if len(data) >= _PARSE_MT_BYTES else 1
    if nt > 1:
        bounds = np.empty(nt + 1, dtype=np.int64)
        s_rec, s_ops, s_names, s_lines = (np.empty(nt, dtype=np.int64)
                                          for _ in range(4))
        rc = lib.paf_scan_mt(data, len(data), nt, _p_i64(bounds),
                             _p_i64(s_rec), _p_i64(s_ops), _p_i64(s_names),
                             _p_i64(s_lines))
        if rc != 0:
            raise NativeParseError(f"malformed PAF at line {rc}", rc)
        n, t_ops, nb = int(s_rec.sum()), int(s_ops.sum()), int(s_names.sum())
    else:
        n_rec, n_ops, name_bytes = _LL(), _LL(), _LL()
        rc = lib.paf_scan(data, len(data), ctypes.byref(n_rec),
                          ctypes.byref(n_ops), ctypes.byref(name_bytes))
        if rc != 0:
            raise NativeParseError(f"malformed PAF at line {rc}", rc)
        n, t_ops, nb = n_rec.value, n_ops.value, name_bytes.value
    ints = np.empty((n, 13), dtype=np.int64)
    flags = np.empty(n, dtype=np.uint8)
    rtype = np.empty(n, dtype=np.uint8)
    qoff = np.empty(n, dtype=np.int64)
    toff = np.empty(n, dtype=np.int64)
    pool = np.empty(max(nb, 1), dtype=np.uint8)
    ops = np.empty(t_ops, dtype=np.uint8)
    lens = np.empty(t_ops, dtype=np.int64)
    off = np.empty(n + 1, dtype=np.int64)
    if nt > 1:
        def base(c):
            b = np.zeros(nt, dtype=np.int64)
            np.cumsum(c[:-1], out=b[1:])
            return b
        rc = lib.paf_fill_mt(data, len(data), nt, _p_i64(bounds),
                             _p_i64(base(s_rec)), _p_i64(base(s_ops)),
                             _p_i64(base(s_names)), _p_i64(s_lines),
                             _p_i64(ints), _p_u8(flags), _p_u8(rtype),
                             _p_i64(qoff), _p_i64(toff),
                             pool.ctypes.data_as(_CP),
                             _p_u8(ops), _p_i64(lens), _p_i64(off))
    else:
        rc = lib.paf_fill(data, len(data), _p_i64(ints), _p_u8(flags),
                          _p_u8(rtype), _p_i64(qoff), _p_i64(toff),
                          pool.ctypes.data_as(_CP),
                          _p_u8(ops), _p_i64(lens), _p_i64(off))
    if rc != 0:
        raise NativeParseError(f"malformed PAF at line {rc}", rc)
    qnames, tnames = _names(pool.tobytes(), qoff, toff, n)
    return ints, flags, rtype, qnames, tnames, ops, lens, off


def parse_paf_bytes_raw(data: bytes, validate_cigars: bool = False):
    """Parse PAF text without parsing cigars (the reference's
    read_pafs(parse_cigar=0)): each cg tag stays a byte range of ``data``.

    ``validate_cigars`` applies the full parser's cigar acceptance rule and
    returns "noncanon" when a cigar length has a leading zero (valid input
    the full parser would canonicalize, so the caller parses fully).

    Returns (ints[n,13], flags[n], type[n], qnames, tnames, cg_start[n],
    cg_len[n]) or "noncanon".
    """
    lib = get_lib()
    T = _default_threads(None) if len(data) >= _PARSE_MT_BYTES else 1
    bounds = np.zeros(T + 1, dtype=np.int64)
    recs, names_c, lines = (np.zeros(T, dtype=np.int64) for _ in range(3))
    rc = lib.paf_scan_raw_mt(data, len(data), T, _p_i64(bounds),
                             _p_i64(recs), _p_i64(names_c), _p_i64(lines))
    if rc != 0:
        raise NativeParseError(f"malformed PAF at line {rc}", rc)
    rec_base = np.zeros(T, dtype=np.int64)
    name_base = np.zeros(T, dtype=np.int64)
    np.cumsum(recs[:-1], out=rec_base[1:])
    np.cumsum(names_c[:-1], out=name_base[1:])
    n, nb = int(recs.sum()), int(names_c.sum())
    ints = np.empty((n, 13), dtype=np.int64)
    flags = np.empty(n, dtype=np.uint8)
    rtype = np.empty(n, dtype=np.uint8)
    qoff = np.empty(n, dtype=np.int64)
    toff = np.empty(n, dtype=np.int64)
    pool = np.empty(max(nb, 1), dtype=np.uint8)
    cg_start = np.empty(n, dtype=np.int64)
    cg_len = np.empty(n, dtype=np.int64)
    noncanon = np.zeros(1, dtype=np.int64)
    rc = lib.paf_fill_raw_mt(data, len(data), T, _p_i64(bounds),
                             _p_i64(rec_base), _p_i64(name_base),
                             _p_i64(lines), _p_i64(ints), _p_u8(flags),
                             _p_u8(rtype), _p_i64(qoff), _p_i64(toff),
                             pool.ctypes.data_as(_CP),
                             _p_i64(cg_start), _p_i64(cg_len),
                             1 if validate_cigars else 0, _p_i64(noncanon))
    if rc != 0:
        raise NativeParseError(f"malformed PAF at line {rc}", rc)
    if validate_cigars and noncanon[0]:
        return "noncanon"
    qnames, tnames = _names(pool.tobytes(), qoff, toff, n)
    return ints, flags, rtype, qnames, tnames, cg_start, cg_len


def first_seen_ids(*cols):
    """The rows of the equal-length name columns ``cols`` numbered in order
    of first appearance: (ids, keys, n_runs), ids[i] the int64 id of row
    i, keys the distinct rows in id order (tuples, or names for one
    column) and n_runs the number of runs of equal rows.  Each row is
    compared with the one before it and only run heads are hashed, so
    names that come in runs cost one compare a row.  The one place where
    the port turns record names into ids."""
    cols = [np.asarray(c, dtype=object) for c in cols]
    n = len(cols[0])
    head = np.zeros(n, dtype=bool)
    head[:1] = True
    for c in cols:
        head[1:] |= c[1:] != c[:-1]
    heads = np.flatnonzero(head)
    at = [c[heads].tolist() for c in cols]
    index: dict = {}
    run_ids = np.fromiter(
        (index.setdefault(k, len(index))
         for k in (at[0] if len(cols) == 1 else zip(*at))),
        dtype=np.int64, count=len(heads))
    return (np.repeat(run_ids, np.diff(heads, append=n)), list(index),
            len(heads))


def first_rows(ids: np.ndarray) -> np.ndarray:
    """The row at which each id of ``first_seen_ids`` first appears."""
    return np.flatnonzero(np.diff(np.maximum.accumulate(ids), prepend=-1))


def id_groups(ids: np.ndarray, n_ids: int):
    """(perm, goff): the rows grouped by id, group g at
    perm[goff[g]:goff[g+1]], each ascending."""
    perm = np.argsort(ids, kind="stable")
    goff = np.zeros(n_ids + 1, dtype=np.int64)
    np.cumsum(np.bincount(ids, minlength=n_ids), out=goff[1:])
    return perm, goff


def _name_pool(qnames, tnames):
    """NUL-separated name pool and per-record offsets for the formatters:
    each side's distinct names encoded once, the query side's first."""
    parts, offs, pos = [], [], 0
    for names in (qnames, tnames):
        ids, keys, _ = first_seen_ids(names)
        enc = [k.encode("latin-1") for k in keys]
        size = np.fromiter(map(len, enc), dtype=np.int64, count=len(enc)) + 1
        offs.append((pos + np.cumsum(size) - size)[ids])
        parts += enc
        pos += int(size.sum())
    return b"\0".join(parts) + b"\0", offs[0], offs[1]


def pack_ints13(cols, n_threads: int | None = None):
    """Interleave 13 equal-length int64 columns into a row-major [n,13]
    matrix."""
    lib = get_lib()
    cols = [_i64(c) for c in cols]
    out = np.empty((len(cols[0]), 13), dtype=np.int64)
    ptrs = (_I64P * 13)(*[c.ctypes.data_as(_I64P) for c in cols])
    lib.pack_ints13(len(cols[0]), ctypes.cast(ptrs, ctypes.POINTER(_I64P)),
                    _p_i64(out), _default_threads(n_threads))
    return out


def cigar_stats(n_records: int, ops, lens, off) -> np.ndarray:
    """Per-record stats [n,7] in one C pass (columns: matches, mismatches,
    query_inserts, query_deletes, query_insert_bases, query_delete_bases,
    M-only bases)."""
    lib = get_lib()
    out = np.empty((n_records, 7), dtype=np.int64)
    lib.cigar_stats(n_records, _p_u8(_u8(ops)), _p_i64(_i64(lens)),
                    _p_i64(_i64(off)), _p_i64(out))
    return out


def cigar_stats_raw(t) -> np.ndarray:
    """``cigar_stats`` tokenized straight from a raw-cigar table's cg
    text."""
    lib = get_lib()
    raw_buf, cg_start, cg_len = t.raw_cg
    out = np.empty((len(cg_start), 7), dtype=np.int64)
    lib.cigar_stats_raw(len(cg_start), raw_buf, _p_i64(_i64(cg_start)),
                        _p_i64(_i64(cg_len)), _p_i64(out),
                        _default_threads(None))
    return out


def paf_check_batch(t):
    """(first_bad_record, code) of the paf_check sweep (-1, -1 when every
    record passes).  Codes index core/pafio's message table; raw-cigar tables skip
    the cigar-span checks, as the reference does for unparsed cigars."""
    lib = get_lib()
    has_cigar = t.has_cigar
    if t.raw_cg is not None:
        has_cigar = np.zeros(len(t.qstart), dtype=bool)
    code = np.zeros(1, dtype=np.int64)
    bad = lib.paf_check_batch(
        len(t.qstart), _p_i64(_i64(t.off)), _p_u8(_u8(t.ops)),
        _p_i64(_i64(t.lens)), _p_i64(_i64(t.qstart)), _p_i64(_i64(t.qend)),
        _p_i64(_i64(t.qlen)), _p_i64(_i64(t.tstart)), _p_i64(_i64(t.tend)),
        _p_i64(_i64(t.tlen)), _p_u8(_u8(has_cigar)), _p_i64(code))
    return int(bad), int(code[0])


def copy_op_ranges(keep_a, keep_b, new_off, ops, lens,
                   n_threads: int | None = None):
    """Compact per-record op ranges [keep_a, keep_b) into a fresh CSR
    (``new_off`` already cumsummed); (new_ops, new_lens)."""
    lib = get_lib()
    total = int(new_off[-1]) if len(new_off) else 0
    new_ops = np.empty(total, dtype=np.uint8)
    new_lens = np.empty(total, dtype=np.int64)
    lib.copy_op_ranges(len(keep_a), _p_i64(_i64(keep_a)),
                       _p_i64(_i64(keep_b)), _p_i64(_i64(new_off)),
                       _p_u8(_u8(ops)), _p_i64(_i64(lens)), _p_u8(new_ops),
                       _p_i64(new_lens), _default_threads(n_threads))
    return new_ops, new_lens


def build_mop_batch(n_records: int, ops, lens, off, strand, qstart, qend,
                    tstart, qpool_off, tpool_off, n_mops: int,
                    outs: dict) -> int:
    """Fill the MColumnBatch arrays (ops/segments.build_m_column_batch) in
    ``outs`` (preallocated mlens/recs/qpos0/tpos0/rev/col_off/rec_col_off/
    flat_idx); returns n_cols."""
    lib = get_lib()
    return int(lib.build_mop_batch(
        n_records, _p_u8(_u8(ops)), _p_i64(_i64(lens)), _p_i64(_i64(off)),
        _p_u8(_u8(strand)), _p_i64(_i64(qstart)), _p_i64(_i64(qend)),
        _p_i64(_i64(tstart)), _p_i64(_i64(qpool_off)),
        _p_i64(_i64(tpool_off)),
        _p_i64(outs["mlens"]), _p_i64(outs["recs"]), _p_i64(outs["qpos0"]),
        _p_i64(outs["tpos0"]), _p_u8(outs["rev"]), _p_i64(outs["col_off"]),
        _p_i64(outs["rec_col_off"]), _p_i64(outs["flat_idx"])))


def view_stats_lines(qnames, tnames, vals: np.ndarray) -> bytes:
    """The per-record stat lines of ``paffy view``.  ``vals`` is int64
    [n,12]: qstart qend tstart tend strand score matches mismatches
    query_inserts query_deletes query_insert_bases query_delete_bases."""
    lib = get_lib()
    n = len(qnames)
    pool, qoff, toff = _name_pool(qnames, tnames)
    out = np.empty(n * 430 + len(pool), dtype=np.uint8)
    written = lib.view_stats_lines(n, _p_i64(qoff), _p_i64(toff), pool,
                                   _p_i64(_i64(vals)), out.ctypes.data_as(_CP))
    return out[: int(written)].tobytes()


def view_render_batch(t, pool, stat_blob: bytes | None):
    """``view -a`` output: each record's stat line (sliced from
    ``stat_blob``, the view_stats_lines output; None emits renders only)
    followed by its 3-row alignment rendering in 150-column windows
    (paf_pretty_print2, impl/paf.c:282-314), as a uint8 array."""
    lib = get_lib()
    n = len(t)

    def entries(names):
        ids, keys, _ = first_seen_ids(names)
        entry = np.array([pool.index[k] for k in keys],
                         dtype=np.int64).reshape(-1, 2)
        return entry[ids, 0] + pool._guard, entry[ids, 1]
    (qpo, qsl), (tpo, tsl) = entries(t.qname), entries(t.tname)
    if stat_blob is not None:
        nl = np.flatnonzero(np.frombuffer(stat_blob, dtype=np.uint8)
                            == ord("\n"))
        stat_off = np.concatenate([[0], nl + 1]).astype(np.int64)
        stat_len = np.diff(stat_off)
    else:
        stat_off = np.zeros(n + 1, dtype=np.int64)
        stat_len = np.zeros(n, dtype=np.int64)
    off, lens = _i64(t.off), _i64(t.lens)
    cs = np.concatenate([[0], np.cumsum(lens)])
    ncols = cs[off[1:]] - cs[off[:-1]]
    sizes = stat_len + 3 * ncols + 3 * ((ncols + 149) // 150)
    out_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    lib.view_render_batch(
        n, _p_i64(off), _p_u8(_u8(t.ops)), _p_i64(lens),
        _p_i64(_i64(t.qstart)), _p_i64(_i64(t.qend)),
        _p_i64(_i64(t.tstart)), _p_u8(_u8(t.strand)),
        _p_u8(pool.host_pool), _p_i64(qpo), _p_i64(tpo), _p_i64(qsl),
        _p_i64(tsl), stat_blob, _p_i64(stat_off), _p_i64(out_off),
        out.ctypes.data_as(_CP), _default_threads(None))
    return out


def _fasta_scan(lib, data: bytes):
    n_rec, seq_b, name_b = _LL(), _LL(), _LL()
    lib.fasta_scan(data, len(data), ctypes.byref(n_rec), ctypes.byref(seq_b),
                   ctypes.byref(name_b))
    return n_rec.value, seq_b.value, name_b.value


def fasta_headers(data: bytes):
    """[(name, sequence length)] of a FASTA file's records in file order,
    without building a pool."""
    lib = get_lib()
    n, _, nb = _fasta_scan(lib, data)
    name_pool = np.empty(max(nb, 1), dtype=np.uint8)
    name_off = np.empty(max(n, 1), dtype=np.int64)
    seq_len = np.empty(max(n, 1), dtype=np.int64)
    lib.fasta_fill_headers(data, len(data), name_pool.ctypes.data_as(_CP),
                           _p_i64(name_off), _p_i64(seq_len))
    raw = name_pool.tobytes()
    return [(raw[name_off[i]: raw.index(b"\0", name_off[i])].decode("latin-1"),
             int(seq_len[i])) for i in range(n)]


_FASTA_MT_BYTES = 4 << 20   # thread the FASTA pack above 4 MB of input
_FASTA_CHUNK_FIELDS = 7     # int64s a chunk of fasta_pack_scan/_fill


def fasta_pack(bufs, alloc, n_threads: int | None = None):
    """The sequence pool of FASTA files' bytes (``bufs``: bytes-like, or
    (address, length) of memory that stays valid for the call), in file
    order, in one threaded native pass: line-aligned chunks counted in
    threads, the counts prefix-summed over all files, then each chunk's
    trimmed sequence bytes written straight to their final offsets in
    ``alloc(n)``, a writable contiguous uint8 array of the pool's n bytes
    that the caller allocates (and may guard).  Right-stripped headers,
    content before a file's first header skipped (paffy_tpu's read_fasta
    semantics).  The pass runs in ``n_threads`` threads (by default
    ``_default_threads`` above 4 MB of input in all, else 1).

    Returns (the pool ``alloc`` gave, [(name, offset, length)] in file
    order, the threads of the pass)."""
    lib = get_lib()
    spans, keep = [], []        # keep: the views the addresses point into
    for b in bufs:
        if not isinstance(b, tuple):
            keep.append(np.frombuffer(b, dtype=np.uint8))
            b = (keep[-1].ctypes.data, len(keep[-1]))
        spans.append(b)
    lens = np.array([n for _, n in spans] or [0], dtype=np.int64)
    if n_threads is None:
        n_threads = _default_threads(None) if lens.sum() >= _FASTA_MT_BYTES \
            else 1
    nt = max(1, n_threads)
    addrs = (ctypes.c_void_p * max(len(spans), 1))(*[a for a, _ in spans])
    chunks = np.empty((len(spans) + nt) * _FASTA_CHUNK_FIELDS, dtype=np.int64)
    totals = np.empty(3, dtype=np.int64)
    n_chunks = lib.fasta_pack_scan(len(spans), addrs, _p_i64(lens), nt,
                                   _p_i64(chunks), _p_i64(totals))
    sb, n, nb = (int(v) for v in totals)
    pool = alloc(sb)
    if not (isinstance(pool, np.ndarray) and pool.dtype == np.uint8
            and pool.shape == (sb,) and pool.flags.c_contiguous
            and pool.flags.writeable):
        raise ValueError("alloc must give a writable contiguous uint8 "
                         f"array of {sb} bytes")
    name_pool = np.empty(max(nb, 1), dtype=np.uint8)
    name_off, seq_off, seq_len = (np.empty(max(n, 1), dtype=np.int64)
                                  for _ in range(3))
    lib.fasta_pack_fill(addrs, n_chunks, _p_i64(chunks), nt, _p_u8(pool), sb,
                        name_pool.ctypes.data_as(_CP), n, _p_i64(name_off),
                        _p_i64(seq_off), _p_i64(seq_len))
    raw = name_pool.tobytes()
    return pool, [(raw[name_off[i]: raw.index(b"\0", name_off[i])]
                   .decode("latin-1"), int(seq_off[i]), int(seq_len[i]))
                  for i in range(n)], nt


def fasta_pack_files(paths, alloc, n_threads: int | None = None):
    """``fasta_pack`` of FASTA files: each regular, non-empty file mapped
    read-only for the pass, anything else (a FIFO, /dev/stdin as a pipe,
    an empty file) read into bytes."""
    lib = get_lib()
    maps = []
    try:
        bufs = []
        for p in paths:
            if stat.S_ISREG(os.stat(p).st_mode):
                n = _LL()
                addr = lib.fasta_map(os.fsencode(p), ctypes.byref(n))
                if addr:
                    maps.append((addr, n.value))
                    bufs.append(maps[-1])
                    continue
            with open(p, "rb") as fh:
                bufs.append(fh.read())
        return fasta_pack(bufs, alloc, n_threads)
    finally:
        for addr, n in maps:
            lib.fasta_unmap(addr, n)


def fasta_pack_bytes(data: bytes, n_threads: int | None = None):
    """(pool: uint8 array, [(name, offset, length)] in file order) of one
    FASTA file's bytes (``fasta_pack``)."""
    pool, records, _ = fasta_pack(
        [data], lambda n: np.empty(n, dtype=np.uint8), n_threads)
    return pool, records


def column_compare_counts(pool: np.ndarray, lens, qpos0, tpos0, rev, rec,
                          n_records: int):
    """(matches, mismatches) per record from the single-threaded C column
    loop over the M runs given (positions into the guarded host pool)."""
    lib = get_lib()
    m = np.zeros(n_records, dtype=np.int64)
    x = np.zeros(n_records, dtype=np.int64)
    lib.column_compare_counts(
        _p_u8(_u8(pool)), len(lens), _p_i64(_i64(lens)), _p_i64(_i64(qpos0)),
        _p_i64(_i64(tpos0)), _p_u8(_u8(rev)), _p_i64(_i64(rec)), _p_i64(m),
        _p_i64(x))
    return m, x


def synth_query_pool(pool: np.ndarray, lens, qpos0, tpos0, rev,
                     keep_per_mille: int = 965, seed: int = 7) -> None:
    """Write query bytes into ``pool`` in place through the alignment map:
    the (complemented, for reverse runs) target byte, substituted at a
    deterministic per-column rate of (1000 - keep_per_mille) / 1000."""
    lib = get_lib()
    if pool.dtype != np.uint8 or not pool.flags.c_contiguous:
        raise ValueError("pool must be a contiguous uint8 array")
    lib.synth_query_pool(_p_u8(pool), len(lens), _p_i64(_i64(lens)),
                         _p_i64(_i64(qpos0)), _p_i64(_i64(tpos0)),
                         _p_u8(_u8(rev)), keep_per_mille, seed)


def serialize_paf_arrays(ints, flags, rtype, qnames, tnames, ops, lens, off,
                         order=None, raw_cig=None,
                         n_threads: int | None = None) -> np.ndarray:
    """PAF lines of the records given, as a uint8 array, in two threaded
    passes (exact sizes, then fill; tag rules of impl/paf.c:317-389).
    ``order`` (an int64 permutation) emits record order[r] at line r;
    ``raw_cig`` = (buf, cg_start, cg_len) emits each cigar verbatim from
    the input buffer (a raw-cigar table)."""
    lib = get_lib()
    n = len(flags)
    pool, qoff, toff = _name_pool(qnames, tnames)
    ints, flags, rtype, ops = _i64(ints), _u8(flags), _u8(rtype), _u8(ops)
    lens, off = _i64(lens), _i64(off)
    p_order = None
    if order is not None:
        order = _i64(order)
        n = len(order)
        p_order = _p_i64(order)
    raw_buf = p_cg_start = p_cg_len = None
    if raw_cig is not None:
        raw_buf, cg_start, cg_len = raw_cig
        cg_start, cg_len = _i64(cg_start), _i64(cg_len)
        p_cg_start, p_cg_len = _p_i64(cg_start), _p_i64(cg_len)
    nt = _default_threads(n_threads)
    out_off = np.zeros(n + 1, dtype=np.int64)
    lib.paf_serialize_sizes(n, _p_i64(ints), _p_u8(flags), _p_u8(rtype),
                            _p_i64(qoff), _p_i64(toff), pool, _p_u8(ops),
                            _p_i64(lens), _p_i64(off), p_order, p_cg_len,
                            _p_i64(out_off[1:]), nt)
    np.cumsum(out_off[1:], out=out_off[1:])
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    rc = lib.paf_serialize_fill(n, _p_i64(ints), _p_u8(flags), _p_u8(rtype),
                                _p_i64(qoff), _p_i64(toff), pool, _p_u8(ops),
                                _p_i64(lens), _p_i64(off), p_order, raw_buf,
                                p_cg_start, p_cg_len, _p_i64(out_off),
                                out.ctypes.data_as(_CP), nt)
    if rc != 0:
        raise RuntimeError("paf_serialize_fill wrote other sizes than it "
                           "measured")
    return out


def encode_rebuild_offsets(ops, lens, runs_per_mop, total_out):
    """The CSR rebuild of the mismatch encoder, in one walk over the ops:
    (out_off_per_op [n_ops+1], m_out_off [n_mops], new_ops, new_lens), with
    every non-M op already written through at its slot and each M op given
    ``runs_per_mop`` slots starting at its ``m_out_off``."""
    lib = get_lib()
    ops = _u8(ops)
    out_off = np.empty(len(ops) + 1, dtype=np.int64)
    m_out_off = np.empty(len(runs_per_mop), dtype=np.int64)
    new_ops = np.empty(total_out, dtype=np.uint8)
    new_lens = np.empty(total_out, dtype=np.int64)
    lib.encode_rebuild_offsets(len(ops), _p_u8(ops), _p_i64(_i64(lens)),
                               _p_i64(_i64(runs_per_mop)), _p_i64(out_off),
                               _p_i64(m_out_off), _p_u8(new_ops),
                               _p_i64(new_lens), None)
    return out_off, m_out_off, new_ops, new_lens


def encode_rebuild_slots(ops, lens, runs_per_mop):
    """The same rebuild with the non-M ops packed instead of placed:
    (out_off_per_op, m_out_off, slot, keep_ops, keep_lens), where non-M op
    i (in op order) goes to output slot ``slot[i]``.  O(ops): nothing here
    is sized to the output."""
    lib = get_lib()
    ops = _u8(ops)
    n_keep = len(ops) - len(runs_per_mop)
    out_off = np.empty(len(ops) + 1, dtype=np.int64)
    m_out_off = np.empty(len(runs_per_mop), dtype=np.int64)
    slot = np.empty(n_keep, dtype=np.int64)
    keep_ops = np.empty(n_keep, dtype=np.uint8)
    keep_lens = np.empty(n_keep, dtype=np.int64)
    lib.encode_rebuild_offsets(len(ops), _p_u8(ops), _p_i64(_i64(lens)),
                               _p_i64(_i64(runs_per_mop)), _p_i64(out_off),
                               _p_i64(m_out_off), _p_u8(keep_ops),
                               _p_i64(keep_lens), _p_i64(slot))
    return out_off, m_out_off, slot, keep_ops, keep_lens


def match_intervals(off, ops, lens, qstart):
    """(rec, start, end) of every aligned (M/=/X) run's query interval, by
    the reference's forward walk from qstart (impl/paf.c:690-709)."""
    lib = get_lib()
    n_ops = len(ops)
    rec, start, end = (np.empty(n_ops, dtype=np.int64) for _ in range(3))
    n = int(lib.match_intervals(len(off) - 1, _p_i64(_i64(off)),
                                _p_u8(_u8(ops)), _p_i64(_i64(lens)),
                                _p_i64(_i64(qstart)), _p_i64(rec),
                                _p_i64(start), _p_i64(end)))
    return rec[:n], start[:n], end[:n]


def tile_intervals(off, ops, lens, qstart):
    """(run_off, istart, iend, n_runs): each record's aligned query bases
    as CSR intervals, one per maximal stretch of touching aligned runs
    (match_intervals' runs joined, zero-length ones dropped), and the
    aligned runs read, in one C pass.  istart and iend are exact-size views
    of n_ops-sized buffers of which only the pages written are touched."""
    lib = get_lib()
    run_off = np.empty(len(off), dtype=np.int64)
    start, end = (np.empty(max(len(ops), 1), dtype=np.int64)
                  for _ in range(2))
    n_runs = np.zeros(1, dtype=np.int64)
    n = int(lib.tile_intervals(len(off) - 1, _p_i64(_i64(off)),
                               _p_u8(_u8(ops)), _p_i64(_i64(lens)),
                               _p_i64(_i64(qstart)), _p_i64(run_off),
                               _p_i64(start), _p_i64(end), _p_i64(n_runs)))
    return run_off, start[:n], end[:n], int(n_runs[0])


def query_walk_violation(t) -> int:
    """First record that breaks the query-side coverage-walk asserts of
    tile and to_bed (impl/paf.c:691-709), or -1."""
    lib = get_lib()
    return int(lib.query_walk_violation(
        len(t.qstart), _p_i64(_i64(t.off)), _p_u8(_u8(t.ops)),
        _p_i64(_i64(t.lens)), _p_i64(_i64(t.qstart)), _p_i64(_i64(t.qend)),
        _p_i64(_i64(t.qlen))))


def encode_runs_per_mop(pool: np.ndarray, lens, qpos0, tpos0, rev,
                        n_threads: int | None = None) -> np.ndarray:
    """=/X runs of each M op (the C count pass over the guarded host pool);
    a reference for K4's count."""
    lib = get_lib()
    out = np.empty(len(lens), dtype=np.int64)
    lib.encode_runs_per_mop(_p_u8(_u8(pool)), len(lens), _p_i64(_i64(lens)),
                            _p_i64(_i64(qpos0)), _p_i64(_i64(tpos0)),
                            _p_u8(_u8(rev)), _p_i64(out),
                            _default_threads(n_threads))
    return out


def encode_runs_fill_cigar(pool: np.ndarray, lens, qpos0, tpos0, rev,
                           dest_off, new_ops: np.ndarray,
                           new_lens: np.ndarray,
                           n_threads: int | None = None) -> None:
    """Write each M op's =/X runs (op code, length) into ``new_ops`` /
    ``new_lens`` from ``dest_off[j]`` on (the C fill pass); a reference for
    K4's fill."""
    lib = get_lib()
    if (new_ops.dtype != np.uint8 or new_lens.dtype != np.int64
            or not new_ops.flags.c_contiguous
            or not new_lens.flags.c_contiguous):
        raise ValueError("new_ops must be contiguous uint8, new_lens int64")
    lib.encode_runs_fill_cigar(_p_u8(_u8(pool)), len(lens),
                               _p_i64(_i64(lens)), _p_i64(_i64(qpos0)),
                               _p_i64(_i64(tpos0)), _p_u8(_u8(rev)),
                               _p_i64(_i64(dest_off)), _p_u8(new_ops),
                               _p_i64(new_lens), _default_threads(n_threads))


def encode_serialize(t, pool: np.ndarray, qpool_off, tpool_off,
                     n_threads: int | None = None) -> np.ndarray:
    """paffy_tpu's fused add_mismatches output (M runs encoded to =/X runs
    and serialized in one C pass pair) as a uint8 array: the reference the
    port's encode-then-serialize is held to."""
    from paffy_tpu_torch.core.pafio import _table_to_arrays
    lib = get_lib()
    ints, flags = _table_to_arrays(t)
    name_pool, qoff, toff = _name_pool(t.qname, t.tname)
    n = len(flags)
    args = (n, _p_i64(ints), _p_u8(flags), _p_u8(_u8(t.type)), _p_i64(qoff),
            _p_i64(toff), name_pool, _p_u8(_u8(t.ops)), _p_i64(_i64(t.lens)),
            _p_i64(_i64(t.off)), _p_u8(_u8(pool)), _p_i64(_i64(qpool_off)),
            _p_i64(_i64(tpool_off)))
    nt = _default_threads(n_threads)
    out_off = np.zeros(n + 1, dtype=np.int64)
    lib.encode_serialize_sizes(*args, _p_i64(out_off[1:]), nt)
    np.cumsum(out_off[1:], out=out_off[1:])
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    if lib.encode_serialize_fill(*args, _p_i64(out_off),
                                 out.ctypes.data_as(_CP), nt) != 0:
        raise RuntimeError("encode_serialize_fill wrote other sizes than it "
                           "measured")
    return out


def tile_sweep(order, arena_off, run_off, istart, iend, arena: np.ndarray,
               saturation: int, levels: np.ndarray) -> None:
    """The greedy tile sweep in C (impl/paf_tile.c:36-93): records in
    ``order``, each adding its intervals [istart, iend) (CSR by
    ``run_off``) into its sequence's counts at ``arena_off`` of the uint16
    ``arena``, saturating at ``saturation``; the level of a covered record
    is the ((n+1)//2)-th smallest new count over its n bases.  Mutates
    ``arena`` and ``levels`` (only covered records are written); a
    reference for K5."""
    lib = get_lib()
    if (arena.dtype != np.uint16 or not arena.flags.c_contiguous
            or levels.dtype != np.int64 or not levels.flags.c_contiguous):
        raise ValueError("arena must be contiguous uint16, levels int64")
    lib.tile_sweep(len(order), _p_i64(_i64(order)), _p_i64(_i64(arena_off)),
                   _p_i64(_i64(run_off)), _p_i64(_i64(istart)),
                   _p_i64(_i64(iend)), arena.ctypes.data_as(_U16P),
                   saturation, _p_i64(levels))


def chain_dp(qs, qe, ts, te, score, qe_order, lo, hi, gap_open: int,
             gap_extend: int, max_gap: int):
    """(chain score, predecessor) of each record of one chain group in
    processing order, by the windowed DP in C (impl/chaining.c:150-214;
    ``qe_order``, ``lo``, ``hi`` from ops/chain._window_bounds); a
    reference for K6."""
    lib = get_lib()
    n = len(qs)
    cs = np.empty(n, dtype=np.int64)
    pred = np.empty(n, dtype=np.int64)
    lib.chain_dp(n, *(_p_i64(_i64(a)) for a in (qs, qe, ts, te, score,
                                                qe_order, lo, hi)),
                 gap_open, gap_extend, max_gap, _p_i64(cs), _p_i64(pred))
    return cs, pred


def chain_extract(cs, pred, qs, qe, ts, te, score, gap_open: int,
                  gap_extend: int, first_id: int):
    """The greedy extraction of one strand set's chains from its DP's
    ``cs`` and ``pred`` (processing positions, -1 for none), every array
    in processing order (impl/chaining.c:88-113, 216-233): (members, ids,
    scores, next_id), each chain's members head first as processing
    positions, chain ids from ``first_id`` in extraction order, and each
    chain's total along its surviving links.  One C pass, the GIL
    released."""
    lib = get_lib()
    n = len(cs)
    members, ids, scores = (np.empty(n, dtype=np.int64) for _ in range(3))
    nxt = lib.chain_extract(n, *(_p_i64(_i64(a)) for a in (cs, pred, qs, qe,
                                                           ts, te, score)),
                            gap_open, gap_extend, first_id, _p_i64(members),
                            _p_i64(ids), _p_i64(scores))
    return members, ids, scores, int(nxt)


def _trim_outputs(n):
    return tuple(np.empty(n, dtype=np.int64) for _ in range(6))


def trim_tails_apply(off, ops, lens, strand, score_fraction, max_fraction,
                     n_threads: int | None = None):
    """Both passes of the unreliable-tail trim (identity, decision and
    apply; impl/paf.c:811-953) over a parsed CSR store, threaded:
    (keep_a, keep_b, dq1, dt1, dq2, dt2), the kept op range of each record
    and the query/target bases each pass dropped."""
    lib = get_lib()
    n = len(off) - 1
    out = _trim_outputs(n)
    lib.trim_tails_apply(n, _p_i64(_i64(off)), _p_u8(_u8(ops)),
                         _p_i64(_i64(lens)), _p_u8(_u8(strand)),
                         score_fraction, max_fraction,
                         *(_p_i64(a) for a in out),
                         _default_threads(n_threads))
    return out


def trim_tails_raw(t, score_fraction, max_fraction,
                   n_threads: int | None = None):
    """``trim_tails_apply`` over a raw-cigar table, tokenizing its cg text:
    (cg_a, cg_n, dq1, dt1, dq2, dt2), each record's kept cigar as a byte
    range of the input buffer and the bases each pass dropped."""
    lib = get_lib()
    raw_buf, cg_start, cg_len = t.raw_cg
    out = _trim_outputs(len(cg_start))
    lib.trim_tails_raw(len(cg_start), raw_buf, _p_i64(_i64(cg_start)),
                       _p_i64(_i64(cg_len)), _p_u8(_u8(t.strand)),
                       score_fraction, max_fraction,
                       *(_p_i64(a) for a in out),
                       _default_threads(n_threads))
    return out


def shatter_violation(t):
    """(kind, record) of the first record the reference's shatter walk dies
    on, or (None, -1): kind "abort" for an assert (an op of length < 1, an
    =/X op, a walk that misses the end coordinates), "check" for the
    paf_check of an M shard (impl/paf.c:600-663)."""
    lib = get_lib()
    kind = np.zeros(1, dtype=np.int64)
    r = int(lib.shatter_violation(
        len(t.qstart), _p_i64(_i64(t.off)), _p_u8(_u8(t.ops)),
        _p_i64(_i64(t.lens)), _p_u8(_u8(t.strand)), _p_i64(_i64(t.qstart)),
        _p_i64(_i64(t.qend)), _p_i64(_i64(t.qlen)), _p_i64(_i64(t.tstart)),
        _p_i64(_i64(t.tend)), _p_i64(_i64(t.tlen)), _p_i64(kind)))
    if r < 0:
        return None, -1
    return ("abort" if kind[0] == 1 else "check"), r


def shatter_walk(off, ops, lens, qstart, qend, tstart, strand, m_base, k,
                 n_threads: int | None = None):
    """(rec, qs, ts, ln) of every M op, k of them, by the shatter walk
    (impl/paf.c:600-663); ``m_base`` is each record's exclusive count of M
    ops before it."""
    lib = get_lib()
    rec, qs, ts, ln = (np.empty(k, dtype=np.int64) for _ in range(4))
    lib.shatter_walk(len(off) - 1, _p_i64(_i64(off)), _p_u8(_u8(ops)),
                     _p_i64(_i64(lens)), _p_i64(_i64(qstart)),
                     _p_i64(_i64(qend)), _p_i64(_i64(tstart)),
                     _p_u8(_u8(strand)), _p_i64(_i64(m_base)), _p_i64(rec),
                     _p_i64(qs), _p_i64(ts), _p_i64(ln),
                     _default_threads(n_threads))
    return rec, qs, ts, ln


def invert_ops(off, ops, lens, rev, n_threads: int | None = None):
    """The cigar half of paf_invert: I and D swapped, and the ops of each
    record with ``rev`` set reversed; (new_ops, new_lens)."""
    lib = get_lib()
    new_ops = np.empty(len(ops), dtype=np.uint8)
    new_lens = np.empty(len(ops), dtype=np.int64)
    lib.invert_ops(len(off) - 1, _p_i64(_i64(off)), _p_u8(_u8(ops)),
                   _p_i64(_i64(lens)), _p_u8(_u8(rev)), _p_u8(new_ops),
                   _p_i64(new_lens), _default_threads(n_threads))
    return new_ops, new_lens


def coverage_add(diff: np.ndarray, starts, ends) -> None:
    """diff[start] += 1 and diff[end] -= 1 for each interval, in place on
    an int32 difference array."""
    if diff.dtype != np.int32 or not diff.flags.c_contiguous:
        raise ValueError("diff must be a contiguous int32 array")
    starts, ends = _i64(starts), _i64(ends)
    get_lib().coverage_add(diff.ctypes.data_as(_I32P), _p_i64(starts),
                           _p_i64(ends), len(starts))


def coverage_counts(diff: np.ndarray, saturation: int) -> np.ndarray:
    """The running sum of a coverage difference array, saturated at
    ``saturation``, as uint16 (np.minimum(np.cumsum(diff), saturation)
    .astype(np.uint16)); int32 differences take the 32-bit pass."""
    lib = get_lib()
    out = np.empty(len(diff), dtype=np.uint16)
    if diff.dtype == np.int32:
        d = np.ascontiguousarray(diff)
        lib.coverage_counts32(d.ctypes.data_as(_I32P), len(d), saturation,
                              out.ctypes.data_as(_U16P))
    else:
        lib.coverage_counts(_p_i64(_i64(diff)), len(diff), saturation,
                            out.ctypes.data_as(_U16P))
    return out


def rle_u16(counts: np.ndarray, binary: bool):
    """(starts, ends, vals) of the maximal runs of equal counts of a uint16
    array (write_bed, impl/paf_to_bed.c:33-55); ``binary`` splits on the
    count > 0 indicator instead."""
    if counts.dtype != np.uint16:
        raise ValueError("counts must be uint16")
    lib = get_lib()
    counts = np.ascontiguousarray(counts)
    p = counts.ctypes.data_as(_U16P)
    k = int(lib.rle_u16_count(p, len(counts), int(binary)))
    starts, ends, vals = (np.empty(k, dtype=np.int64) for _ in range(3))
    if len(counts):
        lib.rle_u16_fill(p, len(counts), int(binary), _p_i64(starts),
                         _p_i64(ends), _p_i64(vals))
    return starts, ends, vals


_STREAM_CHUNK = 32 << 20   # the reused fill buffer of a streamed serialize


def _stream_two_phase(out_off, fh, fill_range, n):
    """Write a two-pass serialization to ``fh`` in slices of about 32 MB
    through one reused buffer: ``fill_range(r0, r1, rebased_out_off, buf)``
    writes records [r0, r1) at offset 0 of ``buf``.  When a fill fails at
    a record, the bytes of the records before it (``partial_bytes`` on the
    error) are written first: the reference writes record by record."""
    buf = np.empty(min(int(out_off[-1]), _STREAM_CHUNK) + 1, dtype=np.uint8)
    r0 = 0
    while r0 < n:
        r1 = int(np.searchsorted(out_off, out_off[r0] + _STREAM_CHUNK,
                                 side="right")) - 1
        r1 = max(r1, r0 + 1)
        size = int(out_off[r1] - out_off[r0])
        if size > len(buf):       # one record larger than the slice
            buf = np.empty(size, dtype=np.uint8)
        rebased = np.ascontiguousarray(out_off[r0: r1 + 1] - out_off[r0])
        try:
            fill_range(r0, r1, rebased, buf)
        except ValueError as e:
            part = getattr(e, "partial_bytes", None)
            if part:
                fh.write(memoryview(buf.data)[:int(part)])
            raise
        fh.write(memoryview(buf.data)[:size])
        r0 = r1


def _serialize_out(out_off, fill, n, fh):
    """Run ``fill`` over all n records: streamed into ``fh`` (then True),
    or into one array that is returned."""
    if fh is not None:
        _stream_two_phase(out_off, fh, fill, n)
        return True
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    fill(0, n, out_off, out)
    return out


def invert_serialize(t, n_threads: int | None = None, fh=None):
    """``paffy invert``'s output of a raw-cigar table: each record with
    query and target swapped (paf_invert, impl/paf.c:463-490) and its cg
    text rewritten token by token (I and D swapped, the tokens of a '-'
    record reversed), never parsed into ops.  The cigar spans are checked
    as it goes (the reference's paf_check after the invert); the bounds
    are the caller's.  Returns the bytes as a uint8 array, or True after
    streaming them into ``fh``.  A span that differs from the record's
    lengths raises PafCheckError, after ``fh`` got the records before
    it."""
    from paffy_tpu_torch.core.pafio import PafCheckError, _table_to_arrays
    if t.raw_cg is None:
        raise ValueError("invert_serialize needs a raw-cigar table")
    lib = get_lib()
    raw_buf, cg_start, cg_len = t.raw_cg
    ints, flags = _table_to_arrays(t)
    # query and target columns swapped: [tlen ts te qlen qs qe ...]
    ints = np.ascontiguousarray(
        ints[:, [3, 4, 5, 0, 1, 2, 6, 7, 8, 9, 10, 11, 12]])
    name_pool, qoff, toff = _name_pool(t.qname, t.tname)
    n = len(flags)
    rtype = _u8(t.type)
    cg_start, cg_len = _i64(cg_start), _i64(cg_len)
    nt = _default_threads(n_threads)
    # the rewrite keeps each cigar's byte length: the raw serializer's
    # size pass, names swapped, gives the sizes
    out_off = np.zeros(n + 1, dtype=np.int64)
    lib.paf_serialize_sizes(n, _p_i64(ints), _p_u8(flags), _p_u8(rtype),
                            _p_i64(toff), _p_i64(qoff), name_pool, None,
                            None, None, None, _p_i64(cg_len),
                            _p_i64(out_off[1:]), nt)
    np.cumsum(out_off[1:], out=out_off[1:])

    def fill(r0, r1, oo, buf):
        rc = lib.invert_serialize_fill(
            r1 - r0, _p_i64(ints[r0:]), _p_u8(flags[r0:]), _p_u8(rtype[r0:]),
            _p_i64(toff[r0:]), _p_i64(qoff[r0:]), name_pool, raw_buf,
            _p_i64(cg_start[r0:]), _p_i64(cg_len[r0:]), _p_i64(oo),
            buf.ctypes.data_as(_CP), nt)
        if rc == -2:
            raise RuntimeError("invert_serialize_fill wrote other sizes than "
                               "it measured, or met a malformed cigar")
        if rc >= 0:
            e = PafCheckError(
                "Paf cigar alignment does not match query/target length "
                f"(record {r0 + rc})")
            e.partial_bytes = int(oo[rc])   # the records before it
            raise e
    return _serialize_out(out_off, fill, n, fh)


def shatter_serialize(t, n_threads: int | None = None, fh=None):
    """``paffy shatter``'s output: each record's cigar walked
    (paf_shatter, impl/paf.c:600-663) and every M op written as its own
    gapless single-op line, with no table of shards in between.  Returns
    the bytes as a uint8 array, or True after streaming them into ``fh``.
    The caller rejects what the reference's walk dies on first
    (``shatter_violation``)."""
    from paffy_tpu_torch.core.pafio import _table_to_arrays
    lib = get_lib()
    ints, flags = _table_to_arrays(t)
    name_pool, qoff, toff = _name_pool(t.qname, t.tname)
    n = len(flags)
    rtype, ops = _u8(t.type), _u8(t.ops)
    lens, off = _i64(t.lens), _i64(t.off)
    nt = _default_threads(n_threads)
    out_off = np.zeros(n + 1, dtype=np.int64)
    lib.shatter_serialize_sizes(n, _p_i64(ints), _p_u8(flags), _p_u8(rtype),
                                _p_i64(qoff), _p_i64(toff), name_pool,
                                _p_u8(ops), _p_i64(lens), _p_i64(off),
                                _p_i64(out_off[1:]), nt)
    np.cumsum(out_off[1:], out=out_off[1:])

    def fill(r0, r1, oo, buf):
        if lib.shatter_serialize_fill(
                r1 - r0, _p_i64(ints[r0:]), _p_u8(flags[r0:]),
                _p_u8(rtype[r0:]), _p_i64(qoff[r0:]), _p_i64(toff[r0:]),
                name_pool, _p_u8(ops), _p_i64(lens), _p_i64(off[r0:]),
                _p_i64(oo), buf.ctypes.data_as(_CP), nt) != 0:
            raise RuntimeError("shatter_serialize_fill wrote other sizes "
                               "than it measured")
    return _serialize_out(out_off, fill, n, fh)
