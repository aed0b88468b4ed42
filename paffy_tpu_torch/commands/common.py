"""Command plumbing of the port's commands (counterpart of
paffy_tpu/commands/common.py: the argument parser, the stdio-granularity
output writer, the streaming PAF reader, whole-table read and write, and
the streaming read -> transform -> write loop).

Flags and defaults are the reference's: -i/-o default to stdin/stdout
(commands that name their files otherwise build the parser with
``io=False``), -l sets the log level.  Output goes through
``GlibcWriter``, which reproduces the reference's glibc stdio blocks, so
the bytes that reach a file before a failure are the reference's too.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from paffy_tpu_torch import phases
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.utils.logging import (CommandTimer, log_info,
                                           set_log_level_from_string)


def base_parser(prog: str, description: str,
                io: bool = True) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=description, add_help=True)
    if io:
        p.add_argument("-i", "--inputFile", default=None,
                       help="Input paf file. If not specified reads from stdin")
        p.add_argument("-o", "--outputFile", default=None,
                       help="Output file. If not specified outputs to stdout")
    p.add_argument("-l", "--logLevel", default=None, help="Set the log level")
    return p


def start(args, name: str) -> CommandTimer:
    set_log_level_from_string(getattr(args, "logLevel", None))
    log_info("Input file string : %s", getattr(args, "inputFile", None))
    log_info("Output file string : %s", getattr(args, "outputFile", None))
    return CommandTimer(name)


def open_input(args):
    """The command's input as text (-i file or stdin)."""
    return sys.stdin if args.inputFile is None else open(args.inputFile, "r")


class _TextGlibcFacade:
    """str interface over a GlibcWriter, for text output."""

    def __init__(self, w):
        self._w = w

    def write(self, s: str) -> int:
        return self._w.write(s.encode("latin-1"))

    def write_bytes(self, data) -> int:
        """Bytes or memoryview passthrough for bulk payloads."""
        return self._w.write(data)

    def close(self) -> None:
        self._w.close()


def open_output(args):
    if args.outputFile is not None:
        return _TextGlibcFacade(GlibcWriter(open(args.outputFile, "wb"),
                                            owns=True))
    buf = getattr(sys.stdout, "buffer", None)
    raw = buf if buf is not None else _TextWriteCompat(sys.stdout)
    return _TextGlibcFacade(GlibcWriter(raw, owns=False))


def open_output_binary(args) -> "GlibcWriter":
    """The command's output as a bytes writer (-o file or stdout)."""
    if args.outputFile is not None:
        return GlibcWriter(open(args.outputFile, "wb"), owns=True)
    buf = getattr(sys.stdout, "buffer", None)
    raw = buf if buf is not None else _TextWriteCompat(sys.stdout)
    return GlibcWriter(raw, owns=False)


def close_output_binary(fh) -> None:
    fh.close()


class _TextReadCompat:
    """Bytes facade over a text stream (tests redirect stdin to StringIO)."""

    def __init__(self, fh):
        self._fh = fh

    def read(self, n=-1):
        return self._fh.read(n).encode("latin-1")


class _TextWriteCompat:
    """Bytes facade over a text stream (tests redirect stdout to StringIO)."""

    def __init__(self, fh):
        self._fh = fh

    def write(self, data):
        return self._fh.write(bytes(data).decode("latin-1"))

    def flush(self):
        self._fh.flush()


def open_input_binary(args):
    """Binary input stream: PAF data never needs a codec pass."""
    if args.inputFile is not None:
        return open(args.inputFile, "rb")
    buf = getattr(sys.stdin, "buffer", None)
    return buf if buf is not None else _TextReadCompat(sys.stdin)


def close_input_binary(fh):
    if isinstance(fh, _TextReadCompat) or fh is getattr(sys.stdin, "buffer",
                                                        None):
        return
    fh.close()


class GlibcWriter:
    """Stdio-granularity staging writer for command output streams.

    The reference writes record by record through glibc stdio, which
    flushes in full 4096-byte blocks: an st_errAbort exit() flushes the
    partial tail, an assert or SIGSEGV loses it (impl/paf.c:155-157).  Full
    blocks pass through at once; the sub-block tail is held until ``close``
    on a clean finish, or until the CLI layer ends the writer after an
    exception: flushed for errAbort-class errors, discarded for
    assert-class ones (``stdio_lost_tail`` on the exception).
    """

    BLOCK = 4096

    def __init__(self, fh, owns: bool):
        self._fh = fh
        self._owns = owns
        self._tail = b""
        _ACTIVE_WRITERS.append(self)

    def write(self, data) -> int:
        b = data if isinstance(data, (bytes, bytearray, memoryview)) \
            else memoryview(data)
        total = len(self._tail) + len(b)
        if total < self.BLOCK:
            self._tail += bytes(b)
            return len(b)
        # pass the completed blocks through; at most one sub-block copy
        self._fh.write(self._tail)
        cut = len(b) - total % self.BLOCK
        mv = memoryview(b)
        self._fh.write(mv[:cut])
        self._tail = bytes(mv[cut:])
        return len(b)

    def _end(self, flush_tail: bool) -> None:
        if self in _ACTIVE_WRITERS:
            _ACTIVE_WRITERS.remove(self)
        if flush_tail and self._tail:
            self._fh.write(self._tail)
        self._tail = b""
        if self._owns:
            self._fh.close()
        else:
            try:
                self._fh.flush()
            except (ValueError, OSError):
                pass

    def close(self) -> None:
        # inside a ``finally`` with an exception in flight the tail's fate
        # depends on the error class: the CLI layer decides (end_writers)
        if sys.exc_info()[0] is None:
            self._end(flush_tail=True)


class _SigAbort:
    """Error marker: die like an assert (stdio tails lost)."""
    stdio_lost_tail = True


def abort_writers() -> None:
    """End all writers as an assert (SIGABRT) death would: the staged
    sub-block tails are discarded, as the reference loses its stdio buffer
    (the view -u/-v asserts, impl/paf_view.c:196-197, fire after the
    aggregate line is printed but before stdio flushes it)."""
    end_writers(error=_SigAbort())


def end_writers(error=None) -> None:
    """End all active writers.  With ``error`` the tail is flushed or
    discarded by the exception's stdio class; without, it is flushed."""
    lost = bool(getattr(error, "stdio_lost_tail", False))
    for w in list(_ACTIVE_WRITERS):
        w._end(flush_tail=not lost)


_ACTIVE_WRITERS: list = []

# Streaming batch size: the reference streams record by record, the port
# batch by batch (device work wants batches); memory stays bounded by the
# batch's bytes whatever the input size.
BATCH_BYTES = int(os.environ.get("PAFFY_TPU_BATCH_BYTES", 256 * 1024 * 1024))


def _segv_class(data: bytes, off: int) -> bool:
    """True when the line at byte ``off`` would crash the reference's
    strtok walk (a blank or sub-12-token line: SIGSEGV; a line of >= 12
    tokens fails semantically: st_errAbort)."""
    line_end = data.find(b"\n", off)
    line = data[off: line_end if line_end >= 0 else len(data)]
    return sum(1 for f in line.split(b"\t") if f) < 12


def stream_tables(args, batch_bytes: int | None = None,
                  parse_cigars: bool = True, validate_cigars: bool = False):
    """Yield PafTable batches of the input, cut at line boundaries.

    On a malformed line, the records before it are yielded first (the
    reference writes them before it dies), then the error is raised with
    ``stdio_lost_tail`` set by the death the reference would suffer.
    ``parse_cigars``/``validate_cigars`` are those of
    ``pafio.parse_paf_data``.
    """
    bb = batch_bytes or BATCH_BYTES
    fh = open_input_binary(args)

    def parse(data):
        try:
            return pafio.parse_paf_data(data, parse_cigars=parse_cigars,
                                        validate_cigars=validate_cigars), None
        except pafio.PafFormatError as e:
            if not e.line_no or e.line_no <= 1:
                e.stdio_lost_tail = _segv_class(data, 0)
                raise
            off = 0
            for _ in range(e.line_no - 1):
                off = data.index(b"\n", off) + 1
            e.stdio_lost_tail = _segv_class(data, off)
            # re-parse the clean-looking prefix: the scan and fill passes
            # report different error kinds, so an earlier line may fail a
            # check the reported line's pass never reached; the first bad
            # line in file order (and its death class) wins
            sub_t, sub_err = parse(data[:off])
            return sub_t, (sub_err if sub_err is not None else e)
    try:
        leftover = b""
        while True:
            chunk = fh.read(bb)
            if not chunk:
                if leftover:
                    t, err = parse(leftover)
                    yield t
                    if err is not None:
                        raise err
                return
            chunk = leftover + chunk
            cut = chunk.rfind(b"\n")
            if cut < 0:
                leftover = chunk
                continue
            leftover = chunk[cut + 1:]
            t, err = parse(chunk[: cut + 1])
            yield t
            if err is not None:
                raise err
    finally:
        close_input_binary(fh)


def read_table(args, parse_cigars: bool = True):
    """The whole input as one PafTable (raw cigars unless
    ``parse_cigars``)."""
    fh = open_input_binary(args)
    try:
        return pafio.parse_paf_data(fh.read(), parse_cigars=parse_cigars)
    finally:
        close_input_binary(fh)


def write_table(t, args, order=None) -> None:
    """Write ``t`` (in ``order``, if given) as the command's output."""
    fh = open_output_binary(args)
    try:
        fh.write(pafio.serialize_paf_bytes(t, order=order))
    finally:
        close_output_binary(fh)


def write_check_prefix(out, e) -> None:
    """Before a PafCheckError propagates, write the records before the bad
    one: the reference checks and writes record by record, so they reach
    the output before it aborts.  ``e.table`` is the table that was
    checked."""
    if getattr(e, "table", None) is not None and e.record_index:
        out.write(pafio.serialize_paf_bytes(
            e.table.take(np.arange(e.record_index))))


def stream_transform(args, fn, parse_cigars: bool = True,
                     validate_cigars: bool = False) -> None:
    """read -> fn(batch) -> write, batch by batch (the reference's streaming
    loop, e.g. impl/paf_invert.c:84-89, a batch at a time); the flags are
    ``stream_tables``'.  Phases: parse, transform, write."""
    out = open_output_binary(args)
    tables = stream_tables(args, parse_cigars=parse_cigars,
                           validate_cigars=validate_cigars)
    try:
        while True:
            with phases.timed("parse"):
                t = next(tables, None)
            if t is None:
                break
            with phases.timed("transform"):
                try:
                    res = fn(t)
                except pafio.PafCheckError as e:
                    write_check_prefix(out, e)
                    raise
            if len(res):
                with phases.timed("write"):
                    out.write(pafio.serialize_paf_bytes(res))
    finally:
        tables.close()
        close_output_binary(out)
