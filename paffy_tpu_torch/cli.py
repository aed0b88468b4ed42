"""``paffy-torch <cmd>`` and ``faffy-torch <cmd>``: the port's command lines
(counterpart of paffy_tpu/cli.py: ``paffy_main`` :41, ``_run`` :80,
``faffy_main`` :94).

Every command of paffy (13) and faffy (3), with paffy_tpu's usage text and
its "<cmd> is not a valid paffy command" for any other name.  ``view``,
``add_mismatches`` (without ``-a``), ``tile`` and ``chain`` compute on the
device (cuda:0, or the CPU under ``PAFFY_TPU_PLATFORM=cpu``); every other
command is host code, as in paffy_tpu, and never touches the device.
"""

from __future__ import annotations

import sys

_PAFFY_COMMANDS = (
    ("add_mismatches", "Replace Ms with =/Xs in PAF cigar string"),
    ("chain", "Chain together PAF alignments"),
    ("dechunk", "Manipulate coordinates to allow aggregation of PAFs computed over subsequences"),
    ("dedupe", "Remove duplicate alignments from a file based on exact query/target coordinates"),
    ("filter", "Filter alignments based upon alignment stats"),
    ("invert", "Switch query and target coordinates"),
    ("shatter", "Break PAFs into sequence of gapless PAF alignments"),
    ("tile", "Give alignments levels, from lowest (best) to highest (worse)"),
    ("to_bed", "Build an alignment coverage map of a chosen sequence in BED format"),
    ("trim", "Slice of lower identity tail alignments"),
    ("upconvert", "Converts the coordinates of paf alignments to refer to extracted subsequences"),
    ("split_file", "Split PAF file into per-target-contig output files"),
    ("view", "Pretty print and extract stats about PAF alignments"),
)

_FAFFY_COMMANDS = (
    ("chunk", "Break a large fasta file into smaller files for parallel processing"),
    ("merge", "Merge together the chunks created by chunk, potentially resolving overlaps"),
    ("extract", "Extract subsequences of the fasta file"),
)


def _usage(fh, tool: str, what: str, commands, width: int) -> None:
    fh.write(f"{tool}: {what}\n\n")
    fh.write(f"usage: {tool} <command> [options]\n\n")
    fh.write("available commands:\n")
    for cmd, desc in commands:
        fh.write(f"    {cmd:<{width}} {desc}\n")
    fh.write("\n")


def _paffy_usage(fh=None):
    _usage(fh or sys.stderr, "paffy", "toolkit for working with PAF files",
           _PAFFY_COMMANDS, 24)


def _faffy_usage(fh=None):
    _usage(fh or sys.stderr, "faffy",
           "little toolkit for working with FASTA files", _FAFFY_COMMANDS, 22)


def _paffy_command(cmd):
    """The main of paffy command ``cmd``, or None."""
    if cmd == "add_mismatches":
        from paffy_tpu_torch.commands.simple import add_mismatches_main as m
    elif cmd == "chain":
        from paffy_tpu_torch.commands.chain_tile_bed import chain_main as m
    elif cmd == "dechunk":
        from paffy_tpu_torch.commands.coords import dechunk_main as m
    elif cmd == "dedupe":
        from paffy_tpu_torch.commands.simple import dedupe_main as m
    elif cmd == "invert":
        from paffy_tpu_torch.commands.simple import invert_main as m
    elif cmd == "filter":
        from paffy_tpu_torch.commands.simple import filter_main as m
    elif cmd == "shatter":
        from paffy_tpu_torch.commands.simple import shatter_main as m
    elif cmd == "tile":
        from paffy_tpu_torch.commands.chain_tile_bed import tile_main as m
    elif cmd == "to_bed":
        from paffy_tpu_torch.commands.chain_tile_bed import to_bed_main as m
    elif cmd == "trim":
        from paffy_tpu_torch.commands.simple import trim_main as m
    elif cmd == "upconvert":
        from paffy_tpu_torch.commands.coords import upconvert_main as m
    elif cmd == "split_file":
        from paffy_tpu_torch.commands.coords import split_file_main as m
    elif cmd == "view":
        from paffy_tpu_torch.commands.view import main as m
    else:
        return None
    return m


def _faffy_command(cmd):
    """The main of faffy command ``cmd``, or None."""
    if cmd == "chunk":
        from paffy_tpu_torch.commands.fasta_cmds import chunk_main as m
    elif cmd == "merge":
        from paffy_tpu_torch.commands.fasta_cmds import merge_main as m
    elif cmd == "extract":
        from paffy_tpu_torch.commands.fasta_cmds import extract_main as m
    else:
        return None
    return m


def _run(m, rest) -> int:
    """Run a command's main, then end its staged output with the stdio
    semantics of the reference's death (commands/common.GlibcWriter:
    errAbort flushes the sub-block tail, assert or SIGSEGV loses it)."""
    from paffy_tpu_torch.commands import common
    from paffy_tpu_torch.utils.logging import stop_profilers
    try:
        rc = m(rest)
    except BaseException as e:
        common.end_writers(error=e)
        stop_profilers()
        raise
    common.end_writers()
    return rc


def _main(argv, tool, lookup, usage) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        usage()
        return 0
    cmd, rest = argv[0], argv[1:]
    m = lookup(cmd)
    if m is None:
        sys.stderr.write(f"{cmd} is not a valid {tool} command\n")
        usage()
        return 1
    return _run(m, rest)


def paffy_main(argv=None) -> int:
    return _main(argv, "paffy", _paffy_command, _paffy_usage)


def faffy_main(argv=None) -> int:
    return _main(argv, "faffy", _faffy_command, _faffy_usage)
