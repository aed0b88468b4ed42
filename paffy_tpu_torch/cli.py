"""``paffy-torch <cmd>``: the port's command line (counterpart of
paffy_tpu/cli.py:41 ``paffy_main`` and :80 ``_run``).
``add_mismatches``, ``chain``, ``tile``, ``trim`` and ``view`` are
ported; every other command exits 1 and says so."""

from __future__ import annotations

import sys


def _usage(fh=sys.stderr):
    fh.write("paffy-torch: paffy on PyTorch and CUDA\n\n")
    fh.write("usage: paffy-torch <command> [options]\n\n")
    fh.write("available commands:\n")
    for cmd, desc in _COMMANDS:
        fh.write(f"    {cmd:<24} {desc}\n")
    fh.write("\n")


_COMMANDS = (
    ("add_mismatches", "Replace Ms with =/Xs in PAF cigar string"),
    ("chain", "Chain together PAF alignments"),
    ("tile", "Give alignments levels, from lowest (best) to highest (worse)"),
    ("trim", "Slice of lower identity tail alignments"),
    ("view", "Pretty print and extract stats about PAF alignments"),
)


def _run(m, rest) -> int:
    """Run a command's main, then end its staged output with the stdio
    semantics of the reference's death (commands/common.GlibcWriter:
    errAbort flushes the sub-block tail, assert or SIGSEGV loses it)."""
    from paffy_tpu_torch.commands import common
    try:
        rc = m(rest)
    except BaseException as e:
        common.end_writers(error=e)
        raise
    common.end_writers()
    return rc


def paffy_main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        _usage()
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "add_mismatches":
        from paffy_tpu_torch.commands.simple import add_mismatches_main as m
    elif cmd == "chain":
        from paffy_tpu_torch.commands.chain_tile_bed import chain_main as m
    elif cmd == "tile":
        from paffy_tpu_torch.commands.chain_tile_bed import tile_main as m
    elif cmd == "trim":
        from paffy_tpu_torch.commands.simple import trim_main as m
    elif cmd == "view":
        from paffy_tpu_torch.commands.view import main as m
    else:
        sys.stderr.write(f"{cmd} is not ported to paffy_tpu_torch yet (only "
                         f"{', '.join(c for c, _ in _COMMANDS)} are); "
                         f"bin/paffy runs it on paffy_tpu\n")
        return 1
    return _run(m, rest)
