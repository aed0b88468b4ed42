"""``paffy view`` of paffy_tpu_torch against paffy_tpu's, byte for byte, on
the CPU (PAFFY_TPU_PLATFORM=cpu): -s, -t, -a, failing -u/-v asserts, the
float32 threshold boundaries of tests/test_parity_corners.py, and the prefix
printed before a missing sequence aborts.  Also the device rule: with the
variable unset and no CUDA device, the port raises; and an unknown command
name."""

import numpy as np
import pytest
import torch

from paffy_tpu.cli import paffy_main as ref_main
from paffy_tpu_torch import devconf
from paffy_tpu_torch.cli import paffy_main as port_main
from ref_native import paffy_tpu_lib  # noqa: F401
from synthdata import make_workload


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_view")
    seqs, lines = make_workload(seed=1)
    rng = np.random.default_rng(3)
    with open(d / "seqs.fa", "w") as fh:
        for name, s in seqs.items():
            # soft-mask a stretch so case folding is exercised
            a, b = sorted(rng.integers(0, len(s), 2))
            s = s[:a] + s[a:b].lower() + s[b:]
            fh.write(f">{name}\n" + "\n".join(
                s[i: i + 60] for i in range(0, len(s), 60)) + "\n")
    (d / "in.paf").write_text("\n".join(lines) + "\n")
    (d / "uv.fa").write_text(">q\nACGTACGTACGTACGTACGT\n"
                             ">t\nACGTACGTACGTACGTACGA\n")
    (d / "uv.paf").write_text(
        "q\t20\t0\t20\t+\tt\t20\t0\t20\t20\t20\t60\tcg:Z:20M\n")
    (d / "m.fa").write_text(">q\n" + "ACGT" * 300 + "\n>t\n" + "ACGT" * 300
                            + "\n")
    rec = "q\t1200\t0\t200\t+\tt\t1200\t0\t200\t200\t200\t60\tcg:Z:200M\n"
    for role, bad in (("query", rec.replace("q\t", "zz\t", 1)),
                      ("target", rec.replace("\tt\t", "\tzz\t", 1))):
        (d / f"missing_{role}.paf").write_text(rec * 60 + bad + rec * 3)
    return d


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


def both(d, paf, fa, flags, tmp_path):
    """(rc, output bytes) of paffy_tpu's and the port's view."""
    out = []
    for tag, main in (("ref", ref_main), ("port", port_main)):
        o = tmp_path / f"{tag}.txt"
        rc = main(["view", "-i", str(d / paf), *flags, "-o", str(o),
                   str(d / fa)])
        out.append((rc, o.read_bytes()))
    return out


@pytest.mark.parametrize("flags", [
    ["-s"], ["-s", "-t"], ["-a", "-s"], [], ["-t"],
    ["-s", "-t", "-u", "0.9", "-v", "10000"],
    ["-s", "-u", "0.9999"],
    ["-s", "-v", "100000000"],
], ids=["s", "s-t", "a-s", "plain", "t", "uv-pass", "u-fail", "v-fail"])
def test_view_matches_paffy_tpu(files, tmp_path, cpu_platform, flags):
    ref, port = both(files, "in.paf", "seqs.fa", flags, tmp_path)
    assert port == ref
    failing = flags[-1:] in (["0.9999"], ["100000000"])
    assert ref[0] == (1 if failing else 0)


@pytest.mark.parametrize("flag,val,passes", [
    ("-u", "0.95", True), ("-u", "0.9501", False), ("-u", "0.9", True),
    ("-v", "20", True), ("-v", "21", False)])
def test_view_threshold_boundaries(files, tmp_path, cpu_platform, flag, val,
                                   passes):
    ref, port = both(files, "uv.paf", "uv.fa", ["-s", "-t", flag, val],
                     tmp_path)
    assert port == ref
    assert (ref[0] == 0) == passes


@pytest.mark.parametrize("role", ["query", "target"])
@pytest.mark.parametrize("flags", [[], ["-s", "-t"], ["-a", "-s"]],
                         ids=["plain", "s-t", "a-s"])
def test_view_missing_sequence_prefix(files, tmp_path, cpu_platform, role,
                                      flags, capsys):
    ref, port = both(files, f"missing_{role}.paf", "m.fa", flags, tmp_path)
    assert port == ref and ref[0] == 1
    assert capsys.readouterr().err.count(
        f"No {role} sequence named: zz found") == 2


def test_view_without_cuda_raises(files, tmp_path, monkeypatch):
    monkeypatch.delenv("PAFFY_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(["view", "-i", str(files / "in.paf"), "-s", "-o",
                   str(tmp_path / "o.txt"), str(files / "seqs.fa")])


def test_device_rule(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")
    assert devconf.device() == torch.device("cpu")
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        devconf.device()
    monkeypatch.delenv("PAFFY_TPU_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        devconf.device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert devconf.device() == torch.device("cuda", 0)


def test_unported_commands_exit_1(capsys):
    # every command is ported: an unknown name exits 1 with paffy_tpu's
    # message and usage, for paffy and for faffy
    from paffy_tpu_torch.cli import faffy_main
    for main, tool in ((port_main, "paffy"), (faffy_main, "faffy")):
        assert main(["no_such_command", "-i", "x.paf"]) == 1
        err = capsys.readouterr().err
        assert err.startswith(f"no_such_command is not a valid {tool} "
                              f"command\n{tool}: ")
        assert main([]) == 0
        assert capsys.readouterr().err.startswith(f"{tool}: ")
