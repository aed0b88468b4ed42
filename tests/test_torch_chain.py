"""``chain`` of paffy_tpu_torch against paffy_tpu's, on the CPU
(PAFFY_TPU_PLATFORM=cpu, so K6 runs its plain PyTorch version): the plain
chain DP gives the (cs, pred) of paffy_tpu's numpy oracle ``_dp_numpy``,
the port's C ``chain_dp`` and paffy_tpu's JAX scan ``chain_groups_device``
on random groups, every case of chip_smoke.k6_edge_cases at a small size
and mixed group sizes in one call; the plain emulation of the CUDA
kernel's split (the walker's K recent candidates, the helpers' older ones,
merged by the four-key compare) gives the same at K of 1, 2, 32 and more
than any window holds; ``paf_chain_order`` solves both strand sets in one
DP call and gives paffy_tpu's tags and order on synthdata workloads and
their shattered form; the command gives the same bytes and exit codes,
and without a device raises before it reads its input."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from paffy_tpu.cli import paffy_main as ref_main
from paffy_tpu.core import pafio as ref_pafio
from paffy_tpu.ops import chain as ref_chain
from paffy_tpu.ops.chain_device import chain_groups_device
from paffy_tpu.ops.transforms import shatter as ref_shatter
from paffy_tpu_torch import kernels, native
from paffy_tpu_torch.cli import paffy_main as port_main
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.ops import chain, chain_device
from synthdata import make_workload

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


def port_dp(groups, costs):
    """The port's (cs, pred) per group, group-local as _dp_numpy's, from
    one call of the wrapper on CPU tensors."""
    host = chain.dp_arguments(groups, costs[2])
    before = kernels.LAUNCHES["chain_dp"]
    cs, pred = chain_device.chain_dp_groups(
        *(torch.from_numpy(a) for a in host), *costs)
    assert kernels.LAUNCHES["chain_dp"] == before     # no kernel on the CPU
    goff = host[0]
    cs, pred = cs.numpy(), pred.numpy()
    return [(cs[a:b], np.where(pred[a:b] >= 0, pred[a:b] - a, -1))
            for a, b in zip(goff[:-1], goff[1:])]


def assert_dp_matches_paffy_tpu(groups, costs, jax_scan=True):
    got = port_dp(groups, costs)
    jax_out = chain_groups_device(groups, *costs) if jax_scan else None
    for k, (g, (cs, pred)) in enumerate(zip(groups, got)):
        want = ref_chain._dp_numpy(*g, *costs)
        np.testing.assert_array_equal(cs, want[0], err_msg=f"cs {k}")
        np.testing.assert_array_equal(pred, want[1], err_msg=f"pred {k}")
        qe_order, lo, hi = ref_chain._window_bounds(g[0], g[1], costs[2])
        c_cs, c_pred = native.chain_dp(*g, qe_order, lo, hi, *costs)
        np.testing.assert_array_equal(cs, c_cs)
        np.testing.assert_array_equal(pred, c_pred)
        if jax_scan:
            np.testing.assert_array_equal(cs, jax_out[k][0])
            np.testing.assert_array_equal(pred, jax_out[k][1])
    return got


def random_group(rng, n, span, max_len, top):
    qs = np.sort(rng.integers(0, span, n))
    qe = qs + rng.integers(1, max_len, n)
    ts = rng.integers(0, span, n)
    return qs, qe, ts, ts + rng.integers(1, max_len, n), rng.integers(1, top, n)


@pytest.mark.parametrize("seed,max_gap", [(0, 20), (1, 200), (2, 10**6)])
def test_plain_dp_matches_paffy_tpu_on_random_groups(seed, max_gap):
    rng = np.random.default_rng(seed)
    groups = [random_group(rng, int(rng.integers(1, 90)), 600, 40, 300)
              for _ in range(4)]
    got = assert_dp_matches_paffy_tpu(groups, (50, 1, max_gap))
    assert any((pred >= 0).any() for _, pred in got)


def test_plain_dp_matches_paffy_tpu_on_mixed_group_sizes():
    rng = np.random.default_rng(9)
    groups = [random_group(rng, n, 20_000, 60, 100)
              for n in (7, 900, 12, 3, 400, 1)]
    assert_dp_matches_paffy_tpu(groups, (5000, 1, 500))


@pytest.mark.parametrize("label", chip_smoke.K6_EDGE_LABELS)
def test_plain_dp_matches_paffy_tpu_on_edge_cases(label):
    groups, costs = chip_smoke.k6_edge_cases(scale=0.05)[label]
    got = assert_dp_matches_paffy_tpu(groups, costs)
    cs = np.concatenate([c for c, _ in got])
    if label == "past 2^40":
        assert cs.max() > 1 << 40
    if label == "mirrored coordinates":
        assert (np.concatenate([g[0] for g in groups]) < 0).all()
    if label == "groups of 0 and 1":
        assert {len(g[0]) for g in groups} >= {0, 1}


def test_edge_cases_reach_what_they_name():
    # at full size (only the arguments are built here): windows past 4x
    # the block, 2,000 small groups next to a large one, and the ties,
    # zero gaps and g == score the tie case is for
    cases = chip_smoke.k6_edge_cases()
    wide = chain.dp_arguments(*[cases["wide windows"][0], 1000])
    assert wide[8].max() > chip_smoke.K6_WIDE and wide[8].min() <= 1
    groups, _ = cases["many groups and a large one"]
    sizes = sorted(len(g[0]) for g in groups)
    assert len(groups) == 2001 and sizes[-1] >= 2000 > sizes[-2]
    (qs, qe, ts, te, score), = cases["ties, zero gaps, g == score"][0]
    zero = g_eq = 0
    for i in range(len(qs)):
        j = np.flatnonzero((qe[:i] <= qs[i]) & (te[:i] <= ts[i]))
        gap = (qs[i] - qe[j]) + (ts[i] - te[j])
        zero += int((gap == 0).sum())
        g_eq += int(((gap > 0) & (1 + gap == score[i])).sum())
    assert zero > 0 and g_eq > 0
    (qs, qe, ts, te, _), = cases["tgap at max_gap"][0]
    tgap = ts[:, None] - te[None, :]
    assert (tgap == 100).any() and (tgap == 101).any()


# ------------------------------------------------ the kernel's split

# K: one or two recent candidates, the kernel's default, and more than any
# window of these cases holds (every candidate is then the walker's)
SPLIT_K = (1, 2, chain_device.K6_RECENT, 10**6)


def assert_split_matches(groups, costs, k, jax_scan=False):
    """The split emulation on ``groups`` in one call equals the sequential
    plain DP, and paffy_tpu's (via assert_dp_matches_paffy_tpu)."""
    host = [torch.from_numpy(a) for a in chain.dp_arguments(groups,
                                                            costs[2])]
    got = chain_device.chain_dp_split_plain(*host, *costs, k=k)
    want = chain_device.chain_dp_groups_plain(*host, *costs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert_dp_matches_paffy_tpu(groups, costs, jax_scan=jax_scan)
    return got, host


@pytest.mark.parametrize("k", SPLIT_K)
@pytest.mark.parametrize("label", chip_smoke.K6_EDGE_LABELS)
def test_split_emulation_on_edge_cases(label, k):
    groups, costs = chip_smoke.k6_edge_cases(scale=0.05)[label]
    (cs, pred), host = assert_split_matches(groups, costs, k)
    if k == SPLIT_K[-1]:
        assert k > host[1].numel()      # every candidate is recent


@pytest.mark.parametrize("k", SPLIT_K)
@pytest.mark.parametrize("seed,max_gap", [(4, 200), (5, 10**6)])
def test_split_emulation_on_random_groups(seed, max_gap, k):
    # ties in (val, te, qe) come from coordinates and scores on a few
    # values; one-record groups sit among larger ones
    rng = np.random.default_rng(seed)
    groups = [random_group(rng, n, 60, 6, 40) for n in (1, 60, 1, 140)]
    (cs, pred), _ = assert_split_matches(groups, (2, 1, max_gap), k,
                                         jax_scan=k == chain_device.K6_RECENT)
    assert (pred >= 0).any()


def test_ring_slots_hold_twice_k():
    for k in (1, 2, 31, 32, 33, 256):
        r = chain_device.ring_slots(k)
        assert r > 2 * k and r & (r - 1) == 0 and r <= 4 * k + 2


def test_paf_chain_order_solves_both_strand_sets_in_one_call():
    t, r = workload_tables(6, True)
    calls = []

    def dp_many(groups, *costs):
        calls.append(len(groups))
        return [ref_chain._dp_numpy(*g, *costs) for g in groups]
    tagged, perm = chain.paf_chain_order(t, dp_many=dp_many)
    want, want_perm = ref_chain.paf_chain_order(r)
    plus, minus = chain.chain_groups(t)
    assert calls == [len(plus) + len(minus)] and len(plus) and len(minus)
    np.testing.assert_array_equal(perm, want_perm)
    np.testing.assert_array_equal(tagged.chain_id, want.chain_id)
    np.testing.assert_array_equal(tagged.chain_score, want.chain_score)


def test_plain_dp_of_no_record():
    host = chain.dp_arguments([], 100)
    cs, pred = chain_device.chain_dp_groups(
        *(torch.from_numpy(a) for a in host), 1, 1, 100)
    assert cs.numel() == 0 and pred.numel() == 0


def test_dp_wrapper_refuses_bad_inputs():
    host = [torch.from_numpy(a) for a in chain.dp_arguments(
        [random_group(np.random.default_rng(3), 5, 100, 10, 50)], 100)]
    with pytest.raises(ValueError):
        chain_device.chain_dp_groups(host[0].int(), *host[1:], 1, 1, 100)
    with pytest.raises(ValueError):
        chain_device.chain_dp_groups(*host[:3], host[3][:-1], *host[4:],
                                     1, 1, 100)
    with pytest.raises(ValueError):
        chain_device.chain_dp_groups(*host[:9], host[9].reshape(1, -1),
                                     1, 1, 100)


# ------------------------------------------------- the table and the command

def workload_tables(seed, shattered):
    seqs, lines = make_workload(seed=seed, length=15000, n_windows=20,
                                window=2000, step=500)
    text = "\n".join(lines) + "\n"
    if shattered:
        text = ref_pafio.serialize_paf(ref_shatter(
            ref_pafio.parse_paf_text(text)))
    return pafio.parse_paf_text(text), ref_pafio.parse_paf_text(text)


@pytest.mark.parametrize("seed,shattered", [(6, False), (7, False),
                                            (6, True), (8, True)])
def test_paf_chain_order_matches_paffy_tpu(seed, shattered):
    t, r = workload_tables(seed, shattered)
    for kw in ({}, dict(gap_open=100, gap_extend=2, max_gap=3000,
                        pct_trim=0.25)):
        tagged, perm = chain.paf_chain_order(t, **kw)
        want, want_perm = ref_chain.paf_chain_order(r, **kw)
        np.testing.assert_array_equal(perm, want_perm)
        np.testing.assert_array_equal(tagged.chain_id, want.chain_id)
        np.testing.assert_array_equal(tagged.chain_score, want.chain_score)
    assert len(np.unique(tagged.chain_id)) < len(t) or not shattered


def test_chain_groups_are_paffy_tpus():
    t, r = workload_tables(6, True)
    for groups, sel in zip(chain.chain_groups(t),
                           (np.flatnonzero(r.strand),
                            np.flatnonzero(~r.strand))):
        assert sum(len(g[0]) for g in groups) == len(sel)
        assert_dp_matches_paffy_tpu(groups, chip_smoke.CHAIN_COSTS,
                                    jax_scan=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_chain")
    _, lines = make_workload(seed=6, length=15000, n_windows=20,
                             window=2000, step=500)
    text = "\n".join(lines) + "\n"
    (d / "in.paf").write_text(text)
    (d / "shattered.paf").write_text(ref_pafio.serialize_paf(
        ref_shatter(ref_pafio.parse_paf_text(text))))
    # a raw cigar the full parser would rewrite (a leading zero), and a
    # record past its query's end (paf_check fails after the chaining)
    f = lines[2].split("\t")
    f[-1] = "cg:Z:0" + f[-1][5:]
    bad = lines[5].split("\t")
    bad[3] = str(int(bad[1]) + 5)
    (d / "raw.paf").write_text("\n".join(lines[:2] + ["\t".join(f)]
                                         + lines[3:]) + "\n")
    (d / "bad.paf").write_text("\n".join(lines[:5] + ["\t".join(bad)]
                                         + lines[6:]) + "\n")
    return d


def both(argv, tmp_path):
    """((rc, error), output bytes) of paffy_tpu's and the port's command."""
    out = []
    for tag, main in (("ref", ref_main), ("port", port_main)):
        o = tmp_path / f"{tag}.paf"
        try:
            res = (main([*argv, "-o", str(o)]), None)
        except Exception as e:           # the command's own failure
            res = (None, f"{type(e).__name__}: {e}")
        out.append((res, o.read_bytes() if o.exists() else None))
    return out


@pytest.mark.parametrize("paf,flags", [
    ("in.paf", []), ("shattered.paf", []), ("shattered.paf", ["-g", "300"]),
    ("shattered.paf", ["-d", "50"]), ("shattered.paf", ["-e", "3"]),
    ("in.paf", ["-t", "0.3"]), ("raw.paf", [])],
    ids=["default", "shattered", "g", "d", "e", "t", "raw-cigar"])
def test_chain_cli_matches_paffy_tpu(files, tmp_path, paf, flags):
    ref, port = both(["chain", "-i", str(files / paf), *flags], tmp_path)
    assert port == ref and ref[0] == (0, None)
    assert b"cn:i:" in ref[1]
    if paf == "raw.paf":
        assert b"cg:Z:0" in ref[1]     # written back as it was read


@pytest.mark.parametrize("argv", [["-t", "1.5"], []],
                         ids=["trim-fraction", "check-failure"])
def test_chain_cli_failures_match_paffy_tpu(files, tmp_path, argv):
    paf = "in.paf" if argv else "bad.paf"
    ref, port = both(["chain", "-i", str(files / paf), *argv], tmp_path)
    assert port == ref and ref[0][1] is not None


def test_chain_without_device_raises_before_reading(monkeypatch, tmp_path):
    monkeypatch.delenv("PAFFY_TPU_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = tmp_path / "never-read.paf"
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        port_main(["chain", "-i", str(missing), "-o",
                   str(tmp_path / "out.paf")])


def test_chain_launcher_without_device_exits_before_reading(tmp_path):
    # no visible card and no PAFFY_TPU_PLATFORM: a non-zero exit that
    # names the device, not the input file it never opened
    env = {k: v for k, v in os.environ.items() if k != "PAFFY_TPU_PLATFORM"}
    r = subprocess.run(
        [sys.executable, str(REPO / "bin" / "paffy-torch"), "chain", "-i",
         str(tmp_path / "never-read.paf")], cwd=tmp_path,
        env=dict(env, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr
    assert "never-read" not in r.stderr
