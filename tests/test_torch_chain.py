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
from dataclasses import replace

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
from ref_native import paffy_tpu_lib  # noqa: F401
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


# --------------------------- the native extraction and the group keys

def paf_line(qname, qs, m, strand, tname, ts, score, qlen=10**6,
             tlen=10**6):
    """A gapless record: query [qs, qs + m), target [ts, ts + m)."""
    return (f"{qname}\t{qlen}\t{qs}\t{qs + m}\t{strand}\t{tname}\t{tlen}"
            f"\t{ts}\t{ts + m}\t{m}\t{m}\t60\tAS:i:{score}\tcg:Z:{m}M")


def dense_lines(rng, n, pairs, span=80, max_len=6, scores=(4, 8)):
    """``n`` short records on few coordinates and scores, so that chain
    scores tie and predecessors are shared: the pair of each record drawn
    from ``pairs``, strands from both."""
    out = []
    for _ in range(n):
        q, tn = pairs[int(rng.integers(len(pairs)))]
        out.append(paf_line(q, int(rng.integers(0, span)),
                            int(rng.integers(1, max_len)),
                            "+-"[int(rng.integers(2))], tn,
                            int(rng.integers(0, span)),
                            int(rng.choice(scores))))
    return out


def extraction_case(label):
    """(PAF lines, costs) of a case built to stress the extraction order."""
    rng = np.random.default_rng(sum(map(ord, label)))
    if label == "equal scores across groups and strands":
        # records too far apart to link: every chain score is 7, the
        # order is the processing order's, latest first
        return [paf_line(f"q{g}", 1000 * k + 10 * g, 5, s, f"t{g % 2}",
                         3000 * k, 7) for k in range(4) for g in range(3)
                for s in "+-"], (100, 1, 50)
    if label == "predecessor chains cut by earlier claims":
        # C (27) claims A before B (15) reaches it: B is a chain of its
        # own; the dense records, in another pair, tie and share
        return ([paf_line("a", 0, 10, "+", "b", 0, 10),
                 paf_line("a", 12, 10, "+", "b", 12, 10),
                 paf_line("a", 11, 20, "+", "b", 11, 20)]
                + dense_lines(rng, 150, [("q", "t")])), (1, 1, 30)
    if label == "links with zero gap":
        return ([paf_line("a", 10 * k, 10, "+", "b", 10 * k, 3)
                 for k in range(6)]
                + dense_lines(rng, 80, [("q", "t")], span=30)), (5, 2, 40)
    if label == "mirrored '-' records":
        # down the query, up the target: in mirrored coordinates each
        # abuts the last
        return ([paf_line("a", 100 - 10 * k, 10, "-", "b", 10 * k, 6)
                 for k in range(5)]
                + [x for x in dense_lines(rng, 150, [("q", "t")])
                   if "\t-\t" in x]), (2, 1, 30)
    if label == "many groups":
        pairs = [(f"q{i}", f"t{j}") for i in range(6) for j in range(5)]
        return dense_lines(rng, 400, pairs), (3, 1, 40)
    if label == "no record":
        return [], (5000, 1, 10**6)
    assert label == "one record"
    return [paf_line("q", 5, 20, "-", "t", 9, 40)], (5000, 1, 10**6)


EXTRACTION_CASES = ["equal scores across groups and strands",
                    "predecessor chains cut by earlier claims",
                    "links with zero gap", "mirrored '-' records",
                    "many groups", "no record", "one record"]


@pytest.mark.parametrize("label", EXTRACTION_CASES)
def test_native_extraction_matches_paffy_tpu_on_ties(label):
    lines, (gap_open, gap_extend, max_gap) = extraction_case(label)
    text = "".join(x + "\n" for x in lines)
    t, r = pafio.parse_paf_text(text), ref_pafio.parse_paf_text(text)
    # untrimmed, so that the records abut and link as built
    kw = dict(gap_open=gap_open, gap_extend=gap_extend, max_gap=max_gap,
              pct_trim=0.0)
    tagged, perm = chain.paf_chain_order(t, **kw)
    want, want_perm = ref_chain.paf_chain_order(r, **kw)
    if not lines:
        assert perm is None and want_perm is None
        return
    np.testing.assert_array_equal(perm, want_perm)
    np.testing.assert_array_equal(tagged.chain_id, want.chain_id)
    np.testing.assert_array_equal(tagged.chain_score, want.chain_score)
    assert tagged.chain_id.dtype == tagged.chain_score.dtype == np.int64
    if label == "equal scores across groups and strands":
        assert (tagged.chain_score == 7).all()
        assert len(np.unique(tagged.chain_id)) == len(t)
    if label == "predecessor chains cut by earlier claims":
        # A and C one chain of 10 + 20 - 3, B alone with its own score
        assert tagged.chain_id[0] == tagged.chain_id[2] != tagged.chain_id[1]
        assert tagged.chain_score[:3].tolist() == [27, 10, 27]
    if label in ("links with zero gap", "mirrored '-' records"):
        # the abutting records are one chain, its links free
        k = 6 if label == "links with zero gap" else 5
        assert len(set(tagged.chain_id[:k].tolist())) == 1
        assert tagged.chain_score[0] == k * int(t.score[0])


def name_case(label):
    """(PAF lines, the port's table) of a case of the group keys."""
    rng = np.random.default_rng(sum(map(ord, label)))
    if label == "interleaved pairs":
        lines = [paf_line("A", 3 * k, 5, "+-"[k % 3 == 0], "BC"[k % 2],
                          int(rng.integers(0, 90)), 9) for k in range(60)]
    elif label == "a name changing on every record":
        lines = [paf_line(f"q{k}", int(rng.integers(0, 90)), 5, "+-"[k % 2],
                          "t", int(rng.integers(0, 90)), 9)
                 for k in range(60)]
    else:
        lines = dense_lines(rng, 120, [("anc.chr1", "des.chr1")])
    text = "".join(x + "\n" for x in lines)
    t = pafio.parse_paf_text(text)
    if label == "equal names in distinct str objects":
        fresh = np.empty(len(t), dtype=object)
        fresh[:] = ["".join(list(x)) for x in t.qname]
        assert fresh[0] is not fresh[1] and fresh[0] == fresh[1]
        t = replace(t, qname=fresh)
    if label == "one str object for every name":
        same = np.empty(len(t), dtype=object)
        same[:] = [t.qname[0]] * len(t)
        t = replace(t, qname=same)
    return text, t


NAME_CASES = ["interleaved pairs", "equal names in distinct str objects",
              "one str object for every name",
              "a name changing on every record", "a single pair"]


@pytest.mark.parametrize("label", NAME_CASES)
def test_chain_groups_are_paffy_tpus_on_name_runs(label):
    text, t = name_case(label)
    r = ref_pafio.parse_paf_text(text)
    seen = []

    def dp_many(groups, *costs):
        seen.append(groups)
        return [ref_chain._dp_numpy(*g, *costs) for g in groups]
    want, want_perm = ref_chain.paf_chain_order(r, dp_many=dp_many)
    got = chain.chain_groups(t)
    assert len(seen) == 2 and [len(g) for g in got] == [len(g) for g in seen]
    for mine, theirs in zip(got, seen):
        for g, h in zip(mine, theirs):
            for a, b in zip(g, h):
                np.testing.assert_array_equal(a, b)
    tagged, perm = chain.paf_chain_order(t)
    np.testing.assert_array_equal(perm, want_perm)
    np.testing.assert_array_equal(tagged.chain_id, want.chain_id)
    np.testing.assert_array_equal(tagged.chain_score, want.chain_score)
    if label == "interleaved pairs":
        assert [len(g) for g in got] == [2, 2]


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
        [sys.executable, str(REPO / "bin" / "paffy-torch-py"), "chain", "-i",
         str(tmp_path / "never-read.paf")], cwd=tmp_path,
        env=dict(env, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr
    assert "never-read" not in r.stderr
