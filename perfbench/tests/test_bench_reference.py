"""The plain reference's vectorised chain DP, tile levels and trim against
their loops, written straight from paffy's C, on random inputs full of
ties, zero gaps, stacked records and short ops."""

import numpy as np
import pytest

import reference as ref


def dp_loop(qs, qe, ts, te, score, go, ge, mg):
    """impl/chaining.c:150-214, one candidate at a time."""
    n = len(qs)
    cs, pred = list(score), [-1] * n
    for i in range(n):
        best, bte, bqe, bj = None, 0, 0, -1
        for j in range(i):
            if not (qs[i] - mg <= qe[j] <= qs[i]):
                continue
            qg, tg = qs[i] - qe[j], ts[i] - te[j]
            if tg < 0 or tg > mg:
                continue
            g = 0 if qg + tg == 0 else go + ge * (qg + tg)
            if g >= score[i]:
                continue
            v = score[i] + cs[j] - g
            if (best is None or v > best
                    or (v == best and (te[j], qe[j], j) > (bte, bqe, bj))):
                best, bte, bqe, bj = v, te[j], qe[j], j
        if bj >= 0 and best > score[i]:
            cs[i], pred[i] = best, bj
    return cs, pred


@pytest.mark.parametrize("seed", range(12))
def test_chain_dp_equals_its_loop(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 120))
    qs = np.sort(rng.integers(0, 60, n))
    qe = qs + rng.integers(0, 4, n)
    ts = rng.integers(0, 60, n)
    te = ts + rng.integers(0, 4, n)
    score = rng.integers(0, 30, n)
    go, ge, mg = int(rng.integers(0, 6)), int(rng.integers(1, 3)), 20
    cs, pred = ref.chain_dp(qs, qe, ts, te, score, go, ge, mg)
    cs2, pred2 = dp_loop(qs.tolist(), qe.tolist(), ts.tolist(), te.tolist(),
                         score.tolist(), go, ge, mg)
    assert cs.tolist() == cs2
    assert pred.tolist() == pred2


def tile_loop(starts, ends, rec_of, n, order, qlen):
    counts = np.zeros(qlen, dtype=np.int64)
    levels = [ref.EMPTY_TILE_LEVEL] * n
    for r in order:
        new = []
        for s, e, k in zip(starts, ends, rec_of):
            if k == r:
                counts[s:e] = np.minimum(counts[s:e] + 1, ref.SATURATION)
                new.extend(counts[s:e].tolist())
        if new:
            levels[r] = sorted(new)[(len(new) + 1) // 2 - 1]
    return levels


@pytest.mark.parametrize("seed", range(8))
def test_tile_levels_equal_their_loop(seed):
    rng = np.random.default_rng(seed)
    n, qlen = int(rng.integers(1, 40)), 200
    recs = {"qname": np.array(["q"] * n, dtype=object),
            "qlen": np.full(n, qlen), "qstart": rng.integers(0, 100, n)}
    nops = rng.integers(0, 5, n)
    recs["off"] = np.concatenate([[0], np.cumsum(nops)])
    recs["ops"] = rng.choice([0, 1, 2, 3, 4], int(nops.sum())).astype(
        np.uint8)
    recs["lens"] = rng.integers(0, 20, int(nops.sum()))
    order = rng.permutation(n)
    rec, qoff, _ = ref._op_positions(recs)
    al = (recs["ops"] != 1) & (recs["ops"] != 2)
    s = recs["qstart"][rec] + qoff
    e = s + recs["lens"]
    got = ref.tile_levels(recs, order)
    assert got.tolist() == tile_loop(s[al], e[al], rec[al], n, order.tolist(),
                                      qlen)


def trim_loop(ops, lens, thr, ident, mt):
    """trim_decide_dir of the C, over one walk."""
    pm = pmm = 0
    trim_idx, pm_ti, pmm_ti = -1, 0, 0
    f = np.float32
    for j, (o, ln) in enumerate(zip(ops, lens)):
        if o in (0, 3):
            pm += ln
        else:
            pmm += ln
        cols = pm + pmm
        if mt >= 0 and cols > mt:
            break
        with np.errstate(divide="ignore", invalid="ignore"):
            if f(pm) / f(cols) < thr:
                trim_idx, pm_ti, pmm_ti = j, pm, pmm
    if trim_idx < 0:
        return 0
    bm = bmm = 0
    for j in range(trim_idx + 1):
        sm, smm = pm_ti - bm, pmm_ti - bmm
        with np.errstate(divide="ignore", invalid="ignore"):
            if f(sm) / f(sm + smm) >= ident:
                return j
        if ops[j] in (0, 3):
            bm += lens[j]
        else:
            bmm += lens[j]
    return trim_idx + 1


@pytest.mark.parametrize("seed", range(8))
def test_trim_decisions_equal_their_loop(seed):
    rng = np.random.default_rng(seed)
    n = 60
    nops = rng.integers(0, 12, n)
    off = np.concatenate([[0], np.cumsum(nops)])
    ops = rng.choice([1, 2, 3, 4, 4], int(nops.sum())).astype(np.uint8)
    lens = rng.integers(0, 6, int(nops.sum()))
    fwd = rng.random(n) < 0.5
    recs = {"off": off, "ops": ops, "lens": lens, "fwd": fwd,
            "qstart": np.full(n, 1000), "qend": np.full(n, 2000),
            "tstart": np.full(n, 1000), "tend": np.full(n, 2000)}
    out = ref.trim(recs)
    f = np.float32
    for r in range(n):
        o, ln = ops[off[r]:off[r + 1]].tolist(), lens[off[r]:off[r + 1]]
        ln = ln.tolist()
        m = sum(x for y, x in zip(o, ln) if y in (0, 3))
        c = sum(ln)
        with np.errstate(divide="ignore", invalid="ignore"):
            i_ = f(m) / f(c)
        thr = f(float(i_) - float(i_) * float(f(0.05)))
        mt = int(np.trunc(f(c) * f(1.0)))
        a = trim_loop(o, ln, thr, i_, mt)
        rest_o, rest_l = o[a:], ln[a:]
        if not fwd[r]:
            rest_o, rest_l = rest_o[::-1], rest_l[::-1]
        b = trim_loop(rest_o, rest_l, thr, i_, mt)
        kept = (o[a + b:], ln[a + b:]) if fwd[r] else (
            o[a: len(o) - b], ln[a: len(ln) - b])
        lo, hi = out["off"][r], out["off"][r + 1]
        assert out["ops"][lo:hi].tolist() == kept[0]
        assert out["lens"][lo:hi].tolist() == kept[1]
