"""The port's columnar lattice walk (`_lattice_from_rec` on record
columns) against htk_tpu's dict walk of the same records, on the CPU.

Seeded synthetic record sets, as arrays: entry frames with more than
MAXC = 64 candidates, integer scores and LM scores so that candidates and
alternatives tie, records from the utterance's start, records severed
from their predecessor (-1, -2), and finals at T - 1 that repeat the key
of an earlier record (a dict keeps the first place and the last value:
the port's `_dict_order`). The test turns the arrays into htk_tpu's
record dict. The net is a stand-in that holds only what the walk reads:
a dense LM matrix, back-off bigram tables, or trigram guidance over
them; some LM scores sit 30 below the rest, so that the arc beam of 250
drops alternatives. Each case must give byte-identical SLF and the same
nodes and arcs, float for float, under LATPREDS 1, 2 and 8 and with the
arc beam off and at 250; the `resolve` cases bring some missing
predecessors back (a chain of them) and sever the rest. The walk returns
its lattice as columns and builds no `LNode`/`LArc` (no
`htk.lattice.views` span while it runs): its SLF is written from the
columns, and the lists, once read, write the same bytes.
"""

import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest

from htk_tpu.algo import decode as jdec
from htk_tpu.io import slf as jslf
from htk_tpu_torch.algo import decode as pdec
from htk_tpu_torch.io.slf import write_slf
from htk_tpu_torch.utils import metrics
from htk_tpu_torch.utils.logmath import LZERO

R, T = 160, 90  # rows (word nodes) and frames of an utterance
LM_SCALE, PEN = 12.0, -2.0


def _net(kind, rng):
    words = [f"W{i}" for i in range(R)]
    net = SimpleNamespace(
        node_words=words, xw_backoff=None, xw_trigram=None,
        end_exit=np.where(rng.random(R) < 0.7,
                          -rng.integers(1, 4, R).astype(np.float64), LZERO),
        start_entry=-rng.integers(1, 4, R).astype(np.float64))
    if kind == "dense":
        net.trans = np.where(rng.random((R, R)) < 0.9,
                             -rng.choice([1, 2, 30], (R, R)), LZERO).astype(
                                 np.float32)
        return net
    fb = 12  # explicit successors a row: one bucket of back-off tables
    preds = np.stack([rng.choice(R, fb, replace=False) for _ in range(R)])
    scores = np.where(rng.random((R, fb)) < 0.85,
                      -rng.integers(0, 2, (R, fb)), LZERO).astype(np.float32)
    net.xw_backoff = {"inv": rng.permutation(R), "buckets": [(preds, scores)],
                      "bow": -rng.choice([1, 2, 30], R).astype(np.float32),
                      "uni": -rng.integers(2, 5, R).astype(np.float32)}
    if kind == "trigram":
        # contexts: row -> word id, the last entry the sentence start
        ctx = np.append(rng.permutation(R), R)
        n_u = rng.integers(0, 4, R)
        pair_u = np.concatenate([np.sort(rng.choice(R + 1, k, replace=False))
                                 for k in n_u])
        tcnt = rng.integers(0, 4, pair_u.size)
        tri_j = np.concatenate([np.sort(rng.choice(R, k, replace=False))
                                for k in tcnt])
        net.xw_trigram = {
            "ctx_word": ctx, "seg_start": np.append(0, np.cumsum(n_u)),
            "pair_u": pair_u, "pair_tcnt": tcnt, "tri_j": tri_j,
            "pair_bow": -rng.integers(0, 2, pair_u.size).astype(np.float32),
            "tri_p": -rng.integers(0, 3, tri_j.size).astype(np.float32)}
    return net


def _records(rng, missing=False):
    """Record columns (node, t, score, pn, pt) in insertion order, with
    repeated keys, and the records a resolve can bring back."""
    per_t = {}
    cols = []
    for t in range(T - 1):
        n_t = 80 if t in (20, 21, 47) else int(rng.integers(0, 9))
        nodes = rng.choice(R, n_t, replace=False)
        per_t[t] = nodes
        for i in nodes.tolist():
            # integer scores falling with t: ties at every entry frame
            s = -10.0 * (t + 1) - float(rng.integers(0, 4))
            frames = [p for p in per_t if p < t and per_t[p].size]
            if not frames or rng.random() < 0.08:
                pn, pt = -1, -1
            else:
                pt = frames[-1 - int(rng.integers(0, min(6, len(frames))))]
                pn = int(rng.choice(per_t[pt]))
            cols.append((i, t, s, pn, pt))
    # finals at T - 1: some repeat a key seen earlier among them
    fin = rng.choice(R, 12, replace=False).tolist()
    for i in fin + fin[:3]:
        pt = T - 2 - int(rng.integers(0, 4))
        pn = int(rng.choice(per_t[pt])) if per_t[pt].size else -1
        cols.append((i, T - 1, -10.0 * T - float(rng.integers(0, 6)), pn,
                     pt if pn >= 0 else -1))
    node, t, s, pn, pt = (np.array(c) for c in zip(*cols))
    sev = rng.random(node.size) < 0.03
    pn[sev], pt[sev] = -1, -2
    extra = {}
    if missing:
        # predecessors outside the records: about half come back, each
        # from a chain of up to three more (some unavailable at its end)
        hit = np.nonzero((pn >= 0) & (rng.random(node.size) < 0.12))[0]
        for j in hit.tolist():
            q = (int(rng.integers(0, R)), int(pt[j]))
            while q in set(zip(node.tolist(), t.tolist())):
                q = (int(rng.integers(0, R)), int(pt[j]))
            pn[j] = q[0]
            for _ in range(int(rng.integers(0, 4))):
                if q in extra or rng.random() < 0.3 or q[1] < 1:
                    break
                p = (int(rng.integers(0, R)), int(q[1] - rng.integers(1, 3)))
                extra[q] = (-10.0 * (q[1] + 1) - float(rng.integers(0, 4)),
                            p[0], max(p[1], 0))
                q = (p[0], max(p[1], 0))
    return ((node.astype(np.int64), t.astype(np.int64), s.astype(np.float64),
             pn.astype(np.int64), pt.astype(np.int64)), extra)


def _slf(lat):
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.lat")
        (jslf.write_slf if isinstance(lat, jslf.Lattice) else write_slf)(
            lat, p)
        with open(p, "rb") as f:
            return f.read()


CASES = [(lm, preds, beam, False) for lm in ("dense", "backoff", "trigram")
         for preds in (1, 2, 8) for beam in (None, 250.0)]
CASES += [(lm, preds, 250.0, True) for lm in ("dense", "backoff", "trigram")
          for preds in (1, 8)]


@pytest.mark.parametrize("lm,max_preds,arc_beam,resolve", CASES)
def test_columnar_walk_equals_the_dict_walk(lm, max_preds, arc_beam,
                                            resolve):
    seed = CASES.index((lm, max_preds, arc_beam, resolve))
    rng = np.random.default_rng(seed)
    net = _net(lm, rng)
    cols, extra = _records(rng, missing=resolve)
    # the reference's dict: the last value of a key at its first place
    rec = dict(zip(zip(cols[0].tolist(), cols[1].tolist()),
                   zip(cols[2].tolist(), cols[3].tolist(),
                       cols[4].tolist())))
    keep = pdec._dict_order(cols[0] * pdec._REC_PK + (cols[1] + 2))
    cols = tuple(c[keep] for c in cols)
    assert [tuple(x) for x in zip(*(c.tolist() for c in cols))] == [
        (i, t) + v for (i, t), v in rec.items()]

    def resolve_one(pn, pt):
        return extra.get((pn, pt))

    def resolve_cols(pn, pt):
        got = [extra.get(q, (LZERO, -1, -1))
               for q in zip(pn.tolist(), pt.tolist())]
        s, a, c = (np.array(x) for x in zip(*got))
        return s.astype(np.float64), a.astype(np.int64), c.astype(np.int64)

    kw = dict(max_preds=max_preds, arc_beam=arc_beam)
    ref = jdec._lattice_from_rec(net, dict(rec), resolve_one, T, 0.01,
                                 LM_SCALE, PEN, **kw)
    with metrics.recording():
        got = pdec._lattice_from_rec(
            net, cols, T, 0.01, LM_SCALE, PEN,
            resolve=resolve_cols if resolve else None, **kw)
        names = {r.name for r in metrics.RECORDER.records}
    assert "htk.lattice.views" not in names
    assert got._columns is not None and "arcs" not in vars(got)
    slf = _slf(got)
    assert slf == _slf(ref) and got._columns is not None
    assert [(n.id, n.time, n.word) for n in got.nodes] == [
        (n.id, n.time, n.word) for n in ref.nodes]
    assert [(a.id, a.start, a.end, a.aclike, a.lmlike) for a in got.arcs] == [
        (a.id, a.start, a.end, a.aclike, a.lmlike) for a in ref.arcs]
    assert got._columns is None and _slf(got) == slf
    n_alt = len(ref.arcs) - len(jdec._lattice_from_rec(
        net, dict(rec), resolve_one, T, 0.01, LM_SCALE, PEN,
        arc_beam=arc_beam).arcs)
    if max_preds > 1:
        assert n_alt > 50  # the alternatives are exercised
    if resolve:
        assert len(got.nodes) > len(rec) + 2  # some came back
