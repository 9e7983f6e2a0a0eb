"""Word-lattice operations: best path, posteriors, pruning.

Mirrors `HTKLib/HLat.c` (LatFindBest/LatPrune + the forward-backward that
HFBLat runs at lattice level): plain DAG dynamic programming over arcs in
topological order. Host-side — lattices are thousands of arcs at most;
the heavy per-arc acoustics run on device elsewhere.

Arc score = aclike + lmscale * lmlike + wdpenalty (penalty applied to
arcs that terminate a word instance, i.e. whose end node carries a word).

Copied from `htk_tpu/algo/latops.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.slf import Lattice, LArc, LNode, NULL_WORD
from ..utils.errors import HError
from ..utils.logmath import LZERO

NEG = -1.0e30


def topo_order(lat: Lattice) -> List[int]:
    """Topological node order (Kahn); errors on cycles (8253)."""
    n_in: Dict[int, int] = {n.id: 0 for n in lat.nodes}
    out: Dict[int, List[LArc]] = {n.id: [] for n in lat.nodes}
    for a in lat.arcs:
        n_in[a.end] += 1
        out[a.start].append(a)
    queue = [nid for nid, c in n_in.items() if c == 0]
    order = []
    while queue:
        nid = queue.pop()
        order.append(nid)
        for a in out[nid]:
            n_in[a.end] -= 1
            if n_in[a.end] == 0:
                queue.append(a.end)
    if len(order) != len(lat.nodes):
        HError(8253, "topo_order: lattice contains a cycle")
    return order


def _arc_score(lat: Lattice, a: LArc, words_of: Dict[int, Optional[str]],
               lmscale: float, wdpenalty: float, acscale: float = 1.0) -> float:
    s = acscale * a.aclike + lmscale * a.lmlike
    w = a.word if a.word is not None else words_of.get(a.end)
    if w and w != NULL_WORD:
        s += wdpenalty
    return s


def best_path(lat: Lattice, lmscale: Optional[float] = None,
              wdpenalty: Optional[float] = None):
    """1-best path; returns (score, [(word, time, arc)] in order)."""
    lmscale = lat.lmscale if lmscale is None else lmscale
    wdpenalty = lat.wdpenalty if wdpenalty is None else wdpenalty
    words_of = {n.id: n.word for n in lat.nodes}
    order = topo_order(lat)
    start = lat.start_node()
    end = lat.end_node()
    score: Dict[int, float] = {n.id: NEG for n in lat.nodes}
    back: Dict[int, Optional[LArc]] = {n.id: None for n in lat.nodes}
    score[start] = 0.0
    in_arcs: Dict[int, List[LArc]] = {n.id: [] for n in lat.nodes}
    for a in lat.arcs:
        in_arcs[a.end].append(a)
    for nid in order:
        for a in in_arcs[nid]:
            s = score[a.start] + _arc_score(lat, a, words_of, lmscale, wdpenalty)
            if s > score[nid]:
                score[nid] = s
                back[nid] = a
    if score[end] <= NEG / 2:
        return NEG, []
    path = []
    nid = end
    while back[nid] is not None:
        a = back[nid]
        w = a.word if a.word is not None else words_of.get(a.end)
        t = next(n.time for n in lat.nodes if n.id == a.end)
        if w and w != NULL_WORD:
            path.append((w, t, a))
        nid = a.start
    path.reverse()
    return score[end], path


def arc_posteriors(lat: Lattice, lmscale: Optional[float] = None,
                   wdpenalty: Optional[float] = None, acscale: float = 1.0):
    """Log posterior per arc via DAG forward-backward (logsumexp semiring).

    Returns (total_logp, {arc_id: log gamma_a}).
    """
    lmscale = lat.lmscale if lmscale is None else lmscale
    wdpenalty = lat.wdpenalty if wdpenalty is None else wdpenalty
    words_of = {n.id: n.word for n in lat.nodes}
    order = topo_order(lat)
    start = lat.start_node()
    end = lat.end_node()
    in_arcs: Dict[int, List[LArc]] = {n.id: [] for n in lat.nodes}
    out_arcs: Dict[int, List[LArc]] = {n.id: [] for n in lat.nodes}
    for a in lat.arcs:
        in_arcs[a.end].append(a)
        out_arcs[a.start].append(a)

    def lsum(vals):
        vals = [v for v in vals if v > NEG / 2]
        if not vals:
            return NEG
        hi = max(vals)
        return hi + math.log(sum(math.exp(v - hi) for v in vals))

    alpha: Dict[int, float] = {n.id: NEG for n in lat.nodes}
    alpha[start] = 0.0
    for nid in order:
        if in_arcs[nid]:
            alpha[nid] = lsum(
                [alpha[a.start]
                 + _arc_score(lat, a, words_of, lmscale, wdpenalty, acscale)
                 for a in in_arcs[nid]]
            )
    beta: Dict[int, float] = {n.id: NEG for n in lat.nodes}
    beta[end] = 0.0
    for nid in reversed(order):
        if out_arcs[nid]:
            beta[nid] = lsum(
                [beta[a.end]
                 + _arc_score(lat, a, words_of, lmscale, wdpenalty, acscale)
                 for a in out_arcs[nid]]
            )
    total = alpha[end]
    post = {}
    for a in lat.arcs:
        s = _arc_score(lat, a, words_of, lmscale, wdpenalty, acscale)
        post[a.id] = alpha[a.start] + s + beta[a.end] - total
    return total, post


def prune(lat: Lattice, beam: float, lmscale: Optional[float] = None,
          wdpenalty: Optional[float] = None) -> Lattice:
    """Posterior-beam pruning (HLat.c LatPrune role)."""
    total, post = arc_posteriors(lat, lmscale, wdpenalty)
    keep_arcs = [a for a in lat.arcs if post[a.id] >= -beam]
    used = {a.start for a in keep_arcs} | {a.end for a in keep_arcs}
    out = Lattice(
        nodes=[n for n in lat.nodes if n.id in used],
        arcs=keep_arcs,
        utterance=lat.utterance,
        lmscale=lat.lmscale,
        wdpenalty=lat.wdpenalty,
    )
    return out


def arc_mpe_weights(lat: Lattice, ref: List[Tuple[str, float, float]],
                    lmscale: Optional[float] = None,
                    wdpenalty: Optional[float] = None,
                    null_words=(), acscale: float = 1.0):
    """MPE/MWE arc weights gamma_q * (c(q) - c_avg) (HFBLat.c role).

    `ref` is the timed reference: [(word, t_start_s, t_end_s)]. Per-arc
    raw accuracy follows Povey's overlap approximation at the word level
    (MWE):  a(q) = max over ref words z of
              -1 + 2*e(q,z)  if word(q) == word(z)   else  -1 + e(q,z)
    with e the fractional time overlap of z covered by q. Expected
    accuracies c(q) propagate through the DAG with posterior-weighted
    forward/backward averages; c_avg is the lattice's expected accuracy.
    Positive weights feed numerator accumulators, negative the denominator
    (the standard MPE split).
    """
    lmscale = lat.lmscale if lmscale is None else lmscale
    wdpenalty = lat.wdpenalty if wdpenalty is None else wdpenalty
    words_of = {nd.id: nd.word for nd in lat.nodes}
    times_of = {nd.id: nd.time for nd in lat.nodes}
    total, post = arc_posteriors(lat, lmscale, wdpenalty, acscale=acscale)
    order = topo_order(lat)
    start = lat.start_node()
    end = lat.end_node()
    in_arcs: Dict[int, List[LArc]] = {nd.id: [] for nd in lat.nodes}
    out_arcs: Dict[int, List[LArc]] = {nd.id: [] for nd in lat.nodes}
    for a in lat.arcs:
        in_arcs[a.end].append(a)
        out_arcs[a.start].append(a)

    def raw_acc(a: LArc) -> float:
        w = a.word if a.word is not None else words_of.get(a.end)
        if not w or w == NULL_WORD or w in null_words:
            return 0.0  # silence/null arcs neither score nor cost (Povey)
        t0, t1 = times_of[a.start], times_of[a.end]
        best = -1.0
        for rw, r0, r1 in ref:
            dur = max(r1 - r0, 1e-6)
            ov = max(0.0, min(t1, r1) - max(t0, r0)) / dur
            v = (-1.0 + 2.0 * ov) if rw == w else (-1.0 + ov)
            best = max(best, v)
        return best

    # forward expected accuracy: fa(node) = posterior-weighted average of
    # fa(pred) + a(arc) over incoming arcs (weights = arc posteriors)
    fa: Dict[int, float] = {start: 0.0}
    for nid in order:
        if nid == start or not in_arcs[nid]:
            fa.setdefault(nid, 0.0)
            continue
        num = 0.0
        den = 0.0
        for a in in_arcs[nid]:
            g = math.exp(min(post[a.id], 0.0))
            num += g * (fa.get(a.start, 0.0) + raw_acc(a))
            den += g
        fa[nid] = num / max(den, 1e-10)
    ba: Dict[int, float] = {end: 0.0}
    for nid in reversed(order):
        if nid == end or not out_arcs[nid]:
            ba.setdefault(nid, 0.0)
            continue
        num = 0.0
        den = 0.0
        for a in out_arcs[nid]:
            g = math.exp(min(post[a.id], 0.0))
            num += g * (ba.get(a.end, 0.0) + raw_acc(a))
            den += g
        ba[nid] = num / max(den, 1e-10)

    c_avg = fa.get(end, 0.0)
    weights = {}
    for a in lat.arcs:
        g = math.exp(min(post[a.id], 0.0))
        c_q = fa.get(a.start, 0.0) + raw_acc(a) + ba.get(a.end, 0.0)
        weights[a.id] = g * (c_q - c_avg)
    return weights, c_avg


def nbest_paths(lat: Lattice, n: int, lmscale: Optional[float] = None,
                wdpenalty: Optional[float] = None):
    """Top-n distinct paths through a lattice (HVite -n via lattice).

    DAG N-best DP: each node keeps its top-n (score, pred, pred_rank, arc)
    entries in topological order. Returns a list of
    (score, [(word, time)]) best-first. Paths with identical word
    sequences are deduplicated (HTK reports distinct sentences).
    """
    lmscale = lat.lmscale if lmscale is None else lmscale
    wdpenalty = lat.wdpenalty if wdpenalty is None else wdpenalty
    words_of = {nd.id: nd.word for nd in lat.nodes}
    times_of = {nd.id: nd.time for nd in lat.nodes}
    order = topo_order(lat)
    start = lat.start_node()
    end = lat.end_node()
    in_arcs: Dict[int, List[LArc]] = {nd.id: [] for nd in lat.nodes}
    for a in lat.arcs:
        in_arcs[a.end].append(a)

    # entries[node] = list of (score, pred_node, pred_rank, arc)
    entries: Dict[int, List[Tuple[float, int, int, Optional[LArc]]]] = {
        nd.id: [] for nd in lat.nodes
    }
    entries[start] = [(0.0, -1, -1, None)]
    for nid in order:
        if nid == start:
            continue
        cands = []
        for a in in_arcs[nid]:
            s_arc = _arc_score(lat, a, words_of, lmscale, wdpenalty)
            for rank, (s, _p, _r, _a) in enumerate(entries[a.start]):
                cands.append((s + s_arc, a.start, rank, a))
        cands.sort(key=lambda t: -t[0])
        entries[nid] = cands[: n * 4]  # slack before dedup

    out = []
    seen = set()
    for s, p, r, a in entries[end]:
        # backtrack this entry
        words = []
        cur_arc, pn, pr = a, p, r
        while cur_arc is not None:
            w = cur_arc.word if cur_arc.word is not None else words_of.get(
                cur_arc.end)
            if w and w != NULL_WORD:
                words.append((w, times_of[cur_arc.end]))
            s2, p2, r2, a2 = entries[pn][pr]
            cur_arc, pn, pr = a2, p2, r2
        words.reverse()
        key = tuple(w for w, _t in words)
        if key in seen:
            continue
        seen.add(key)
        out.append((s, words))
        if len(out) >= n:
            break
    return out


def best_path_trigram(lat: Lattice, lm, lmscale: float = 1.0,
                      wdpenalty: float = 0.0,
                      sent_start: str = "!ENTER"):
    """Exact trigram best path over a word-on-nodes lattice.

    DP over *arcs* (an arc fixes the last two word contexts when words
    sit on nodes), the second pass of the HDecode two-pass architecture:
    wide-beam bigram search produces the lattice, this walks it with the
    full trigram. Returns (score, [(word, time)]).
    """
    words_of = {n.id: n.word for n in lat.nodes}
    times_of = {n.id: n.time for n in lat.nodes}
    order = topo_order(lat)
    pos = {nid: i for i, nid in enumerate(order)}
    start = lat.start_node()
    end = lat.end_node()

    def word_at(nid):
        w = words_of.get(nid)
        return None if (w is None or w == NULL_WORD) else w

    in_arcs: Dict[int, List[LArc]] = {n.id: [] for n in lat.nodes}
    for a in lat.arcs:
        in_arcs[a.end].append(a)

    # contexts repeat heavily across arcs: memoise the back-off chase
    tri_memo: Dict[tuple, float] = {}

    def tri(c2, c1, w):
        k = (c2, c1, w)
        v = tri_memo.get(k)
        if v is None:
            v = tri_memo[k] = lm.logp_tri(c2, c1, w)
        return v

    # arc-state DP: score[arc.id], back[arc.id]
    score: Dict[int, float] = {}
    back: Dict[int, Optional[int]] = {}
    ctx1: Dict[int, str] = {}  # last word after traversing this arc
    ctx2: Dict[int, str] = {}  # word before that
    arcs_by_end_pos = sorted(lat.arcs, key=lambda a: pos[a.end])
    for a in arcs_by_end_pos:
        w = word_at(a.end)
        preds = in_arcs[a.start]
        cands = []
        # the sentence-start word itself (<s> as a silence-pron node,
        # HDecode STARTWORD) carries no LM probability — it IS the
        # context; looking up P(<s>|...) would apply ARPA's -99 sentinel
        if a.start == start or not preds:
            c2, c1 = sent_start, sent_start
            lmp = (0.0 if w == sent_start
                   else tri(c2, c1, w)) if w else 0.0
            s = a.aclike + lmscale * lmp + (wdpenalty if w else 0.0)
            cands.append((s, None, c1 if not w else w, c1))
        for p in preds:
            if p.id not in score:
                continue
            c1, c2 = ctx1[p.id], ctx2[p.id]
            lmp = (0.0 if w == sent_start
                   else tri(c2, c1, w)) if w else 0.0
            s = score[p.id] + a.aclike + lmscale * lmp + (wdpenalty if w else 0.0)
            cands.append((s, p.id, w if w else c1, c1 if w else c2))
        if not cands:
            continue
        s, b, n1, n2 = max(cands, key=lambda t: t[0])
        score[a.id] = s
        back[a.id] = b
        ctx1[a.id] = n1
        ctx2[a.id] = n2

    finals = [a for a in lat.arcs if a.end == end and a.id in score]
    if not finals:
        return NEG, []
    best = max(finals, key=lambda a: score[a.id])
    path = []
    aid = best.id
    arcs_by_id = {a.id: a for a in lat.arcs}
    while aid is not None:
        a = arcs_by_id[aid]
        w = word_at(a.end)
        if w:
            path.append((w, times_of[a.end]))
        aid = back[aid]
    path.reverse()
    return score[best.id], path


def best_path_4gram(lat: Lattice, lm, lmscale: float = 1.0,
                    wdpenalty: float = 0.0,
                    sent_start: str = "!ENTER"):
    """Exact 4-gram best path over a word-on-nodes lattice.

    best_path_trigram's arc-state DP carries an exact 2-word history
    per arc (the arc fixes the last two words); a 4-gram needs three,
    so states split by the extra history word: one DP state per
    (arc, word-3-back). State count is bounded by each arc's
    grandparent word diversity (small under HDECODE: LATPREDS).
    Beyond-reference capability: `HTKLVRec` rescoring stops at
    trigram; HDecode here picks this rescorer automatically when the
    ARPA carries 4-grams. Returns (score, [(word, time)])."""
    words_of = {n.id: n.word for n in lat.nodes}
    times_of = {n.id: n.time for n in lat.nodes}
    order = topo_order(lat)
    pos = {nid: i for i, nid in enumerate(order)}
    start = lat.start_node()
    end = lat.end_node()

    def word_at(nid):
        w = words_of.get(nid)
        return None if (w is None or w == NULL_WORD) else w

    in_arcs: Dict[int, List[LArc]] = {n.id: [] for n in lat.nodes}
    for a in lat.arcs:
        in_arcs[a.end].append(a)

    memo: Dict[tuple, float] = {}

    def p4(c3, c2, c1, w):
        k = (c3, c2, c1, w)
        v = memo.get(k)
        if v is None:
            v = memo[k] = lm.logp_4(c3, c2, c1, w)
        return v

    # state = (arc id, (c1, c2, c3) history after the arc); Viterbi
    # over states, exact in the 3-word context
    score: Dict[tuple, float] = {}
    back: Dict[tuple, Optional[tuple]] = {}
    states_of: Dict[int, list] = {}
    arcs_by_end_pos = sorted(lat.arcs, key=lambda a: pos[a.end])
    for a in arcs_by_end_pos:
        w = word_at(a.end)
        preds = in_arcs[a.start]
        cands = []  # (score, back_state, (c1, c2, c3))
        if a.start == start or not preds:
            c1 = c2 = c3 = sent_start
            lmp = (0.0 if w == sent_start
                   else p4(c3, c2, c1, w)) if w else 0.0
            s = a.aclike + lmscale * lmp + (wdpenalty if w else 0.0)
            nctx = (w, c1, c2) if w else (c1, c2, c3)
            cands.append((s, None, nctx))
        for p in preds:
            for st in states_of.get(p.id, ()):
                c1, c2, c3 = st[1]
                lmp = (0.0 if w == sent_start
                       else p4(c3, c2, c1, w)) if w else 0.0
                s = (score[st] + a.aclike + lmscale * lmp
                     + (wdpenalty if w else 0.0))
                nctx = (w, c1, c2) if w else (c1, c2, c3)
                cands.append((s, st, nctx))
        for s, b, nctx in cands:
            st = (a.id, nctx)
            if st in score and score[st] >= s:
                continue
            if st not in score:
                states_of.setdefault(a.id, []).append(st)
            score[st] = s
            back[st] = b

    arcs_by_id = {a.id: a for a in lat.arcs}
    finals = [st for st in score if arcs_by_id[st[0]].end == end]
    if not finals:
        return NEG, []
    bst = max(finals, key=lambda st: score[st])
    path = []
    st = bst
    while st is not None:
        a = arcs_by_id[st[0]]
        w = word_at(a.end)
        if w:
            path.append((w, times_of[a.end]))
        st = back[st]
    path.reverse()
    return score[bst], path


def apply_lm(lat: Lattice, lm, context: int = 2) -> Lattice:
    """Replace arc LM scores with a new n-gram LM (HLRescore -n role).

    Bigram only in this round: each word arc's lmlike becomes
    ln P(word(end) | word(prev)) where prev is the nearest word on the
    best-known left context — exact for lattices whose nodes carry a
    single word (HVite output), since the predecessor node determines
    the context. [LC] Trigram expansion is a later round.
    """
    words_of = {n.id: n.word for n in lat.nodes}
    for a in lat.arcs:
        w2 = a.word if a.word is not None else words_of.get(a.end)
        if not w2 or w2 == NULL_WORD:
            continue
        w1 = words_of.get(a.start)
        if w1 is None or w1 == NULL_WORD:
            w1 = "!ENTER"
        a.lmlike = lm.logp_bi(w1, w2)
    return lat


def oracle_error(lat: Lattice, ref: List[str],
                 ignore: tuple = ("", NULL_WORD)) -> Tuple[int, int]:
    """Lattice oracle word-error count: the minimum edit distance
    between the reference and ANY path through the lattice.

    DP over (node, ref position) in topological order with unit
    sub/ins/del costs — the lattice-quality metric (`HTKLib/HLat.c`'s
    analysis role; used by the beam-sweep harness to quantify how much
    the pass-1 beams bound the pass-2 approximation). Returns
    (min_errors, len(ref)); words in `ignore` (and None) are
    transparent.
    """
    order = topo_order(lat)
    words_of = {n.id: n.word for n in lat.nodes}
    out: Dict[int, List[LArc]] = {n.id: [] for n in lat.nodes}
    n_in = {n.id: 0 for n in lat.nodes}
    for a in lat.arcs:
        out[a.start].append(a)
        n_in[a.end] += 1
    R = len(ref)
    INF = 1 << 30
    # cost[nid][j] = best errors reaching nid having consumed ref[:j]
    cost: Dict[int, List[int]] = {
        nid: list(range(R + 1))  # start: ref prefix deleted
        for nid in order if n_in[nid] == 0
    }
    ends = [nid for nid in order if not out[nid]]
    for nid in order:
        cur = cost.get(nid)
        if cur is None:
            continue
        # deletions: skip ref words at this node
        for j in range(1, R + 1):
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        for a in out[nid]:
            w = a.word if a.word is not None else words_of.get(a.end)
            nxt = cost.setdefault(a.end, [INF] * (R + 1))
            if w is None or w in ignore:
                for j in range(R + 1):
                    if cur[j] < nxt[j]:
                        nxt[j] = cur[j]
            else:
                for j in range(R + 1):
                    # insertion: hypothesis word consumes no ref
                    if cur[j] + 1 < nxt[j]:
                        nxt[j] = cur[j] + 1
                    if j < R:
                        c = cur[j] + (0 if w == ref[j] else 1)
                        if c < nxt[j + 1]:
                            nxt[j + 1] = c
    best = INF
    for nid in ends:
        arr = cost.get(nid)
        if arr is not None:
            # remaining ref words are deletions
            for j in range(R + 1):
                best = min(best, arr[j] + (R - j))
    return best, R
