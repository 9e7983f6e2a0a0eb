"""LBuild — n-gram language model construction.

Mirrors `HLMTools/LBuild` (+ LGBase/LPCalc roles): counts n-grams from
word-level text/MLF data and builds a back-off LM in ARPA format with
Good-Turing or absolute discounting.

Usage: LBuild [options] wordMap outLM trainFiles...

  -n N     LM order (1-4, default 2)
  -c N     count cutoff threshold (default 1)
  -d s     discount scheme: GT (Good-Turing) | ABS (absolute, default)
  -a f     absolute discount constant (default 0.5)
  -u f     unigram floor count (default 1)
  Standard: -A -C -D -S -T -V

The word map argument accepts either an HLM word-map file or a plain word
list; words outside it still count (closed-vocab filtering is LSubset's
job, kept simple here).

Copied from `htk_tpu/tools/lbuild.py` into the PyTorch port: host code,
behaviour unchanged. The gram-file reader it uses (`is_gram_file`,
`read_gram`) is copied beside it from `htk_tpu/tools/lgram.py`. The port
cannot use htk_tpu, whose utils package pulls in JAX.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Tuple

from ..io.lm import LN10, NGramLM, save_lm
from ..io.mlf import MLF
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, contained

USAGE = "Usage: LBuild [options] wordMap outLM trainFiles..."

OPTS = {
    "n": Option("n", 1, "LM order", typ=int),
    "c": Option("c", 1, "count cutoff", typ=int),
    "d": Option("d", 1, "discount scheme"),
    "a": Option("a", 1, "absolute discount", typ=float),
    "u": Option("u", 1, "unigram floor", typ=float),
}

ENTER, EXIT = "<s>", "</s>"


def read_sentences(path: str, cfg=None) -> List[List[str]]:
    first = open(path).readline().strip()
    if first == "#!MLF!#":
        m = MLF.load(path, cfg)
        return [[l.name for l in tr.labels] for _pat, tr in m.entries]
    sents = []
    for ln in open(path):
        ws = ln.split()
        if ws:
            sents.append(ws)
    return sents


def good_turing_discount(counts: Counter, max_r: int = 7):
    """Katz-style GT discount coefficients d_r for r < max_r (LPCalc)."""
    n_r = Counter(counts.values())
    d = {}
    for r in range(1, max_r):
        n1, nr, nr1 = n_r.get(1, 0), n_r.get(r, 0), n_r.get(r + 1, 0)
        nk = n_r.get(max_r, 0)
        if nr == 0 or n1 == 0:
            d[r] = 1.0
            continue
        # Katz: d_r = (r*_r/r - k)/(1-k), r* = (r+1) n_{r+1}/n_r
        k = (max_r * nk) / n1 if n1 else 0.0
        rstar = (r + 1) * nr1 / nr
        denom = 1.0 - k
        d[r] = max(((rstar / r) - k) / denom, 1e-3) if denom > 0 else 1.0
    return d


def count_ngrams(sents, order=2):
    """(uni, bi, tri, four) Counters over boundary-wrapped sentences."""
    uni = Counter()
    bi = Counter()
    tri = Counter()
    four = Counter()
    for s in sents:
        seq = [ENTER] + s + [EXIT]
        for w in seq:
            uni[w] += 1
        for a, b in zip(seq, seq[1:]):
            bi[(a, b)] += 1
        if order >= 3:
            for a, b, c in zip(seq, seq[1:], seq[2:]):
                tri[(a, b, c)] += 1
        if order >= 4:
            for a, b, c, d in zip(seq, seq[1:], seq[2:], seq[3:]):
                four[(a, b, c, d)] += 1
    return uni, bi, tri, four


def build_lm(sents, order=2, cutoff=1, scheme="ABS", disc=0.5, ufloor=1.0):
    uni, bi, tri, four = count_ngrams(sents, order)
    return build_lm_from_counts(uni, bi, tri, four, order=order,
                                cutoff=cutoff, scheme=scheme, disc=disc,
                                ufloor=ufloor)


def build_lm_from_counts(uni, bi, tri, four, order=2, cutoff=1,
                         scheme="ABS", disc=0.5, ufloor=1.0):
    """Back-off LM from n-gram count tables (the LPCalc role; counts may
    come from counting text directly or from LGPrep/LGCopy gram files)."""
    lm = NGramLM(order=order)
    tot = sum(max(c, ufloor) for c in uni.values())
    uni_p = {w: max(c, ufloor) / tot for w, c in uni.items()}

    gt_bi = good_turing_discount(bi) if scheme == "GT" else None

    def disc_count(c, gt):
        if scheme == "GT":
            return c * gt.get(c, 1.0) if c < 7 else float(c)
        return max(c - disc, 0.0)

    if order >= 2:
        for w1 in uni:
            c1 = uni[w1]
            pairs = [(w2, c) for (a, w2), c in bi.items()
                     if a == w1 and c >= cutoff]
            mass = 0.0
            for w2, c in pairs:
                mass += disc_count(c, gt_bi) / c1
            seen = {w2 for w2, _ in pairs}
            unseen = sum(p for w, p in uni_p.items() if w not in seen)
            alpha = max((1.0 - mass), 1e-10) / max(unseen, 1e-10)
            lm.unigrams[w1] = (math.log(uni_p[w1]), math.log(max(alpha, 1e-10)))
            for w2, c in pairs:
                p = disc_count(c, gt_bi) / c1
                lm.bigrams[(w1, w2)] = (math.log(max(p, 1e-10)), 0.0)
    for w in uni:
        if w not in lm.unigrams:
            lm.unigrams[w] = (math.log(uni_p[w]), 0.0)

    if order >= 3:
        gt_tri = good_turing_discount(tri) if scheme == "GT" else None
        for (w1, w2), c12 in bi.items():
            trips = [(w3, c) for (a, b, w3), c in tri.items()
                     if a == w1 and b == w2 and c >= cutoff]
            if not trips:
                continue
            mass = 0.0
            for w3, c in trips:
                mass += disc_count(c, gt_tri) / c12
            seen = {w3 for w3, _ in trips}
            unseen = sum(
                math.exp(lm.logp_bi(w2, w)) for w in uni if w not in seen
            )
            alpha = max(1.0 - mass, 1e-10) / max(unseen, 1e-10)
            p_bi, _ = lm.bigrams.get((w1, w2), (None, None))
            if p_bi is not None:
                lm.bigrams[(w1, w2)] = (p_bi, math.log(max(alpha, 1e-10)))
            for w3, c in trips:
                p = disc_count(c, gt_tri) / c12
                lm.trigrams[(w1, w2, w3)] = math.log(max(p, 1e-10))

    if order >= 4:
        gt_4 = good_turing_discount(four) if scheme == "GT" else None
        for (w1, w2, w3), c123 in tri.items():
            quads = [(w4, c) for (a, b, d, w4), c in four.items()
                     if a == w1 and b == w2 and d == w3 and c >= cutoff]
            if not quads:
                continue
            mass = 0.0
            for w4, c in quads:
                mass += disc_count(c, gt_4) / c123
            seen = {w4 for w4, _ in quads}
            unseen = sum(
                math.exp(lm.logp_tri(w2, w3, w)) for w in uni if w not in seen
            )
            alpha = max(1.0 - mass, 1e-10) / max(unseen, 1e-10)
            if (w1, w2, w3) in lm.trigrams:
                lm.tri_bo[(w1, w2, w3)] = math.log(max(alpha, 1e-10))
            for w4, c in quads:
                p = disc_count(c, gt_4) / c123
                lm.fourgrams[(w1, w2, w3, w4)] = math.log(max(p, 1e-10))
    return lm


def is_gram_file(path: str) -> bool:
    try:
        with open(path) as f:
            return f.readline().startswith("!Ngram")
    except OSError:
        return False


def read_gram(path: str) -> Tuple[int, Counter]:
    with open(path, errors="replace") as f:
        head = f.readline()
        if not head.startswith("!Ngram"):
            HError(16110, "read_gram: %s is not a gram file", path)
        with contained(16111, "read_gram", path):
            order = int(head.split("=", 1)[1])
            counts: Counter = Counter()
            for ln in f:
                parts = ln.split()
                if len(parts) == order + 1:
                    counts[tuple(parts[:order])] += int(parts[order])
    return order, counts


def run(argv: List[str]) -> int:
    ta = parse_args("LBuild", argv, OPTS, min_args=2, usage=USAGE)
    out_lm = ta.args[1]
    files = ta.args[2:] + ta.script
    if not files:
        HError(1030, "LBuild: no training text\n%s", USAGE)
    order = int(ta.get("n", 2) or 2)
    kw = dict(order=order, cutoff=int(ta.get("c", 1) or 1),
              scheme=(ta.get("d", "ABS") or "ABS").upper(),
              disc=float(ta.get("a", 0.5) or 0.5),
              ufloor=float(ta.get("u", 1.0) or 1.0))
    n_in = "?"
    if all(is_gram_file(f) for f in files):
        # LGPrep/LGCopy gram-file inputs: merge count tables by order
        tabs = {1: Counter(), 2: Counter(), 3: Counter(), 4: Counter()}
        for f in files:
            o, counts = read_gram(f)
            tabs[o].update(counts)
        uni = Counter({k[0]: v for k, v in tabs[1].items()})
        lm = build_lm_from_counts(uni, tabs[2], tabs[3], tabs[4], **kw)
        n_in = f"{len(files)} gram files"
    else:
        sents = []
        for f in files:
            sents.extend(read_sentences(f, ta.config))
        lm = build_lm(sents, **kw)
        n_in = f"{len(sents)} sentences"
    save_lm(lm, out_lm, ta.config)
    if ta.trace:
        print(f"LBuild: {n_in} -> {len(lm.unigrams)} 1-grams, "
              f"{len(lm.bigrams)} 2-grams, {len(lm.trigrams)} 3-grams")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
