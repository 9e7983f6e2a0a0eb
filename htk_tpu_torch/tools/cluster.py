"""Cluster — word-class construction for class n-gram LMs.

Mirrors `HLMTools/Cluster`: the exchange algorithm moves words between
classes to maximise the class-bigram training likelihood

    L = sum_{c1,c2} N(c1,c2) log N(c1,c2)  -  2 sum_c N(c) log N(c)

(the word-emission term sum_w N(w) log N(w) is invariant under the
assignment). Sentence boundary tokens are pinned to singleton classes.
Outputs a class-map file and, with -p, a word-level bigram ARPA LM
expanded from the class LM:  p(w2|w1) = p(C(w2)|C(w1)) p(w2|C(w2)) —
directly consumable by LPlex / HDecode. Class-map layout is this
framework's own (HLM cmap byte layout needs the reference). [LC]

Usage: Cluster [options] wordMap outClassMap trainFiles...

  -c N     number of classes (default 20)
  -i N     exchange iterations over the vocabulary (default 2)
  -p f     also write the expanded word-bigram ARPA LM to f
  Standard: -A -C -D -S -T -V

Copied from `htk_tpu/tools/cluster.py` into the PyTorch port: host code,
behaviour unchanged.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List

from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError
from .lbuild import ENTER, EXIT, read_sentences

USAGE = "Usage: Cluster [options] wordMap outClassMap trainFiles..."

OPTS = {
    "c": Option("c", 1, "number of classes", typ=int),
    "i": Option("i", 1, "exchange iterations", typ=int),
    "p": Option("p", 1, "write expanded word-bigram ARPA"),
}


def _f(x: float) -> float:
    return x * math.log(x) if x > 0 else 0.0


def _delta_move(w, a, b, cls, Ncc, Nc, succ_w, pred_w, self_n,
                unigrams, total):
    """Exact likelihood change of moving w from class a to b.

    Moving w changes rows a/b of the class bigram table by w's
    successor-class counts, columns a/b by its predecessor-class counts,
    and the four corner cells by both plus the self bigram."""
    nw = unigrams[w]
    sw = Counter()
    pw = Counter()
    for w2, n in succ_w[w].items():
        sw[cls[w2]] += n
    for w1, n in pred_w[w].items():
        pw[cls[w1]] += n
    sn = self_n.get(w, 0)

    # new-value table for every affected cell, applied exactly once
    delta_cells = Counter()
    for c, n in sw.items():
        delta_cells[(a, c)] -= n
        delta_cells[(b, c)] += n
    for c, n in pw.items():
        delta_cells[(c, a)] -= n
        delta_cells[(c, b)] += n
    if sn:
        delta_cells[(a, a)] -= sn
        delta_cells[(b, b)] += sn
    # moving w re-homes its own row/col: cells (a, c) with the part of
    # sw/pw that lands in rows/cols a or b are already covered above;
    # what remains is that w's predecessors/successors in class a/b keep
    # their OWN class — handled because sw/pw are over neighbour classes.
    d = 0.0
    for (i, j), dv in delta_cells.items():
        old = Ncc[i][j]
        d += _f(old + dv) - _f(old)
    d -= 2.0 * (_f(Nc[a] - nw) - _f(Nc[a]) + _f(Nc[b] + nw) - _f(Nc[b]))
    return d


def exchange_cluster(bigrams: Counter, unigrams: Counter, n_classes: int,
                     pinned=(ENTER, EXIT), iters: int = 2, trace: int = 0):
    """Exchange clustering; returns {word: class_id} with pinned tokens in
    their own trailing singleton classes."""
    words = [w for w, _ in unigrams.most_common() if w not in pinned]
    pins = [w for w in pinned if w in unigrams]
    C = max(1, min(n_classes, max(1, len(words))))
    total = C + len(pins)

    cls: Dict[str, int] = {w: k % C for k, w in enumerate(words)}
    for j, w in enumerate(pins):
        cls[w] = C + j

    # per-word successor/predecessor class-count views
    succ_w: Dict[str, Counter] = defaultdict(Counter)
    pred_w: Dict[str, Counter] = defaultdict(Counter)
    self_n: Dict[str, int] = defaultdict(int)
    for (w1, w2), n in bigrams.items():
        if w1 == w2:
            self_n[w1] += n
        else:
            succ_w[w1][w2] += n
            pred_w[w2][w1] += n

    Ncc = [[0.0] * total for _ in range(total)]
    Nc = [0.0] * total
    for (w1, w2), n in bigrams.items():
        Ncc[cls[w1]][cls[w2]] += n
    for w, n in unigrams.items():
        Nc[cls[w]] += n

    def delta_move(w: str, a: int, b: int) -> float:
        return _delta_move(w, a, b, cls, Ncc, Nc, succ_w, pred_w,
                           self_n, unigrams, total)

    def apply_move(w: str, a: int, b: int) -> None:
        nw = unigrams[w]
        for w2, n in succ_w[w].items():
            Ncc[a][cls[w2]] -= n
            Ncc[b][cls[w2]] += n
        for w1, n in pred_w[w].items():
            Ncc[cls[w1]][a] -= n
            Ncc[cls[w1]][b] += n
        sn = self_n.get(w, 0)
        if sn:
            Ncc[a][a] -= sn
            Ncc[b][b] += sn
        Nc[a] -= nw
        Nc[b] += nw
        cls[w] = b

    for it in range(iters):
        moved = 0
        for w in words:
            a = cls[w]
            best_b, best_d = a, 0.0
            for b in range(C):
                if b == a:
                    continue
                d = delta_move(w, a, b)
                if d > best_d + 1e-9:
                    best_b, best_d = b, d
            if best_b != a:
                apply_move(w, a, best_b)
                moved += 1
        if trace:
            print(f"Cluster: pass {it + 1}, {moved} moves")
        if moved == 0:
            break
    return cls, total


def write_classmap(path: str, cls: Dict[str, int]) -> None:
    n = max(cls.values()) + 1 if cls else 0
    with open(path, "w") as f:
        f.write(f"<CLASSMAP> {n}\n")
        for w in sorted(cls):
            f.write(f"{w} CLASS{cls[w]}\n")


def read_classmap(path: str) -> Dict[str, int]:
    cls = {}
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) == 2 and parts[1].startswith("CLASS"):
                cls[parts[0]] = int(parts[1][5:])
    return cls


def class_bigram_arpa(path: str, cls: Dict[str, int], bigrams: Counter,
                      unigrams: Counter) -> None:
    """Expand the class bigram LM to a word-level ARPA bigram.

    p(w2|w1) = p(C2|C1) p(w2|C2), with add-0.5 smoothing on class
    bigrams and a unigram back-off layer p(w) = p(C) p(w|C)."""
    from ..io.lm import NGramLM, write_arpa

    total_cls = max(cls.values()) + 1
    Ncc = Counter()
    Nc = Counter()
    for (w1, w2), n in bigrams.items():
        Ncc[(cls[w1], cls[w2])] += n
    for w, n in unigrams.items():
        Nc[cls[w]] += n
    Ntok = sum(unigrams.values())

    def p_w_given_c(w):
        return unigrams[w] / max(Nc[cls[w]], 1)

    lm = NGramLM(order=2)
    for w in unigrams:
        p = (Nc[cls[w]] / Ntok) * p_w_given_c(w)
        # back-off weight 1 (ln 0): unseen bigrams fall to the unigram
        lm.unigrams[w] = (math.log(max(p, 1e-12)), math.log(1.0 + 1e-9))
    for w1 in unigrams:
        if w1 == EXIT:
            continue
        c1 = cls[w1]
        denom = Nc[c1] + 0.5 * total_cls
        for w2 in unigrams:
            if w2 == ENTER:
                continue
            c2 = cls[w2]
            nb = Ncc.get((c1, c2), 0)
            if nb == 0:
                continue  # back off to the unigram layer
            p = ((nb + 0.5) / denom) * p_w_given_c(w2)
            lm.bigrams[(w1, w2)] = (math.log(max(p, 1e-12)), 0.0)
    write_arpa(lm, path)


def run(argv: List[str]) -> int:
    ta = parse_args("Cluster", argv, OPTS, min_args=2, usage=USAGE)
    out_map = ta.args[1]
    files = ta.args[2:] + ta.script
    if not files:
        HError(1030, "Cluster: no training files\n%s", USAGE)

    bigrams: Counter = Counter()
    unigrams: Counter = Counter()
    for path in files:
        for sent in read_sentences(path, ta.config):
            seq = [ENTER] + sent + [EXIT]
            for w in seq:
                unigrams[w] += 1
            for w1, w2 in zip(seq, seq[1:]):
                bigrams[(w1, w2)] += 1
    if not bigrams:
        HError(16520, "Cluster: no training data")

    n_classes = int(ta.get("c", 20) or 20)
    iters = int(ta.get("i", 2) or 2)
    cls, total = exchange_cluster(bigrams, unigrams, n_classes,
                                  iters=iters, trace=ta.trace)
    write_classmap(out_map, cls)
    if ta.trace:
        print(f"Cluster: {len(cls)} words -> {total} classes -> {out_map}")
    if ta.has("p"):
        class_bigram_arpa(ta.get("p"), cls, bigrams, unigrams)
        if ta.trace:
            print(f"Cluster: wrote class-expanded bigram {ta.get('p')}")
    return 0


main = tool_main(run)


# -- LLink --------------------------------------------------------------------

LLINK_OPTS = {
    "o": Option("o", 1, "output word-level ARPA LM"),
}


def run_llink(argv: List[str]) -> int:
    """LLink — link a class map with fresh counts into a word-level LM
    (HLMTools/LLink: compose word-given-class with the class n-gram).

    Redesigned composition surface: instead of HLM's runtime composite
    class-LM container [LC — byte layout needs the reference], LLink
    recounts unigrams/bigrams from the given training text or gram
    files under an EXISTING class map (e.g. from Cluster, possibly
    built on a different corpus) and writes the expanded word-level
    bigram ARPA p(w2|w1) = p(C2|C1) p(w2|C2), which every LM consumer
    (LPlex, HBuild, HDecode) reads directly.
    """
    from .lgram import is_gram_file, read_gram

    ta = parse_args("LLink", argv, LLINK_OPTS, min_args=2,
                    usage="Usage: LLink [options] classmap trainFiles...")
    cls = read_classmap(ta.args[0])
    if not cls:
        HError(16510, "LLink: empty class map %s", ta.args[0])
    files = ta.args[1:] + ta.script
    unigrams: Counter = Counter()
    bigrams: Counter = Counter()
    for path in files:
        if is_gram_file(path):
            o, counts = read_gram(path)
            if o == 1:
                for g, c in counts.items():
                    unigrams[g[0]] += c
            elif o == 2:
                for g, c in counts.items():
                    bigrams[g] += c
            else:
                HError(16111, "LLink: gram order %d unsupported "
                       "(bigram class LMs)", o)
        else:
            for sent in read_sentences(path, ta.config):
                seq = [ENTER] + sent + [EXIT]
                for w in seq:
                    unigrams[w] += 1
                for w1, w2 in zip(seq, seq[1:]):
                    bigrams[(w1, w2)] += 1
    if not unigrams:
        HError(16520, "LLink: no counts in %s", " ".join(files))
    # words outside the class map join a catch-all class
    seen = set(unigrams)
    for w1, w2 in bigrams:
        seen.add(w1)
        seen.add(w2)
    unseen = [w for w in seen if w not in cls]
    if unseen:
        new_c = (max(cls.values()) + 1) if cls else 0
        for w in unseen:
            cls[w] = new_c
        if ta.trace:
            print(f"LLink: {len(unseen)} unmapped words -> CLASS{new_c}")
    out = ta.get("o", "word_lm.arpa")
    class_bigram_arpa(out, cls, bigrams, unigrams)
    if ta.trace:
        print(f"LLink: {len(unigrams)} words, "
              f"{max(cls.values()) + 1} classes -> {out}")
    return 0


main_llink = tool_main(run_llink)

if __name__ == "__main__":
    raise SystemExit(main())
