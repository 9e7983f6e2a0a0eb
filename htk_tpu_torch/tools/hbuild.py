"""HBuild — build word networks (SLF lattices).

Mirrors `HTKTools/HBuild.c`: turns a word list (+ optional n-gram LM) into
a word-loop recognition lattice:

  - plain loop: every word equally likely, looping (back-off node only)
  - with -n ARPA bigram: explicit bigram arcs + back-off-through-!NULL
    structure (HBuild's back-off bigram network)

Usage: HBuild [options] wordList latFile

  -n lmfile   use ARPA n-gram (bigram part) for transition probs
  -w wpfile   word-pair grammar (allowed successors per word)
  -u word     unknown word symbol to skip (with -n)
  -s st en    sentence start / end words (default !ENTER / !EXIT)
  Standard: -A -C -D -S -T -V

Copied from `htk_tpu/tools/hbuild.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot import htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import math
from typing import List

from ..io.slf import Lattice, LArc, LNode, NULL_WORD, write_slf
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError

USAGE = "Usage: HBuild [options] wordList latFile"

OPTS = {
    "n": Option("n", 1, "ARPA n-gram LM file"),
    "w": Option("w", 1, "word-pair grammar file"),
    "u": Option("u", 1, "unknown word symbol"),
    "s": Option("s", 2, "sentence start/end words"),
}


def word_loop_lattice(words: List[str], probs=None) -> Lattice:
    """!NULL start -> words -> !NULL loop -> words...; end at !NULL."""
    lat = Lattice()
    V = len(words)
    # node 0: start, node 1: loop-back null, node 2: end, words follow
    lat.nodes.append(LNode(id=0, word=NULL_WORD))
    lat.nodes.append(LNode(id=1, word=NULL_WORD))
    lat.nodes.append(LNode(id=2, word=NULL_WORD))
    for k, w in enumerate(words):
        lat.nodes.append(LNode(id=3 + k, word=w))
    aid = 0
    lat.arcs.append(LArc(id=aid, start=0, end=1))
    aid += 1
    for k, w in enumerate(words):
        p = probs[k] if probs is not None else -math.log(V)
        lat.arcs.append(LArc(id=aid, start=1, end=3 + k, lmlike=p))
        aid += 1
        lat.arcs.append(LArc(id=aid, start=3 + k, end=1))
        aid += 1
    lat.arcs.append(LArc(id=aid, start=1, end=2))
    return lat


def bigram_lattice(words: List[str], lm, sent_start: str, sent_end: str,
                   start_word: str = None, end_word: str = None) -> Lattice:
    """Back-off bigram network (HBuild.c back-off structure).

    Nodes: start null (= sentence start), per-word nodes, back-off null,
    end null. Explicit bigram arcs word->word; back-off arcs
    word -> BO (weight) and BO -> word (unigram).

    start_word/end_word (HDecode's STARTWORD/ENDWORD, typically <s>/</s>
    with silence pronunciations) are inserted as REAL word nodes the
    path must traverse — that is how HDecode models the obligatory
    leading/trailing silence of an utterance.
    """
    lat = Lattice()
    V = len(words)
    BO = V  # back-off node index offset bookkeeping below
    # ids: 0 start, 1 backoff null, 2 end, words at 3..
    lat.nodes.append(LNode(id=0, word=NULL_WORD))
    lat.nodes.append(LNode(id=1, word=NULL_WORD))
    lat.nodes.append(LNode(id=2, word=NULL_WORD))
    idx = {}
    for k, w in enumerate(words):
        lat.nodes.append(LNode(id=3 + k, word=w))
        idx[w] = 3 + k
    nid = 3 + V
    aid = 0

    def arc(s, e, p=0.0):
        nonlocal aid
        lat.arcs.append(LArc(id=aid, start=s, end=e, lmlike=p))
        aid += 1

    entry = 0
    if start_word is not None:
        lat.nodes.append(LNode(id=nid, word=start_word))
        arc(0, nid)  # start null -> <s> (silence models), no LM cost
        entry = nid
        nid += 1
    # sentence start: P(w | <s>)
    for w in words:
        p = lm.logp_bi(sent_start, w)
        arc(entry, idx[w], p)
    # explicit bigrams between in-vocab words
    for (w1, w2), (p, _bo) in lm.bigrams.items():
        if w1 in idx and w2 in idx:
            arc(idx[w1], idx[w2], p)
    # back-off: w1 -> BO (backoff weight), BO -> w2 (unigram)
    for w in words:
        u = lm.unigrams.get(w)
        bo_wt = u[1] if u else 0.0
        arc(idx[w], 1, bo_wt)
        arc(1, idx[w], lm.logp_uni(w))
    # sentence end: P(</s> | w)
    exit_n = 2
    if end_word is not None:
        lat.nodes.append(LNode(id=nid, word=end_word))
        arc(nid, 2)  # </s> (silence models) -> end null
        exit_n = nid
        nid += 1
    for w in words:
        arc(idx[w], exit_n, lm.logp_bi(w, sent_end))
    return lat


def read_word_pairs(path: str):
    """Word-pair grammar: a head word on its own line, its allowed
    successors indented below it (the TI-digits wp_gram layout; HBuild -w).
    Returns {head: [successors]}. [LC layout pending reference]"""
    pairs = {}
    head = None
    for ln in open(path):
        if not ln.strip() or ln.lstrip().startswith(("#", "*"))  :
            continue
        toks = ln.split()
        if not ln[0].isspace():
            head = toks[0]
            pairs.setdefault(head, []).extend(toks[1:])
        else:
            if head is None:
                HError(3031, "HBuild: word-pair grammar starts indented")
            pairs[head].extend(toks)
    return pairs


def word_pair_lattice(pairs, sent_start: str, sent_end: str) -> Lattice:
    """Lattice whose arcs are exactly the allowed word pairs."""
    words = sorted({w for w in pairs if w not in (sent_start, sent_end)}
                   | {w for ss in pairs.values() for w in ss
                      if w not in (sent_start, sent_end)})
    lat = Lattice()
    lat.nodes.append(LNode(id=0, word=NULL_WORD))
    lat.nodes.append(LNode(id=1, word=NULL_WORD))
    idx = {}
    for k, w in enumerate(words):
        lat.nodes.append(LNode(id=2 + k, word=w))
        idx[w] = 2 + k
    aid = 0

    def arc(s, e):
        nonlocal aid
        lat.arcs.append(LArc(id=aid, start=s, end=e))
        aid += 1

    starters = pairs.get(sent_start)
    if starters is None:
        starters = words  # no explicit <s> entry: any word may start
    for w in starters:
        if w in idx:
            arc(0, idx[w])
    for head, succs in pairs.items():
        if head in (sent_start,):
            continue
        if head not in idx:
            continue
        for w in succs:
            if w == sent_end:
                arc(idx[head], 1)
            elif w in idx:
                arc(idx[head], idx[w])
    # grammars with no explicit sent_end successors anywhere let every
    # word end (HTK wp grammars usually list the end explicitly) [LC]
    enders = {h for h, ss in pairs.items() if sent_end in ss}
    if not enders:
        for w in words:
            arc(idx[w], 1)
    return lat


def run(argv: List[str]) -> int:
    ta = parse_args("HBuild", argv, OPTS, min_args=2, usage=USAGE)
    word_list, lat_file = ta.args[0], ta.args[1]
    try:
        words = [
            ln.split()[0]
            for ln in open(word_list).read().splitlines()
            if ln.strip() and not ln.startswith("#")
        ]
    except OSError as e:
        HError(1011, "HBuild: cannot open word list %s (%s)", word_list, e)
    if not words:
        HError(1030, "HBuild: empty word list")

    if ta.has("w"):
        st, en = ("!ENTER", "!EXIT")
        if ta.has("s"):
            v = ta.get("s")
            st, en = (v if isinstance(v, tuple) else tuple(v))
        pairs = read_word_pairs(ta.get("w"))
        lat = word_pair_lattice(pairs, st, en)
        write_slf(lat, lat_file)
        if ta.trace:
            print(f"HBuild: word-pair net {len(lat.nodes)} nodes, "
                  f"{len(lat.arcs)} arcs -> {lat_file}")
        return 0

    if ta.has("n"):
        # binary / ARPA / matrix-bigram, sniffed from the leading bytes
        from ..io.lm import read_lm

        lm = read_lm(ta.get("n"), ta.config)
        ss, se = (ta.get("s") if ta.has("s") else ("!ENTER", "!EXIT"))
        unk = ta.get("u")
        words = [w for w in words if w != unk and w not in (ss, se)]
        lat = bigram_lattice(words, lm, ss, se)
    else:
        lat = word_loop_lattice(words)
    write_slf(lat, lat_file)
    if ta.trace:
        print(f"HBuild: {len(lat.nodes)} nodes, {len(lat.arcs)} arcs -> {lat_file}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
