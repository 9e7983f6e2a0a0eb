"""HLStats — label statistics and bigram estimation.

Mirrors `HTKTools/HLStats.c`: gathers label occurrence statistics from
MLFs / label files and optionally estimates a back-off bigram LM (the
input to HBuild -n). Sentence boundaries use !ENTER/!EXIT (HTK's ENTERTOK
/EXITTOK configs).

Usage: HLStats [options] hmmList labFiles...

  -b fn    estimate a bigram and write it to fn. Default output is the
           MATRIX bigram form (rows of P(col|row) over the hmmList's
           label order — HLM.c MatBigram); -o selects the back-off/ARPA
           form instead (HTK's -o semantics)
  -o       (with -b) back-off (ARPA) output instead of matrix
  -t n     bigram count floor threshold (default 1)
  -u f     unigram floor probability (default 1)
  -d       absolute discount value (default 0.5)  [LC vs HTK's scheme]
  -p       print statistics to stdout
  -I mlf   load MLF (repeatable)
  Standard: -A -C -D -S -T -V

Copied from `htk_tpu/tools/hlstats.py` into the PyTorch port: host code,
behaviour unchanged.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List

from ..io.lm import LN10, NGramLM, write_arpa, write_matrix_bigram
from ..io.mlf import MLF, load_label_file
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError

USAGE = "Usage: HLStats [options] hmmList labFiles..."

OPTS = {
    "b": Option("b", 1, "output bigram file"),
    "o": Option("o", 0, "backoff format"),
    "t": Option("t", 1, "bigram count threshold", typ=int),
    "u": Option("u", 1, "unigram floor", typ=float),
    "d": Option("d", 1, "absolute discount", typ=float),
    "p": Option("p", 0, "print stats"),
    "I": Option("I", 1, "load MLF", repeatable=True),
}

ENTER, EXIT = "!ENTER", "!EXIT"


def estimate_backoff_bigram(sents: List[List[str]], discount=0.5,
                            threshold=1, ufloor=1.0) -> NGramLM:
    """Absolute-discount back-off bigram (HLStats -b role)."""
    uni = Counter()
    bi = Counter()
    for s in sents:
        seq = [ENTER] + s + [EXIT]
        for w in seq:
            uni[w] += 1
        for a, b in zip(seq, seq[1:]):
            bi[(a, b)] += 1

    # unigram probs with floor
    floored = {w: max(c, ufloor) for w, c in uni.items()}
    tot = sum(floored.values())
    lm = NGramLM(order=2)
    uni_p = {w: c / tot for w, c in floored.items()}

    # bigrams above threshold get discounted ML; mass released -> backoff
    for w1 in uni:
        c1 = uni[w1]
        pairs = [(w2, c) for (a, w2), c in bi.items() if a == w1 and c >= threshold]
        disc_mass = 0.0
        for w2, c in pairs:
            p = max(c - discount, 0.0) / c1
            disc_mass += p
        # backoff weight: remaining mass / unigram mass of unseen followers
        seen = {w2 for w2, _ in pairs}
        unseen_mass = sum(p for w, p in uni_p.items() if w not in seen)
        alpha = (1.0 - disc_mass) / max(unseen_mass, 1e-10)
        bo = math.log(max(alpha, 1e-10))
        lm.unigrams[w1] = (math.log(max(uni_p[w1], 1e-10)), bo)
        for w2, c in pairs:
            p = max(c - discount, 0.0) / c1
            lm.bigrams[(w1, w2)] = (math.log(max(p, 1e-10)), 0.0)
    for w in uni:
        if w not in lm.unigrams:
            lm.unigrams[w] = (math.log(max(uni_p[w], 1e-10)), 0.0)
    return lm


def run(argv: List[str]) -> int:
    ta = parse_args("HLStats", argv, OPTS, min_args=1, usage=USAGE)
    files = ta.script + ta.args[1:]
    mlfs = [MLF.load(p, ta.config) for p in ta.get_all("I")]

    sents: List[List[str]] = []
    for m in mlfs:
        for _pat, tr in m.entries:
            sents.append([l.name for l in tr.labels])
    for fn in files:
        first = open(fn).readline().strip()
        if first == "#!MLF!#":
            m = MLF.load(fn, ta.config)
            for _pat, tr in m.entries:
                sents.append([l.name for l in tr.labels])
        else:
            sents.append([l.name for l in load_label_file(fn).labels])
    if not sents:
        HError(1030, "HLStats: no transcriptions found")

    uni = Counter(w for s in sents for w in s)
    if ta.has("p") or ta.trace:
        print(f"HLStats: {len(sents)} transcriptions, {sum(uni.values())} "
              f"labels, {len(uni)} distinct")
        if ta.has("p"):
            for w, c in uni.most_common():
                print(f"  {w:20s} {c}")

    if ta.has("b"):
        lm = estimate_backoff_bigram(
            sents,
            discount=float(ta.get("d", 0.5) or 0.5),
            threshold=int(ta.get("t", 1) or 1),
            ufloor=float(ta.get("u", 1.0) or 1.0),
        )
        if ta.has("o"):
            write_arpa(lm, ta.get("b"))
        else:
            from ..io.mmf import load_hmm_list

            # matrix rows follow the hmmList label order with the
            # sentence boundary tokens appended (HLStats.c vocabulary)
            order = [l for l, _p in load_hmm_list(ta.args[0], ta.config)]
            order = [ENTER] + order + [EXIT]
            known = set(lm.unigrams)
            order = [w for w in order if w in known]
            write_matrix_bigram(lm, order, ta.get("b"))
        if ta.trace:
            print(f"HLStats: wrote bigram ({len(lm.bigrams)} entries) to "
                  f"{ta.get('b')}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
