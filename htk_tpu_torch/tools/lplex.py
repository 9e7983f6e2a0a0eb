"""LPlex — language model perplexity evaluation.

Mirrors `HLMTools/LPlex`: computes test-set perplexity of an ARPA n-gram
LM over text or MLF data.

Usage: LPlex [options] lmFile testFiles...

  -n N     evaluate at order N (default: LM order)
  -u       count unknown words as OOV (skipped) instead of erroring
  -t       print per-sentence log probs
  Standard: -A -C -D -S -T -V

Copied from `htk_tpu/tools/lplex.py` into the PyTorch port: host code,
behaviour unchanged.
"""

from __future__ import annotations

import math
from typing import List

from ..io.lm import read_lm
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError
from .lbuild import ENTER, EXIT, read_sentences

USAGE = "Usage: LPlex [options] lmFile testFiles..."

OPTS = {
    "n": Option("n", 1, "evaluation order", typ=int, repeatable=True),
    "u": Option("u", 0, "skip OOV words"),
    "t": Option("t", 0, "per-sentence trace"),
}


def run(argv: List[str]) -> int:
    ta = parse_args("LPlex", argv, OPTS, min_args=1, usage=USAGE)
    lm = read_lm(ta.args[0], ta.config)
    files = ta.args[1:] + ta.script
    if not files:
        HError(1030, "LPlex: no test files\n%s", USAGE)
    # LPlex.c accepts repeated -n and reports one table per order
    orders = [int(v) for v in ta.get_all("n")] or [lm.order]
    skip_oov = ta.has("u")

    for order in orders:
        total_lp = 0.0
        n_words = 0
        n_oov = 0
        n_sents = 0
        for f in files:
            for sent in read_sentences(f, ta.config):
                seq = [ENTER] + sent + [EXIT]
                lp = 0.0
                for i in range(1, len(seq)):
                    w = seq[i]
                    if w not in lm.unigrams and w != EXIT:
                        n_oov += 1
                        if skip_oov:
                            continue
                    if order >= 4 and i >= 3:
                        lp += lm.logp_4(seq[i - 3], seq[i - 2],
                                        seq[i - 1], w)
                    elif order >= 3 and i >= 2:
                        lp += lm.logp_tri(seq[i - 2], seq[i - 1], w)
                    else:
                        lp += lm.logp_bi(seq[i - 1], w)
                    n_words += 1
                total_lp += lp
                n_sents += 1
                if ta.has("t"):
                    print(f"  {' '.join(sent)}: logP={lp:.3f}")
        if n_words == 0:
            HError(15030, "LPlex: no scorable words")
        ppl = math.exp(-total_lp / n_words)
        print(f"LPlex: {n_sents} sentences, {n_words} words, {n_oov} OOV")
        print(f"perplexity {ppl:.4f}, logprob/word "
              f"{total_lp / n_words:.4f} (order {order})")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
