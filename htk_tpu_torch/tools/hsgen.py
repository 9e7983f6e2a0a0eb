"""HSGen — generate random sentences from a word network.

Mirrors `HTKTools/HSGen.c`: random walks over an SLF lattice (useful for
checking grammars and estimating perplexity).

Usage: HSGen [options] latFile dictFile

  -n N   number of sentences (default 100)
  -l     include line numbers
  -q     quiet: suppress the sentences themselves
  -s     compute grammar statistics (sentence lengths, per-word entropy
         of the walked branch decisions, estimated perplexity)
  Config: HTKTPU: SEED = n  reproducible walks
  Standard: -A -C -D -S -T -V

Copied from `htk_tpu/tools/hsgen.py` into the PyTorch port: host code,
behaviour unchanged.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from ..io.dictionary import read_dict
from ..io.slf import NULL_WORD, read_slf
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError

USAGE = "Usage: HSGen [options] latFile dictFile"

OPTS = {
    "n": Option("n", 1, "number of sentences", typ=int),
    "l": Option("l", 0, "line numbers"),
    "q": Option("q", 0, "quiet (no sentences)"),
    "s": Option("s", 0, "grammar statistics"),
}

MAX_LEN = 200


def run(argv: List[str]) -> int:
    ta = parse_args("HSGen", argv, OPTS, min_args=2, usage=USAGE)
    lat = read_slf(ta.args[0], ta.config)
    read_dict(ta.args[1], ta.config)  # validated for parity with HTK's arg order
    n = int(ta.get("n", 100) or 100)
    seed = ta.config.int_("SEED", 0, module="HTKTPU") or 0
    rng = np.random.default_rng(seed)

    out_arcs = {}
    for a in lat.arcs:
        out_arcs.setdefault(a.start, []).append(a)
    start = lat.start_node()
    end = lat.end_node()
    words_of = {nd.id: nd.word for nd in lat.nodes}

    tot_words = 0
    tot_logp = 0.0  # summed natural-log prob of the walked decisions
    min_len = None
    max_len = 0
    for i in range(n):
        sent: List[str] = []
        node = start
        steps = 0
        while node != end and steps < MAX_LEN:
            arcs = out_arcs.get(node)
            if not arcs:
                break
            probs = np.array([math.exp(min(a.lmlike, 0.0)) for a in arcs])
            if probs.sum() <= 0:
                probs = np.ones(len(arcs))
            probs = probs / probs.sum()
            k = int(rng.choice(len(arcs), p=probs))
            tot_logp += math.log(max(float(probs[k]), 1e-30))
            a = arcs[k]
            node = a.end
            w = a.word if a.word is not None else words_of.get(node)
            if w and w != NULL_WORD:
                sent.append(w)
            steps += 1
        tot_words += len(sent)
        min_len = len(sent) if min_len is None else min(min_len, len(sent))
        max_len = max(max_len, len(sent))
        if not ta.has("q"):
            line = " ".join(sent)
            if ta.has("l"):
                print(f"{i + 1}. {line}")
            else:
                print(line)
    if ta.has("s"):
        # HSGen.c ComputeVSize-style grammar statistics: entropy of the
        # branch decisions per emitted word, perplexity = 2^entropy
        ent_bits = (-tot_logp / max(tot_words, 1)) / math.log(2.0)
        print(f"Number of Sentences = {n}")
        print(f"Average Sentence Length = {tot_words / max(n, 1):.2f} "
              f"(min {min_len or 0}, max {max_len})")
        print(f"Entropy = {ent_bits:.4f} bits/word, "
              f"Perplexity = {2.0 ** ent_bits:.2f}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
