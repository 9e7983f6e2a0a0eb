"""LMerge / LNorm — language model interpolation and renormalisation.

Mirrors `HLMTools/LMerge` (LPMerge.c) and `HLMTools/LNorm`: linear
interpolation of ARPA n-gram models and renormalisation/pruning of a
model's probabilities.

Usage: LMerge [options] mainLM outLM [otherLM weight ...]

  -i w lm   interpolate with lm at weight w (repeatable)
  Standard: -A -C -D -S -T -V

LNorm usage: LNorm [options] inLM outLM
  -c n      prune n-grams with count... (accepted; prob-threshold here)
  -p f      prune n-grams with prob below f

Copied from `htk_tpu/tools/lmerge.py` into the PyTorch port: host code,
behaviour unchanged.
"""

from __future__ import annotations

import math
from typing import List

from ..io.lm import NGramLM, read_lm, save_lm
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError

USAGE = "Usage: LMerge [options] mainLM outLM"

OPTS = {
    "i": Option("i", 2, "interpolation weight + LM", repeatable=True),
}


def interpolate(models: List[NGramLM], weights: List[float]) -> NGramLM:
    """Linear interpolation in probability space; back-off recomputed."""
    z = sum(weights)
    weights = [w / z for w in weights]
    out = NGramLM(order=max(m.order for m in models))
    vocab = set()
    for m in models:
        vocab |= set(m.unigrams)
    # unigrams
    for w in vocab:
        p = sum(
            wt * math.exp(m.logp_uni(w)) for m, wt in zip(models, weights)
        )
        out.unigrams[w] = (math.log(max(p, 1e-12)), 0.0)
    # bigrams: union of explicit bigrams
    pairs = set()
    for m in models:
        pairs |= set(m.bigrams)
    for (w1, w2) in pairs:
        p = sum(
            wt * math.exp(m.logp_bi(w1, w2)) for m, wt in zip(models, weights)
        )
        out.bigrams[(w1, w2)] = (math.log(max(p, 1e-12)), 0.0)
    # recompute back-off weights so each history sums to one
    renormalise(out)
    return out


def renormalise(lm: NGramLM) -> None:
    """Recompute unigram back-off weights (LNorm role)."""
    uni_p = {w: math.exp(p) for w, (p, _bo) in lm.unigrams.items()}
    tot = sum(uni_p.values())
    for w in uni_p:
        uni_p[w] /= tot
    for w1 in list(lm.unigrams):
        followers = [(w2, p) for (a, w2), (p, _b) in lm.bigrams.items()
                     if a == w1]
        mass = sum(math.exp(p) for _w2, p in followers)
        seen = {w2 for w2, _p in followers}
        unseen = sum(p for w, p in uni_p.items() if w not in seen)
        if mass >= 1.0:  # clip over-mass (fp accumulation)
            scale = 0.999 / mass
            for w2, p in followers:
                lm.bigrams[(w1, w2)] = (p + math.log(scale), 0.0)
            mass = 0.999
        alpha = (1.0 - mass) / max(unseen, 1e-12)
        lm.unigrams[w1] = (
            math.log(max(uni_p[w1], 1e-12)), math.log(max(alpha, 1e-12))
        )


def prune(lm: NGramLM, min_logp: float) -> None:
    lm.bigrams = {k: v for k, v in lm.bigrams.items() if v[0] >= min_logp}
    lm.trigrams = {k: v for k, v in lm.trigrams.items() if v >= min_logp}
    renormalise(lm)


def run(argv: List[str]) -> int:
    ta = parse_args("LMerge", argv, OPTS, min_args=2, usage=USAGE)
    main_lm = read_lm(ta.args[0], ta.config)
    out_path = ta.args[1]
    models = [main_lm]
    weights = [1.0]
    for w, lmf in ta.get_all("i"):
        models.append(read_lm(lmf, ta.config))
        weights.append(float(w))
        weights[0] = max(1.0 - sum(weights[1:]), 0.0)
    lm = interpolate(models, weights) if len(models) > 1 else main_lm
    save_lm(lm, out_path, ta.config)
    if ta.trace:
        print(f"LMerge: {len(models)} models -> {out_path} "
              f"({len(lm.unigrams)} 1-grams, {len(lm.bigrams)} 2-grams)")
    return 0


def run_lnorm(argv: List[str]) -> int:
    ta = parse_args(
        "LNorm", argv,
        {"p": Option("p", 1, "prune threshold (ln prob)", typ=float),
         "c": Option("c", 1, "count cutoff (accepted)", typ=int)},
        min_args=2, usage="Usage: LNorm [options] inLM outLM",
    )
    lm = read_lm(ta.args[0], ta.config)
    if ta.has("p"):
        prune(lm, float(ta.get("p")))
    else:
        renormalise(lm)
    save_lm(lm, ta.args[1], ta.config)
    if ta.trace:
        print(f"LNorm: wrote {ta.args[1]}")
    return 0


main = tool_main(run)
main_lnorm = tool_main(run_lnorm)

if __name__ == "__main__":
    raise SystemExit(main())
