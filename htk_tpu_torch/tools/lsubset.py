"""LSubset / LAdapt — LM vocabulary restriction and adaptation.

Mirrors `HLMTools/LSubset` (restrict an ARPA LM to a word list and
renormalise) and `HLMTools/LAdapt` (build an LM from adaptation text and
interpolate it with a base LM).

LSubset usage: LSubset [options] inLM wordList outLM
LAdapt  usage: LAdapt [-i w baseLM] [-n N] outLM adaptText...

Copied from `htk_tpu/tools/lsubset.py` into the PyTorch port: host code,
behaviour unchanged.
"""

from __future__ import annotations

from typing import List

from ..io.lm import NGramLM, read_lm, save_lm
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError
from .lbuild import build_lm, read_sentences
from .lmerge import interpolate, renormalise

USAGE_SUBSET = "Usage: LSubset [options] inLM wordList outLM"
USAGE_ADAPT = "Usage: LAdapt [options] outLM adaptText..."


def subset(lm: NGramLM, keep) -> NGramLM:
    out = NGramLM(order=lm.order)
    out.unigrams = {w: v for w, v in lm.unigrams.items() if w in keep}
    out.bigrams = {k: v for k, v in lm.bigrams.items()
                   if k[0] in keep and k[1] in keep}
    out.trigrams = {k: v for k, v in lm.trigrams.items()
                    if all(w in keep for w in k)}
    out.tri_bo = {k: v for k, v in lm.tri_bo.items()
                  if all(w in keep for w in k)}
    out.fourgrams = {k: v for k, v in lm.fourgrams.items()
                     if all(w in keep for w in k)}
    renormalise(out)
    return out


def run_subset(argv: List[str]) -> int:
    ta = parse_args("LSubset", argv, {}, min_args=3, usage=USAGE_SUBSET)
    lm = read_lm(ta.args[0], ta.config)
    keep = {
        ln.split()[0]
        for ln in open(ta.args[1]).read().splitlines() if ln.strip()
    }
    keep |= {"<s>", "</s>", "!ENTER", "!EXIT"}
    out = subset(lm, keep)
    if not out.unigrams:
        HError(15050, "LSubset: no vocabulary words found in LM")
    save_lm(out, ta.args[2], ta.config)
    if ta.trace:
        print(f"LSubset: {len(lm.unigrams)} -> {len(out.unigrams)} words")
    return 0


def run_adapt(argv: List[str]) -> int:
    ta = parse_args(
        "LAdapt", argv,
        {"i": Option("i", 2, "interpolation weight + base LM"),
         "n": Option("n", 1, "order", typ=int)},
        min_args=1, usage=USAGE_ADAPT,
    )
    out_path = ta.args[0]
    files = ta.args[1:] + ta.script
    if not files:
        HError(1030, "LAdapt: no adaptation text\n%s", USAGE_ADAPT)
    sents = []
    for f in files:
        sents.extend(read_sentences(f, ta.config))
    lm = build_lm(sents, order=int(ta.get("n", 2) or 2))
    if ta.has("i"):
        w, base_path = ta.get("i")
        base = read_lm(base_path, ta.config)
        lm = interpolate([lm, base], [1.0 - float(w), float(w)])
    save_lm(lm, out_path, ta.config)
    if ta.trace:
        print(f"LAdapt: {len(sents)} adaptation sentences -> {out_path}")
    return 0


main = tool_main(run_subset)
main_ladapt = tool_main(run_adapt)

if __name__ == "__main__":
    raise SystemExit(main())
