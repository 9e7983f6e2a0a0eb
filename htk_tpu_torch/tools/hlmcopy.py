"""HLMCopy — construct/copy dictionaries for LM vocabularies.

Mirrors `HLMTools/HLMCopy.c`: copy a dictionary, optionally restricting
it to a word list (the LM vocabulary) and filling missing pronunciations
from extra source dictionaries searched in order. The standard use is
building the decode dictionary for an LM built by LBuild: the word list
is the LM's vocabulary, the -d dictionaries are large background
lexicons.

Usage: HLMCopy [options] inDict outDict
  -d s   search dictionary s for missing pronunciations (repeatable,
         searched in the order given, after inDict)
  -n n   output at most n pronunciations per word (default: all)
  -o     let words with no pronunciation through (skipped with a
         warning) instead of raising a numbered error
  -w fn  copy only words listed in fn (first field per line)
plus the standard options (-A -C -D -S -T -V).

Copied from `htk_tpu/tools/hlmcopy.py` into the PyTorch port: host code,
behaviour unchanged.
"""

from __future__ import annotations

from typing import List

from ..io.dictionary import Vocab, read_dict, write_dict
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError

USAGE = "Usage: HLMCopy [options] inDict outDict"


def copy_dict(src: Vocab, extras: List[Vocab], words=None,
              max_prons: int = 0, allow_missing: bool = False) -> Vocab:
    """Build the output vocab (HLMCopy.c core).

    Pronunciations come from the first dictionary in [src] + extras that
    knows the word; max_prons 0 means all.
    """
    out = Vocab()
    names = sorted(words) if words is not None else sorted(src.words)
    missing = []
    for name in names:
        entry = None
        for d in [src] + extras:
            entry = d.get(name)
            if entry is not None:
                break
        if entry is None:
            missing.append(name)
            continue
        prons = entry.prons
        if max_prons > 0:
            prons = prons[:max_prons]
        for p in prons:
            out.add_pron(name, p.phones, p.prob, p.out_sym)
    if missing:
        if not allow_missing:
            HError(16450, "HLMCopy: no pronunciation for %d word(s): %s",
                   len(missing), " ".join(missing[:10]))
        HRError(-16450, "HLMCopy: skipping %d word(s) with no pronunciation",
                len(missing))
    return out


def run(argv: List[str]) -> int:
    ta = parse_args(
        "HLMCopy", argv,
        {"d": Option("d", 1, "extra pronunciation dictionary",
                     repeatable=True),
         "n": Option("n", 1, "max pronunciations per word", typ=int),
         "o": Option("o", 0, "allow words with no pronunciation"),
         "w": Option("w", 1, "word list file")},
        min_args=2, usage=USAGE,
    )
    src = read_dict(ta.args[0], ta.config)
    extras = [read_dict(p, ta.config) for p in ta.get_all("d")]
    words = None
    if ta.has("w"):
        words = {ln.split()[0]
                 for ln in open(ta.get("w")).read().splitlines()
                 if ln.strip()}
    out = copy_dict(src, extras, words,
                    max_prons=int(ta.get("n", 0) or 0),
                    allow_missing=ta.has("o"))
    write_dict(out, ta.args[1])
    if ta.trace:
        print(f"HLMCopy: {len(out)} words -> {ta.args[1]}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
