"""Pronunciation dictionaries.

Mirrors `HTKLib/HDict.c` (ReadDict/WriteDict/GetWord): lines of

  WORD [ [outsym] ] [pronprob] phone phone ...

Multiple lines per word add alternative pronunciations. The output symbol
defaults to the word itself; `[]` suppresses output (HTK convention for
silence words).

Copied from `htk_tpu/io/dictionary.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.errors import HError


@dataclass
class Pron:
    phones: List[str]
    prob: float = 1.0
    out_sym: Optional[str] = None  # None = word itself; "" = suppressed


@dataclass
class Word:
    name: str
    prons: List[Pron] = field(default_factory=list)


class Vocab:
    def __init__(self):
        self.words: Dict[str, Word] = {}

    def get(self, name: str) -> Optional[Word]:
        return self.words.get(name)

    def add_pron(self, word: str, phones: List[str], prob: float = 1.0,
                 out_sym: Optional[str] = None):
        w = self.words.setdefault(word, Word(name=word))
        w.prons.append(Pron(phones=list(phones), prob=prob, out_sym=out_sym))

    def __len__(self):
        return len(self.words)

    def __contains__(self, name: str):
        return name in self.words


_OUTSYM_RE = re.compile(r"^\[(?P<sym>[^\]]*)\]$")


def read_dict(path: str, cfg=None) -> Vocab:
    """Parse an HTK dictionary (HDict.c : ReadDict)."""
    from ..utils.filters import filtered

    v = Vocab()
    try:
        with filtered(path, "HDICTFILTER", cfg) as p:
            lines = open(p, "r", errors="replace").read().splitlines()
    except OSError as e:
        HError(8010, "ReadDict: cannot open dictionary %s (%s)", path, e)
    for raw in lines:
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        word = parts[0]
        rest = parts[1:]
        out_sym = None
        if rest and _OUTSYM_RE.match(rest[0]):
            out_sym = _OUTSYM_RE.match(rest[0]).group("sym")
            rest = rest[1:]
        prob = 1.0
        if rest:
            try:
                prob = float(rest[0])
                rest = rest[1:]
            except ValueError:
                pass
        if not rest:
            HError(8050, "ReadDict: word %s has no pronunciation", word)
        v.add_pron(word, rest, prob, out_sym)
    return v


def write_dict(v: Vocab, path: str) -> None:
    with open(path, "w") as f:
        for name in sorted(v.words):
            for p in v.words[name].prons:
                fields = [name]
                if p.out_sym is not None:
                    fields.append(f"[{p.out_sym}]")
                if p.prob != 1.0:
                    fields.append("%.6f" % p.prob)
                fields += p.phones
                f.write(" ".join(fields) + "\n")
