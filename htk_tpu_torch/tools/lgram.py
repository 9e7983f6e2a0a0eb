"""Gram-file machinery: LNewMap, LGPrep, LGCopy, LFoF, LGList.

Mirrors the `HLMTools` gram-file workflow (`LGPrep` counts n-grams from
text into gram files, `LGCopy` merges/sorts/remaps them, `LFoF` derives
frequency-of-frequency tables for discount estimation, `LNewMap` seeds a
word map). The on-disk layouts are this framework's own text forms —
HLM's binary gram/wmap layouts need the reference to verify [LC]:

  word map:   !Name = x / !Entries = N header, then "word id" lines
  gram file:  !Ngram = k header, then "w1 .. wk count" lines (sorted)
  FoF file:   !FoF rows "order r count"

`LBuild` accepts gram files anywhere it accepts training text, so the
classic  LGPrep -> LGCopy -> LBuild  recipe runs unchanged.

Usage:
  LNewMap [-e esc] name mapfn
  LGPrep  [-n N] [-r root] [-d dir] wmap textfiles...
  LGCopy  [-o out] [-m newmap] wmap gramfiles...
  LFoF    [-n K] wmap foffile gramfiles...

Copied from `htk_tpu/tools/lgram.py` into the PyTorch port: host code,
behaviour unchanged. `is_gram_file`/`read_gram`, which the port's LBuild
reads gram files with, live here as they do in htk_tpu.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, Tuple

from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, contained
from .lbuild import ENTER, EXIT, read_sentences

UNK = "!!UNK"


class WordMap:
    """HLM word map: word <-> id with a running sequence number."""

    def __init__(self, name: str = "wmap"):
        self.name = name
        self.ids: Dict[str, int] = {}
        self.seqno = 0

    def add(self, word: str) -> int:
        if word not in self.ids:
            self.ids[word] = 65536 + len(self.ids)  # HLM ids start @ 65536
        return self.ids[word]

    @classmethod
    def load(cls, path: str) -> "WordMap":
        wm = cls()
        try:
            f = open(path)
        except OSError:
            HError(15010, "WordMap: cannot open %s", path)
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            # header keys only — word entries may start with "!" too
            # (e.g. !!UNK), so match the exact header names
            if ln.split()[0] in ("!Name", "!SeqNo", "!Entries"):
                if ln.startswith("!Name"):
                    wm.name = ln.split("=", 1)[1].strip()
                elif ln.startswith("!SeqNo"):
                    wm.seqno = int(ln.split("=", 1)[1])
                continue
            parts = ln.split()
            if len(parts) >= 2:
                wm.ids[parts[0]] = int(parts[1])
            elif parts:
                wm.ids[parts[0]] = 65536 + len(wm.ids)
        return wm

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(f"!Name = {self.name}\n")
            f.write(f"!SeqNo = {self.seqno}\n")
            f.write(f"!Entries = {len(self.ids)}\n")
            for w, i in sorted(self.ids.items(), key=lambda kv: kv[1]):
                f.write(f"{w} {i}\n")


def write_gram(path: str, order: int, counts: Counter) -> None:
    with open(path, "w") as f:
        f.write(f"!Ngram = {order}\n")
        for gram in sorted(counts):
            f.write(" ".join(gram) + f" {int(counts[gram])}\n")


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


# -- LNewMap ----------------------------------------------------------------

NEWMAP_OPTS = {"e": Option("e", 1, "escape mode (recorded)")}


def run_lnewmap(argv: List[str]) -> int:
    ta = parse_args("LNewMap", argv, NEWMAP_OPTS, min_args=2,
                    usage="Usage: LNewMap [options] name mapfn")
    wm = WordMap(ta.args[0])
    wm.seqno = 0
    for w in (UNK, ENTER, EXIT):
        wm.add(w)
    wm.save(ta.args[1])
    return 0


# -- LGPrep -------------------------------------------------------------------

LGPREP_OPTS = {
    "n": Option("n", 1, "max n-gram order", typ=int),
    "r": Option("r", 1, "gram file root name"),
    "d": Option("d", 1, "output directory"),
    "a": Option("a", 1, "max new words (accepted)", typ=int),
}


def run_lgprep(argv: List[str]) -> int:
    ta = parse_args("LGPrep", argv, LGPREP_OPTS, min_args=1,
                    usage="Usage: LGPrep [options] wmap textfiles...")
    wmap_path = ta.args[0]
    files = ta.args[1:] + ta.script
    if not files:
        HError(1030, "LGPrep: no training text")
    order = int(ta.get("n", 3) or 3)
    root = ta.get("r", "gram")
    out_dir = ta.get("d", ".")
    os.makedirs(out_dir, exist_ok=True)

    wm = WordMap.load(wmap_path)
    tabs = {k: Counter() for k in range(1, order + 1)}
    n_sent = 0
    for path in files:
        for sent in read_sentences(path, ta.config):
            n_sent += 1
            seq = [ENTER] + sent + [EXIT]
            for w in seq:
                wm.add(w)
            for k in range(1, order + 1):
                for i in range(len(seq) - k + 1):
                    tabs[k][tuple(seq[i : i + k])] += 1
    wm.seqno += 1
    wm.save(wmap_path)
    for k in range(1, order + 1):
        p = os.path.join(out_dir, f"{root}.{k}gram")
        write_gram(p, k, tabs[k])
        if ta.trace:
            print(f"LGPrep: {len(tabs[k])} {k}-grams -> {p}")
    if ta.trace:
        print(f"LGPrep: {n_sent} sentences, wmap now {len(wm.ids)} words")
    return 0


# -- LGCopy -------------------------------------------------------------------

LGCOPY_OPTS = {
    "o": Option("o", 1, "output gram file"),
    "m": Option("m", 1, "remap through this word map (OOV -> !!UNK)"),
}


def run_lgcopy(argv: List[str]) -> int:
    ta = parse_args("LGCopy", argv, LGCOPY_OPTS, min_args=2,
                    usage="Usage: LGCopy [options] wmap gramfiles...")
    files = ta.args[1:] + ta.script
    out = ta.get("o", "data.gram")
    merged: Counter = Counter()
    order = None
    for f in files:
        o, counts = read_gram(f)
        if order is None:
            order = o
        elif o != order:
            HError(16111, "LGCopy: mixed gram orders (%d vs %d)", order, o)
        merged.update(counts)
    if ta.has("m"):
        keep = set(WordMap.load(ta.get("m")).ids)
        remapped: Counter = Counter()
        for gram, c in merged.items():
            remapped[tuple(w if w in keep else UNK for w in gram)] += c
        merged = remapped
    write_gram(out, order or 1, merged)
    if ta.trace:
        print(f"LGCopy: {len(files)} files -> {len(merged)} "
              f"{order}-grams in {out}")
    return 0


# -- LFoF ---------------------------------------------------------------------

LFOF_OPTS = {"n": Option("n", 1, "FoF table size", typ=int)}


def run_lfof(argv: List[str]) -> int:
    ta = parse_args("LFoF", argv, LFOF_OPTS, min_args=2,
                    usage="Usage: LFoF [options] wmap foffile gramfiles...")
    fof_path = ta.args[1]
    files = ta.args[2:] + ta.script
    if not files:
        HError(1030, "LFoF: no gram files")
    K = int(ta.get("n", 32) or 32)
    per_order: Dict[int, Counter] = {}
    for f in files:
        o, counts = read_gram(f)
        per_order.setdefault(o, Counter()).update(counts)
    with open(fof_path, "w") as f:
        f.write(f"!FoF = {K}\n")
        for o in sorted(per_order):
            fof = Counter(per_order[o].values())
            for r in range(1, K + 1):
                f.write(f"{o} {r} {fof.get(r, 0)}\n")
    if ta.trace:
        print(f"LFoF: orders {sorted(per_order)} -> {fof_path}")
    return 0


# -- LGList -------------------------------------------------------------------

LGLIST_OPTS = {
    "f": Option("f", 0, "print FoF-style count-of-count summary instead"),
    "m": Option("m", 1, "min count to list", typ=int),
}


def run_lglist(argv: List[str]) -> int:
    """List gram-file contents (HLMTools LGList: dump n-grams + counts).

    With -f, print a count-of-count summary per order instead of every
    n-gram; -m N lists only n-grams with count >= N.
    """
    ta = parse_args("LGList", argv, LGLIST_OPTS, min_args=2,
                    usage="Usage: LGList [options] wmap gramfiles...")
    files = ta.args[1:] + ta.script
    min_c = int(ta.get("m", 1) or 1)
    for fpath in files:
        o, counts = read_gram(fpath)
        print(f"{fpath}: {len(counts)} {o}-grams, "
              f"{sum(counts.values())} tokens")
        if ta.has("f"):
            fof = Counter(counts.values())
            for r in sorted(fof):
                print(f"  r={r}: {fof[r]}")
        else:
            for gram in sorted(counts):
                c = counts[gram]
                if c >= min_c:
                    print(f"  {' '.join(gram)} {c}")
    return 0


main_lnewmap = tool_main(run_lnewmap)
main_lgprep = tool_main(run_lgprep)
main_lgcopy = tool_main(run_lgcopy)
main_lfof = tool_main(run_lfof)
main_lglist = tool_main(run_lglist)
