"""HDMan — pronunciation dictionary manager.

Mirrors `HTKTools/HDMan.c`: merges source dictionaries and applies an
edit script. Implemented commands:

  AS a b ..     append silence model(s) to every pronunciation
  CR x a y b    replace phone y by x in the context a_b ('*' wildcard)
                [LC: context-match details reconstructed]
  DD x a b ..   delete pronunciation "a b .." of word x
  DP a b ..     delete the named phones from pronunciations
  DS src        delete prons sourced from dictionary src (path/basename)
  LP / UP       lower-/upper-case all word names
  RS system     remove stress marks (system = cmu: strip trailing digits)
  MP x a b ..   merge phone sequence a b .. into x
  RP x a b ..   replace any of phones a b .. by x
  SP x          define the phone used by AS etc. [accepted]
  TC [st [en]]  triphonise prons (l-p+r; st/en optional edge contexts)
  LC [x]        left-biphone conversion (x optional word-start context)
  RC [x]        right-biphone conversion (x optional word-end context)
  IR            (not implemented, warned)

Usage: HDMan [options] newDict srcDict1 [srcDict2 ...]

  -g script  edit script            -w wordlist  only keep listed words
  -l fnlog   write log (accepted)   -n phlist    write used-phone list
  Standard: -A -C -D -S -T -V

Copied from `htk_tpu/tools/hdman.py` into the PyTorch port: host code,
behaviour unchanged.
"""

from __future__ import annotations

import re
from typing import List

from ..io.dictionary import Pron, Vocab, read_dict, write_dict
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError

USAGE = "Usage: HDMan [options] newDict srcDict1 [..]"

OPTS = {
    "g": Option("g", 1, "edit script"),
    "w": Option("w", 1, "word list"),
    "n": Option("n", 1, "output phone list"),
    "l": Option("l", 1, "log file"),
    "i": Option("i", 0, "include word output symbols"),
}


def apply_script(v: Vocab, text: str, trace: int = 0) -> None:
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        op = parts[0].upper()
        args = parts[1:]
        if op == "AS":
            for w in v.words.values():
                for p in w.prons:
                    p.phones = p.phones + args
        elif op == "RS":
            sysname = args[0] if args else "cmu"
            for w in v.words.values():
                for p in w.prons:
                    p.phones = [re.sub(r"\d+$", "", ph) for ph in p.phones]
        elif op == "MP":
            new, seq = args[0], args[1:]
            n = len(seq)
            for w in v.words.values():
                for p in w.prons:
                    out = []
                    i = 0
                    while i < len(p.phones):
                        if p.phones[i : i + n] == seq:
                            out.append(new)
                            i += n
                        else:
                            out.append(p.phones[i])
                            i += 1
                    p.phones = out
        elif op == "DP":
            dels = set(args)
            for w in v.words.values():
                for p in w.prons:
                    p.phones = [ph for ph in p.phones if ph not in dels]
        elif op == "RP":
            new, olds = args[0], set(args[1:])
            for w in v.words.values():
                for p in w.prons:
                    p.phones = [new if ph in olds else ph for ph in p.phones]
        elif op == "CR":
            # CR x a y b: replace y by x where the left neighbour
            # matches a and the right neighbour matches b; '*' matches
            # anything including a word edge, a concrete context does
            # not match past the edge
            if len(args) != 4:
                HError(14030, "HDMan: CR needs 4 arguments")
            new, lc, old, rc = args

            def ctx_ok(want, got):
                return want == "*" or (got is not None and got == want)

            for w in v.words.values():
                for p in w.prons:
                    ph = p.phones
                    p.phones = [
                        new if (x == old
                                and ctx_ok(lc, ph[i - 1] if i else None)
                                and ctx_ok(rc, ph[i + 1]
                                           if i < len(ph) - 1 else None))
                        else x
                        for i, x in enumerate(ph)
                    ]
        elif op == "DD":
            if len(args) < 2:
                HError(14030, "HDMan: DD needs a word and a "
                              "pronunciation")
            word, seq = args[0], args[1:]
            w = v.words.get(word)
            if w is not None:
                w.prons = [p for p in w.prons if p.phones != seq]
                if not w.prons:
                    del v.words[word]
        elif op == "DS":
            import os as _os

            if not args:
                HError(14030, "HDMan: DS needs a source dictionary name")
            src = args[0]
            for name in list(v.words):
                w = v.words[name]
                w.prons = [
                    p for p in w.prons
                    if not (getattr(p, "source", None) is not None
                            and (p.source == src
                                 or _os.path.basename(p.source) == src))
                ]
                if not w.prons:
                    del v.words[name]
        elif op in ("LP", "UP"):
            conv = str.lower if op == "LP" else str.upper
            renamed = {}
            for name, w in v.words.items():
                nn = conv(name)
                if nn in renamed:
                    renamed[nn].prons.extend(w.prons)
                else:
                    w.name = nn
                    renamed[nn] = w
            v.words = renamed
        elif op == "SP":
            pass  # silence phone name — AS args already explicit here
        elif op == "TC":
            st = args[0] if args else None
            en = args[1] if len(args) > 1 else None
            for w in v.words.values():
                for p in w.prons:
                    ph = p.phones
                    out = []
                    for i, x in enumerate(ph):
                        l = ph[i - 1] if i > 0 else st
                        r = ph[i + 1] if i < len(ph) - 1 else en
                        nm = x
                        if l:
                            nm = f"{l}-{nm}"
                        if r:
                            nm = f"{nm}+{r}"
                        out.append(nm)
                    p.phones = out
        elif op == "LC":
            x0 = args[0] if args else None
            for w in v.words.values():
                for p in w.prons:
                    ph = p.phones
                    p.phones = [
                        (f"{ph[i - 1] if i > 0 else x0}-{x}"
                         if (i > 0 or x0) else x)
                        for i, x in enumerate(ph)
                    ]
        elif op == "RC":
            x0 = args[0] if args else None
            for w in v.words.values():
                for p in w.prons:
                    ph = p.phones
                    p.phones = [
                        (f"{x}+{ph[i + 1] if i < len(ph) - 1 else x0}"
                         if (i < len(ph) - 1 or x0) else x)
                        for i, x in enumerate(ph)
                    ]
        else:
            HRError(14050, "HDMan: unsupported command %s ignored", op)


def run(argv: List[str]) -> int:
    ta = parse_args("HDMan", argv, OPTS, min_args=2, usage=USAGE)
    out_path = ta.args[0]
    srcs = ta.args[1:] + ta.script

    merged = Vocab()
    for s in srcs:
        v = read_dict(s, ta.config)
        for name, w in v.words.items():
            for p in w.prons:
                # first dictionary wins for duplicate pronunciations (HTK
                # merges in order)
                exists = any(
                    q.phones == p.phones for q in merged.words.get(
                        name, type(w)(name=name)).prons
                ) if name in merged.words else False
                if not exists:
                    merged.add_pron(name, p.phones, p.prob, p.out_sym)
                    # provenance for the DS edit command
                    merged.words[name].prons[-1].source = s

    if ta.has("w"):
        keep = {
            ln.split()[0]
            for ln in open(ta.get("w")).read().splitlines()
            if ln.strip()
        }
        missing = keep - set(merged.words)
        for m in sorted(missing):
            HRError(14051, "HDMan: word %s not found in sources", m)
        merged.words = {k: v for k, v in merged.words.items() if k in keep}

    if ta.has("g"):
        apply_script(merged, open(ta.get("g")).read(), ta.trace)

    write_dict(merged, out_path)
    if ta.has("n"):
        phones = sorted({ph for w in merged.words.values()
                         for p in w.prons for ph in p.phones})
        with open(ta.get("n"), "w") as f:
            f.write("\n".join(phones) + "\n")
    if ta.trace:
        print(f"HDMan: wrote {len(merged.words)} words to {out_path}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
