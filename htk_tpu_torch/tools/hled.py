"""HLEd — label file editor.

Mirrors `HTKTools/HLEd.c`: applies an edit script to label files / MLFs.
Implemented commands (the recipe-critical set):

  EX            expand words into phones using the dictionary (-d)
  IS a b        insert label a at start, b at end of every transcription
  DE x ...      delete all occurrences of the named labels
  RE new old .. replace any of the old labels by new
  ME new a b .. merge the exact sequence a b .. into new
  WB x          mark x as a word-boundary symbol (affects TC)
  NB x          remove x from the word-boundary set
  TC [l [r]]    convert phones to triphones l-p+r (word-internal;
                boundary symbols neither take nor give context)
  LC / RC       left-only / right-only context conversion
  SO            sort labels by start time
  CH new x      change label x to new (alias of RE with one source)
  SB x          define x as a deleted sentence-boundary symbol (removes
                every occurrence, like DE, per HLEd.c's SB)
  DL            delete the current (only) label level [level arg
                accepted; multi-level label files carry one level here]
  FI x          find: print each transcription's occurrences of x

Usage: HLEd [options] edScript labFiles...

  -d dict   dictionary for EX        -i mlf   output MLF
  -l dir    output label dir         -y ext   output extension (default lab)
  -I mlf    input MLF (repeatable)   -L/-X    input label dir/ext
  Standard: -A -C -D -S -T -V

Copied from `htk_tpu/tools/hled.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import os
from typing import List, Optional, Set

from ..io.dictionary import read_dict
from ..io.mlf import MLF, Label, Transcription, find_labels, load_label_file, save_label_file
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError

USAGE = "Usage: HLEd [options] edScript labFiles..."

OPTS = {
    "d": Option("d", 1, "dictionary for EX"),
    "i": Option("i", 1, "output MLF"),
    "l": Option("l", 1, "output label dir"),
    "y": Option("y", 1, "output label extension"),
    "I": Option("I", 1, "input MLF", repeatable=True),
    "L": Option("L", 1, "input label dir"),
    "X": Option("X", 1, "input label ext"),
    "m": Option("m", 0, "strip times (accepted)"),
    "G": Option("G", 1, "source label format (HTK/TIMIT/ESPS)"),
}


class LabelEditor:
    def __init__(self, vocab=None):
        self.vocab = vocab
        self.commands: List[tuple] = []
        self.boundaries: Set[str] = set()

    def parse_script(self, text: str):
        for raw in text.splitlines():
            line = raw.split("//")[0].strip()
            if not line:
                continue
            parts = line.split()
            op = parts[0].upper()
            self.commands.append((op, parts[1:]))

    def apply(self, tr: Transcription) -> Transcription:
        labs = [Label(l.name, l.start, l.end, l.score, list(l.aux))
                for l in tr.labels]
        for op, args in self.commands:
            if op == "EX":
                labs = self._expand(labs)
            elif op == "IS":
                if len(args) != 2:
                    HError(1030, "HLEd IS: needs two labels")
                labs = [Label(args[0])] + labs + [Label(args[1])]
            elif op == "DE":
                labs = [l for l in labs if l.name not in args]
            elif op == "RE":
                new, olds = args[0], set(args[1:])
                for l in labs:
                    if l.name in olds:
                        l.name = new
            elif op == "ME":
                labs = self._merge(labs, args[0], args[1:])
            elif op == "WB":
                self.boundaries.add(args[0])
            elif op == "NB":
                self.boundaries.discard(args[0])
            elif op == "TC":
                lctx = args[0] if len(args) > 0 else None
                rctx = args[1] if len(args) > 1 else None
                labs = self._triphones(labs, True, True, lctx, rctx)
            elif op == "LC":
                labs = self._triphones(labs, True, False,
                                       args[0] if args else None, None)
            elif op == "RC":
                labs = self._triphones(labs, False, True, None,
                                       args[0] if args else None)
            elif op == "SO":
                labs.sort(key=lambda l: (l.start if l.start is not None else 0))
            elif op == "CH":
                new, old = args[0], args[1]
                for l in labs:
                    if l.name == old:
                        l.name = new
            elif op == "SB":
                labs = [l for l in labs if l.name not in args]
            elif op == "DL":
                labs = []
            elif op == "FI":
                hits = [k for k, l in enumerate(labs) if l.name in args]
                print(f"HLEd FI {' '.join(args)}: "
                      f"{len(hits)} at {hits}")
            else:
                HRError(1150, "HLEd: unsupported command %s ignored", op)
        out = Transcription(alternatives=[labs])
        return out

    def _expand(self, labs: List[Label]) -> List[Label]:
        if self.vocab is None:
            HError(1030, "HLEd EX: no dictionary (-d)")
        out = []
        for l in labs:
            w = self.vocab.get(l.name)
            if w is None:
                HError(8621, "HLEd EX: word %s not in dictionary", l.name)
            for p in w.prons[0].phones:
                out.append(Label(p))
        return out

    def _merge(self, labs, new, seq):
        out = []
        i = 0
        n = len(seq)
        while i < len(labs):
            if [l.name for l in labs[i : i + n]] == list(seq):
                lab = Label(new, labs[i].start, labs[i + n - 1].end)
                out.append(lab)
                i += n
            else:
                out.append(labs[i])
                i += 1
        return out

    def _triphones(self, labs, use_l, use_r, lctx, rctx):
        out = []
        n = len(labs)
        for i, l in enumerate(labs):
            if l.name in self.boundaries:
                out.append(l)
                continue
            left = lctx
            right = rctx
            if i > 0 and labs[i - 1].name not in self.boundaries:
                left = labs[i - 1].name.split("-")[-1].split("+")[0]
            elif i > 0 and labs[i - 1].name in self.boundaries:
                left = lctx
            if i < n - 1 and labs[i + 1].name not in self.boundaries:
                right = labs[i + 1].name.split("-")[-1].split("+")[0]
            elif i < n - 1 and labs[i + 1].name in self.boundaries:
                right = rctx
            name = l.name
            if use_l and left:
                name = f"{left}-{name}"
            if use_r and right:
                name = f"{name}+{right}"
            out.append(Label(name, l.start, l.end, l.score, list(l.aux)))
        return out


def run(argv: List[str]) -> int:
    ta = parse_args("HLEd", argv, OPTS, min_args=1, usage=USAGE)
    script_file = ta.args[0]
    files = ta.script + ta.args[1:]
    vocab = read_dict(ta.get("d"), ta.config) if ta.has("d") else None

    ed = LabelEditor(vocab)
    ed.parse_script(open(script_file).read())

    mlfs = [MLF.load(p, ta.config) for p in ta.get_all("I")]
    out_mlf_path = ta.get("i")
    out_mlf = MLF() if out_mlf_path else None
    out_dir = ta.get("l")
    out_ext = ta.get("y", "lab")

    # -G / SOURCELABEL: TIMIT (.phn/.wrd sample-count times) and ESPS
    # label files convert here, the HTK-recipe entry point into MLFs
    src_fmt = (ta.get("G")
               or ta.config.str_("SOURCELABEL", "HTK", module="HLABEL")
               or "HTK")
    # inputs: label files or MLFs listed directly
    entries = []
    for fn in files:
        try:
            first = open(fn).readline().strip()
        except OSError as e:
            HError(6510, "HLEd: cannot open %s (%s)", fn, e)
        if first == "#!MLF!#":
            m = MLF.load(fn, ta.config)
            for pattern, tr in m.entries:
                entries.append((pattern, tr))
        else:
            entries.append((fn, load_label_file(fn, src_fmt, ta.config)))

    for key, tr in entries:
        new_tr = ed.apply(tr)
        stem = os.path.splitext(os.path.basename(key))[0]
        if out_mlf is not None:
            out_mlf.add(f"*/{stem}.{out_ext}", new_tr)
        else:
            path = os.path.join(out_dir or ".", f"{stem}.{out_ext}")
            save_label_file(path, new_tr)

    if out_mlf is not None:
        # times are written when the (edited) labels still carry them,
        # omitted otherwise (HLEd preserves label times through edits)
        out_mlf.save(out_mlf_path, cfg=ta.config)
        if ta.trace:
            print(f"HLEd: wrote {out_mlf_path} ({len(out_mlf.entries)} entries)")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
