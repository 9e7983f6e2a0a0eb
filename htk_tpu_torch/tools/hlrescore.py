"""HLRescore — lattice rescoring, pruning and best-path extraction.

Mirrors `HTKTools/HLRescore.c`: reads word lattices, optionally applies a
new LM and/or pruning, and writes the best path as labels and/or the
processed lattice.

Usage: HLRescore [options] dictFile latFiles...

  -f        find best path, output transcription
  -i mlf    output transcriptions to MLF
  -l dir    output label/lattice dir
  -n lm     apply a new ARPA LM to arc scores
  -t f      prune lattice with posterior beam f
  -w        write the processed lattice
  -y ext    output lattice extension (default lat)
  -s f      LM scale override       -p f   word penalty override
  Standard: -A -C -D -S -T -V

Copied from `htk_tpu/tools/hlrescore.py` into the PyTorch port: host
code on the port's algo/latops, behaviour unchanged. The port cannot
use htk_tpu, whose utils package pulls in JAX.
"""

from __future__ import annotations

import os
from typing import List

from ..algo.latops import apply_lm, best_path, prune
from ..io.dictionary import read_dict
from ..io.lm import read_lm
from ..io.mlf import MLF, Label, Transcription
from ..io.slf import read_slf, write_slf
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError

USAGE = "Usage: HLRescore [options] dictFile latFiles..."

OPTS = {
    "f": Option("f", 0, "find best path"),
    "i": Option("i", 1, "output MLF"),
    "l": Option("l", 1, "output directory"),
    "n": Option("n", 1, "new ARPA LM"),
    "t": Option("t", 1, "posterior prune beam", typ=float),
    "w": Option("w", 0, "write processed lattice"),
    "y": Option("y", 1, "output lattice extension"),
    "s": Option("s", 1, "LM scale", typ=float),
    "p": Option("p", 1, "word penalty", typ=float),
}


def run(argv: List[str]) -> int:
    ta = parse_args("HLRescore", argv, OPTS, min_args=1, usage=USAGE)
    read_dict(ta.args[0], ta.config)  # parity: dict validates word coverage
    lat_files = ta.script + ta.args[1:]
    if not lat_files:
        HError(1030, "HLRescore: no lattice files\n%s", USAGE)

    lm = read_lm(ta.get("n"), ta.config) if ta.has("n") else None
    out_mlf_path = ta.get("i")
    out_mlf = MLF() if out_mlf_path else None
    out_dir = ta.get("l", ".")
    lat_ext = ta.get("y", "lat")

    for lf in lat_files:
        lat = read_slf(lf, ta.config)
        stem = os.path.splitext(os.path.basename(lf))[0]
        if lm is not None:
            lat = apply_lm(lat, lm)
        if ta.has("t"):
            lat = prune(lat, float(ta.get("t")))
        lmscale = float(ta.get("s")) if ta.has("s") else None
        wdpen = float(ta.get("p")) if ta.has("p") else None
        if ta.has("f") or out_mlf is not None:
            score, path = best_path(lat, lmscale, wdpen)
            if not path:
                HRError(8523, "HLRescore: no path through %s", lf)
            tr = Transcription(alternatives=[[
                Label(name=w, start=None, end=int(t * 1e7)) for w, t, _a in path
            ]])
            if ta.trace:
                print(f"{stem}: {' '.join(w for w, _t, _a in path)} [{score:.2f}]")
            if out_mlf is not None:
                out_mlf.add(f"*/{stem}.rec", tr)
        if ta.has("w"):
            os.makedirs(out_dir, exist_ok=True)
            write_slf(lat, os.path.join(out_dir, f"{stem}.{lat_ext}"))

    if out_mlf is not None:
        out_mlf.save(out_mlf_path, with_times=False, cfg=ta.config)
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
