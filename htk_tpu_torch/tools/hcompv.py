"""HCompV — flat-start initialisation and variance flooring.

Mirrors `HTKTools/HCompV.c`: computes the global mean and variance of the
training corpus, clones them into every state of the prototype HMM, and
optionally writes a variance-floor macro file (`vFloors`).

Usage: HCompV [options] hmmfile trainfiles...

  -f f    output vFloors file with floor = f * global variance
  -m      update means as well as variances
  -o name name for the output HMM (default: proto's name)
  -M dir  output MMF directory
  -l lab  use only segments carrying this label (-I mlf / -L dir / -X ext)
  -B      binary MMF output
  Standard: -A -C -D -S -T -V

Copied from `htk_tpu/tools/hcompv.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..io.mmf import load_mmf, save_mmf
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError
from ._common import open_speech_file
from .hinit import collect_segments

USAGE = "Usage: HCompV [options] hmmfile trainfiles..."

OPTS = {
    "f": Option("f", 1, "variance floor scale", typ=float),
    "m": Option("m", 0, "update means"),
    "o": Option("o", 1, "output hmm name"),
    "M": Option("M", 1, "output directory"),
    "l": Option("l", 1, "use only segments with this label"),
    "I": Option("I", 1, "input MLF", repeatable=True),
    "L": Option("L", 1, "label directory"),
    "X": Option("X", 1, "label extension"),
    "v": Option("v", 1, "minimum variance", typ=float),
}


def run(argv: List[str]) -> int:
    ta = parse_args("HCompV", argv, OPTS, min_args=1, usage=USAGE)
    cfg = ta.config
    hmm_file = ta.args[0]
    train = ta.args[1:] + ta.script
    if not train:
        HError(1030, "HCompV: no training files\n%s", USAGE)

    hset = load_mmf(hmm_file, cfg=ta.config)
    if not hset.hmms:
        HError(7035, "HCompV: no HMM in %s", hmm_file)
    proto_name = next(iter(hset.hmms))
    proto = hset.hmms[proto_name]

    # accumulate global stats (single pass, f64 accumulators); with -l
    # only the frames inside segments carrying that label contribute
    # (HCompV.c's CalcMeanVar over the chosen segment list)
    seg_label = ta.get("l")
    if seg_label:
        from ..io.mlf import MLF

        mlfs = [MLF.load(p, ta.config) for p in ta.get_all("I")]
        segs = collect_segments(train, cfg, seg_label, mlfs, ta.get("L"),
                                ta.get("X", "lab"), None)
    else:
        segs = None

    n = 0
    s1 = None
    s2 = None
    sources = (segs if segs is not None
               else train)
    for f in sources:
        if segs is not None:
            x = np.asarray(f, np.float64)
            logical = "(segment)"
        else:
            data, period, kind, e = open_speech_file(f, cfg)
            x = data.astype(np.float64)
            logical = e.logical
        if s1 is None:
            s1 = x.sum(axis=0)
            s2 = (x * x).sum(axis=0)
        else:
            s1 += x.sum(axis=0)
            s2 += (x * x).sum(axis=0)
        n += x.shape[0]
        if ta.trace:
            print(f"  accumulating {logical}: {x.shape[0]} frames")
    if n < 2:
        HError(2021, "HCompV: insufficient training data (%d frames)", n)
    mean = s1 / n
    var = s2 / n - mean * mean
    min_var = float(ta.get("v", 0.0) or 0.0)
    var = np.maximum(var, max(min_var, 1e-10))
    if ta.trace:
        print(f"HCompV: {n} frames from {len(train)} files")

    dim = hset.vec_size or len(mean)
    if len(mean) != dim:
        HError(7023, "HCompV: data width %d != model vecsize %d", len(mean), dim)

    update_means = ta.has("m")
    for si in proto.states:
        for mp in si.streams[0].mixes:
            if mp is None:
                continue
            if update_means:
                mp.mean = mean.astype(np.float32).copy()
            mp.var = var.astype(np.float32).copy()
            mp.fix_gconst()

    out_name = ta.get("o", proto_name)
    if out_name != proto_name:
        proto.name = out_name
        hset.hmms = {out_name: proto}
        hset.macros["h"] = {out_name: proto}

    out_dir = ta.get("M", ".")
    os.makedirs(out_dir, exist_ok=True)
    save_mmf(hset, os.path.join(out_dir, out_name), binary=ta.binary)

    if ta.has("f"):
        floor_scale = float(ta.get("f"))
        vfloor = (var * floor_scale).astype(np.float32)
        vf_path = os.path.join(out_dir, "vFloors")
        with open(vf_path, "w") as f:
            f.write('~v "varFloor1"\n')
            f.write(f"<VARIANCE> {dim}\n")
            f.write(" " + " ".join("%.6e" % v for v in vfloor) + "\n")
        if ta.trace:
            print(f"HCompV: wrote {vf_path}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
