"""HNForward — ANN forward pass / posterior evaluation, in torch.

The PyTorch counterpart of `htk_tpu/tools/hnforward.py`
(`HTKTools/HNForward.c`, v3.5): runs the net over feature files on the
device and writes hybrid log-likelihoods (log posterior - log prior) or
log posteriors as HTK USER-kind feature files.

Usage: python -m htk_tpu_torch.tools.hnforward [options] hmmList testFiles...

  -N ann    ANN file (required)
  -M dir    output dir for posterior feature files (.pos)
  -y ext    output extension (default pos)
  -l        output log posteriors (default: hybrid loglik = logpost-logprior)
  -I mlf / -L / -X / -H   accepted, as in htk_tpu (no report reads them)
  Standard: -A -C -D -S -T -V

-T 1 prints each file's score shape. The device is the CUDA card, or the
CPU when HTK_TPU_TORCH_DEVICE=cpu asks for it (tools/_common.py).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..algo.nnet import hybrid_outp
from ..io import parmkind as pk
from ..io.htkfeat import write_htk_file
from ..models.ann import ANNModule, load_ann
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError
from ._common import default_device, open_speech_file

USAGE = ("Usage: python -m htk_tpu_torch.tools.hnforward [options] hmmList "
         "testFiles...")

OPTS = {
    "N": Option("N", 1, "ANN file"),
    "M": Option("M", 1, "output directory"),
    "y": Option("y", 1, "output extension"),
    "l": Option("l", 0, "output raw log posteriors"),
    "H": Option("H", 1, "GMM-HMM MMF", repeatable=True),
    "I": Option("I", 1, "reference MLF", repeatable=True),
    "L": Option("L", 1, "label dir"),
    "X": Option("X", 1, "label ext"),
}


def run(argv: List[str]) -> int:
    ta = parse_args("HNForward", argv, OPTS, min_args=1, usage=USAGE)
    cfg = ta.config
    files = ta.script + ta.args[1:]
    if not files:
        HError(1030, "HNForward: no test files\n%s", USAGE)
    if not ta.has("N"):
        HError(1030, "HNForward: -N ann file required")
    ann = load_ann(ta.get("N"))
    device = default_device()
    model = ANNModule(ann, device)
    out_dir = ta.get("M", ".")
    os.makedirs(out_dir, exist_ok=True)
    ext = ta.get("y", "pos")
    prior_scale = 0.0 if ta.has("l") else 1.0

    for fn in files:
        data, period, _k, e = open_speech_file(fn, cfg)
        scores = hybrid_outp(ann, data, prior_scale=prior_scale,
                             device=device, model=model).cpu().numpy()
        stem = os.path.splitext(os.path.basename(e.logical))[0]
        out = os.path.join(out_dir, f"{stem}.{ext}")
        write_htk_file(out, scores.astype(np.float32), period,
                       pk.str2parmkind("USER"))
        if ta.trace:
            print(f"{e.logical}: wrote {scores.shape} scores -> {out}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
