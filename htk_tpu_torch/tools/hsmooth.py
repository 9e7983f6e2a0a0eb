"""HSmooth — deleted-interpolation smoothing of mixture weights.

Mirrors `HTKTools/HSmooth.c`: for tied-mixture / multi-mixture systems,
each context-dependent state's mixture weights are interpolated with its
monophone parent's pooled weights, with the interpolation factor lambda
estimated by deleted interpolation over the HERest -p accumulator blocks
(leave-one-block-out EM, HSmooth's lambda loop).

Usage: HSmooth [options] hmmList accFile1 accFile2 [...]

  -H mmf   load HMM macro file (repeatable)   -M dir  output dir
  -b f     lambda floor (default 0.01)
  -e N     max EM iterations for lambda (default 10)
  Standard: -A -C -D -S -T -V

Copied from `htk_tpu/tools/hsmooth.py` into the PyTorch port: host code,
behaviour unchanged. The accumulators load through the port's
`parallel/acc_files.py`, the set is written back through
`models/hmmset.write_back`.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..algo.tree import parse_triphone
from ..io.mmf import load_hmm_list, load_mmf, save_mmf
from ..models.hmmset import compile_hmmset, write_back
from ..parallel.acc_files import load_accs
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError

USAGE = "Usage: HSmooth [options] hmmList accFile1 accFile2 ..."

OPTS = {
    "H": Option("H", 1, "load MMF", repeatable=True),
    "M": Option("M", 1, "output directory"),
    "b": Option("b", 1, "lambda floor", typ=float),
    "e": Option("e", 1, "max lambda iterations", typ=int),
}


def deleted_interpolation(block_counts: np.ndarray, pooled_w: np.ndarray,
                          n_iter: int = 10, floor: float = 0.01) -> float:
    """Estimate lambda for one state by leave-one-block-out EM.

    block_counts: (B, M) per-block mixture counts for this state.
    pooled_w: (M,) the smoothing (parent) distribution.
    """
    B, M = block_counts.shape
    total = block_counts.sum(axis=0)
    lam = 0.5
    for _ in range(n_iter):
        num = 0.0
        den = 0.0
        for b in range(B):
            held = block_counts[b]
            rest = total - held
            rsum = rest.sum()
            if rsum <= 0:
                continue
            w_detail = rest / rsum
            mix = lam * w_detail + (1.0 - lam) * pooled_w
            with np.errstate(divide="ignore", invalid="ignore"):
                post = np.where(mix > 0, lam * w_detail / np.maximum(mix, 1e-30), 0.0)
            num += float((held * post).sum())
            den += float(held.sum())
        if den <= 0:
            return 1.0
        lam = min(max(num / den, floor), 1.0 - floor)
    return lam


def run(argv: List[str]) -> int:
    ta = parse_args("HSmooth", argv, OPTS, min_args=2, usage=USAGE)
    mmfs = ta.get_all("H")
    if not mmfs:
        HError(1030, "HSmooth: at least one -H mmf required\n%s", USAGE)
    hset = load_mmf(mmfs, cfg=ta.config)
    load_hmm_list(ta.args[0], ta.config)
    comp = compile_hmmset(hset)
    acc_files = ta.args[1:] + ta.script
    if len(acc_files) < 2:
        HError(1030, "HSmooth: needs >= 2 accumulator blocks for deleted "
                     "interpolation")
    blocks = [load_accs(p) for p in acc_files]
    wt_blocks = np.stack([np.asarray(b.wt_occ) for b in blocks])  # (B, S, mm)

    # monophone parent weights: pool wt counts over each phone's triphone
    # family at each state position
    S, mm = comp.state_mix.shape
    total_wt = wt_blocks.sum(axis=0)  # (S, mm)
    parent_counts: Dict[tuple, np.ndarray] = {}
    state_key: Dict[int, tuple] = {}
    for hi, name in enumerate(comp.names):
        base = parse_triphone(name)[1]
        n = int(comp.model_nstates[hi])
        for k in range(n - 2):
            sid = int(comp.model_states[hi, k])
            key = (base, k)
            state_key[sid] = key
            parent_counts.setdefault(key, np.zeros(mm))
            parent_counts[key] += total_wt[sid]

    floor = float(ta.get("b", 0.01) or 0.01)
    n_iter = int(ta.get("e", 10) or 10)
    old_w = np.where(comp.state_mix >= 0, np.exp(comp.state_logw), 0.0)
    new_w = old_w.copy()
    n_smoothed = 0
    for sid in range(S):
        key = state_key.get(sid)
        if key is None:
            continue
        pooled = parent_counts[key]
        psum = pooled.sum()
        if psum <= 0:
            continue
        pooled_w = pooled / psum
        counts = wt_blocks[:, sid, :]
        if counts.sum() <= 0:
            continue
        lam = deleted_interpolation(counts, pooled_w, n_iter, floor)
        detail = counts.sum(axis=0)
        dsum = detail.sum()
        w_detail = detail / dsum if dsum > 0 else old_w[sid]
        w = lam * w_detail + (1.0 - lam) * pooled_w
        mask = comp.state_mix[sid] >= 0
        w = np.where(mask, w, 0.0)
        ws = w.sum()
        if ws > 0:
            new_w[sid] = w / ws
            n_smoothed += 1
    write_back(comp, weights=new_w.astype(np.float32))

    out_dir = ta.get("M", ".")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, os.path.basename(mmfs[0]))
    save_mmf(hset, out, binary=ta.binary)
    if ta.trace:
        print(f"HSmooth: smoothed {n_smoothed} states over "
              f"{len(blocks)} blocks -> {out}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
