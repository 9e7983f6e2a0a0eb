"""HInit — isolated-unit HMM initialisation, on htk_tpu_torch.

Mirrors `HTKTools/HInit.c`: collects the training segments for one model
(label-bounded via -l, or whole files), uniform-segments them across the
emitting states, k-means clusters each state's frames into the mixture
components, then iterates Viterbi segmentation / parameter update until
the total alignment score converges.

The port of `htk_tpu/tools/hinit.py`: the same host code, with each
segment's Viterbi alignment (algo/viterbi) on `default_device()`: the
CUDA card, or the CPU when HTK_TPU_TORCH_DEVICE=cpu asks for it.

Usage: HInit [options] hmmFile trainFiles...

  -l label  use only segments with this label       -o name  output name
  -i N      max estimation iterations (default 20)  -v f     min variance
  -e f      convergence epsilon (default 1e-4)      -M dir   output dir
  -I mlf / -L dir / -X ext   where transcriptions live
  -m N      min examples (warn below; default 3)
  Standard: -A -C -D -S -T -V
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..algo.composite import build_composite
from ..algo.kmeans import segment_kmeans_gmm
from ..algo.viterbi import align
from ..io.mlf import MLF, find_labels
from ..io.mmf import load_mmf, save_mmf
from ..models.hmmset import compile_hmmset
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError
from ._common import default_device, open_speech_file

USAGE = ("Usage: python -m htk_tpu_torch.tools.hinit [options] "
         "hmmFile trainFiles...")

OPTS = {
    "l": Option("l", 1, "segment label"),
    "o": Option("o", 1, "output hmm name"),
    "i": Option("i", 1, "max iterations", typ=int),
    "v": Option("v", 1, "minimum variance", typ=float),
    "e": Option("e", 1, "convergence epsilon", typ=float),
    "M": Option("M", 1, "output directory"),
    "I": Option("I", 1, "input MLF", repeatable=True),
    "L": Option("L", 1, "label directory"),
    "X": Option("X", 1, "label extension"),
    "m": Option("m", 1, "min examples", typ=int),
    "u": Option("u", 1, "update flags"),
}


def collect_segments(files, cfg, label, mlfs, label_dir, label_ext, period_hint):
    """Per-file feature segments for the target label (HInit main loop)."""
    segs = []
    for fn in files:
        data, period, kind, e = open_speech_file(fn, cfg)
        if label is None:
            segs.append(data)
            continue
        tr = find_labels(e.logical, mlfs, label_dir, label_ext)
        for lab in tr.labels:
            if lab.name != label:
                continue
            if lab.start is None or lab.end is None:
                segs.append(data)
                continue
            t0 = int(lab.start // period)
            t1 = int(lab.end // period)
            if t1 > t0:
                segs.append(data[t0 : min(t1, data.shape[0])])
    return segs


def run(argv: List[str]) -> int:
    ta = parse_args("HInit", argv, OPTS, min_args=1, usage=USAGE)
    cfg = ta.config
    hmm_file = ta.args[0]
    files = ta.script + ta.args[1:]
    if not files:
        HError(1030, "HInit: no training files\n%s", USAGE)

    hset = load_mmf(hmm_file, cfg=ta.config)
    device = default_device()
    name = next(iter(hset.hmms))
    h = hset.hmms[name]
    n_emit = h.nstates - 2
    min_var = float(ta.get("v", 1e-4) or 1e-4)
    max_iter = int(ta.get("i", 20) or 20)
    eps = float(ta.get("e", 1e-4) or 1e-4)

    mlfs = [MLF.load(p, ta.config) for p in ta.get_all("I")]
    segs = collect_segments(
        files, cfg, ta.get("l"), mlfs, ta.get("L"), ta.get("X", "lab"),
        None,
    )
    segs = [s for s in segs if s.shape[0] >= n_emit]
    min_ex = int(ta.get("m", 3) or 3)
    if not segs:
        HError(2121, "HInit: no usable training segments")
    if len(segs) < min_ex:
        HRError(2131, "HInit: only %d example(s) (min %d)", len(segs), min_ex)

    # uniform segmentation: frame t of a T-frame segment -> state T*j/T
    def assignments_uniform(seg):
        T = seg.shape[0]
        return np.minimum((np.arange(T) * n_emit) // T, n_emit - 1)

    def update_from_assign(assign_list):
        for j in range(n_emit):
            frames = np.concatenate(
                [seg[a == j] for seg, a in zip(segs, assign_list)], axis=0
            )
            if frames.shape[0] == 0:
                HRError(2132, "HInit: state %d has no frames", j + 2)
                continue
            se = h.states[j].streams[0]
            nmix = len(se.mixes)
            w, m, v = segment_kmeans_gmm(frames, nmix, min_var)
            for k, mp in enumerate(se.mixes):
                mp.mean = m[k].astype(np.float32)
                mp.var = np.maximum(v[k], min_var).astype(np.float32)
                mp.fix_gconst()
                se.weights[k] = float(w[k])
        # transition counts from assignments
        tp = np.zeros((h.nstates, h.nstates), np.float64)
        for a in assign_list:
            tp[0, 1 + a[0]] += 1
            for t in range(1, len(a)):
                tp[1 + a[t - 1], 1 + a[t]] += 1
            tp[1 + a[-1], h.nstates - 1] += 1
        rs = tp.sum(axis=1, keepdims=True)
        with np.errstate(invalid="ignore"):
            tpn = np.where(rs > 0, tp / np.maximum(rs, 1), 0.0)
        tpn[h.nstates - 1, :] = 0.0
        h.transp = tpn.astype(np.float32)

    assigns = [assignments_uniform(s) for s in segs]
    update_from_assign(assigns)

    prev = None
    for it in range(max_iter):
        comp = compile_hmmset(hset)
        hmm = build_composite(comp, [comp.model_id(name)])
        total = 0.0
        new_assigns = []
        for seg in segs:
            res = align(comp, hmm, seg, device=device)
            total += res.score
            new_assigns.append(res.states.astype(np.int64))
        if ta.trace:
            print(f"HInit: iter {it + 1} total score {total:.2f}")
        update_from_assign(new_assigns)
        if prev is not None and abs(total - prev) <= eps * abs(prev):
            break
        prev = total

    out_name = ta.get("o", name)
    if out_name != name:
        h.name = out_name
        hset.hmms = {out_name: h}
        hset.macros["h"] = {out_name: h}
    out_dir = ta.get("M", ".")
    os.makedirs(out_dir, exist_ok=True)
    save_mmf(hset, os.path.join(out_dir, out_name), binary=ta.binary)
    if ta.trace:
        print(f"HInit: saved {os.path.join(out_dir, out_name)}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
