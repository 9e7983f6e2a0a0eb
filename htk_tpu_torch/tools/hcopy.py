"""HCopy — copy/convert speech files (feature extraction CLI).

Mirrors `HTKTools/HCopy.c`: each (src, tgt) pair is read via the HParm
buffer (waveform -> TARGETKIND conversion happens here) and written as an
HTK feature file. Multiple sources can be concatenated with `+`. The scp
form lists `src tgt` pairs per line.

Usage: python -m htk_tpu_torch.tools.hcopy [options] src [ + src2 ...] tgt  or  -S scp (src tgt pairs)

Supported options (HCopy.c):
  -s t / -e t   copy only the window [t, e) (HTK 100 ns units)
  -x label      extract the segment with this label (see -n)
  -n i          occurrence index for -x (default 1)
  -I mlf / -L dir / -X ext   label sources for -x
  Standard: -A -C -D -S -T -V
Config: TARGETKIND, SOURCEFORMAT, SOURCERATE, SAVECOMPRESSED (_C),
SAVEWITHCRC (_K), plus all HPARM frontend keys.

Copied from `htk_tpu/tools/hcopy.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX. The waveform frontend runs in torch on the
tool's device (tools/_common.default_device): the CUDA card, or the CPU
when HTK_TPU_TORCH_DEVICE=cpu asks for it.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..io import parmkind as pk
from ..io.htkfeat import write_htk_file
from ..io.mlf import MLF, find_labels
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError
from ._common import default_device, open_speech_file

USAGE = ("Usage: python -m htk_tpu_torch.tools.hcopy [options] src "
         "[ + src2 ...] tgt\n       python -m htk_tpu_torch.tools.hcopy "
         "[options] -S scp")

OPTS = {
    "s": Option("s", 1, "start time (100ns)", typ=float),
    "e": Option("e", 1, "end time (100ns)", typ=float),
    "x": Option("x", 1, "extract segments with label"),
    "n": Option("n", 1, "label occurrence index", typ=int),
    "I": Option("I", 1, "label MLF", repeatable=True),
    "L": Option("L", 1, "label dir"),
    "X": Option("X", 1, "label extension"),
    "i": Option("i", 1, "output MLF (accepted)"),
    "l": Option("l", 1, "output label dir (accepted)"),
}


def run(argv: List[str]) -> int:
    ta = parse_args("HCopy", argv, OPTS, usage=USAGE)
    cfg = ta.config
    device = default_device()
    if ta.trace:
        print(f"HCopy: device {device}")
    mlfs = [MLF.load(p, ta.config) for p in ta.get_all("I")]

    pairs = []
    if ta.script:
        toks = ta.script
        if len(toks) % 2:
            HError(1030, "HCopy: -S script must hold src tgt pairs")
        pairs = [(toks[i], toks[i + 1]) for i in range(0, len(toks), 2)]
    args = ta.args
    if args:
        # src [+ src2 ...] tgt
        srcs, tgt = args[:-1], args[-1]
        srcs = [s for s in srcs if s != "+"]
        if not srcs:
            HError(1030, "HCopy: no source files\n%s", USAGE)
        pairs.append((tuple(srcs), tgt))
    if not pairs:
        HError(1030, "HCopy: no files to process\n%s", USAGE)

    save_comp = cfg.bool_("SAVECOMPRESSED", False, module="HPARM")
    save_crc = cfg.bool_("SAVEWITHCRC", False, module="HPARM")

    # two-pass over chunks of the scp: open every source first (waveform
    # frontends DEFERRED), run one batched feature extraction per chunk
    # (compute_features_batch — amortises the per-file device dispatch
    # that dominates corpus preparation), then window/quantise/write each
    # pair exactly as before
    from ..ops.dsp import compute_features_batch
    from ._common import DeferredWave

    # HPARM: BATCHFRONTEND — batch waveform frontends across the scp.
    # Pays on the card (amortises the per-file launch floor), so the
    # default is on where the device is CUDA and off on the CPU.
    batch_fe = cfg.bool_("BATCHFRONTEND", device.type == "cuda",
                         module="HPARM")

    CHUNK = 256
    for c0 in range(0, len(pairs), CHUNK):
        block = pairs[c0 : c0 + CHUNK]
        opened = []
        jobs = []
        for src, tgt in block:
            srcs = src if isinstance(src, tuple) else (src,)
            rs = []
            for s in srcs:
                r = open_speech_file(s, cfg, defer_frontend=batch_fe)
                if isinstance(r, DeferredWave):
                    jobs.append(r)
                rs.append(r)
            opened.append((srcs, rs, tgt))
        if jobs:
            feats_l = compute_features_batch(
                [(j.samples, j.fcfg) for j in jobs], device=device)
            for j, f in zip(jobs, feats_l):
                j.feats = f
        for srcs, rs, tgt in opened:
            _convert_one(ta, cfg, mlfs, srcs, rs, tgt, save_comp, save_crc)
    return 0


def _convert_one(ta, cfg, mlfs, srcs, rs, tgt, save_comp, save_crc):
    from ._common import DeferredWave

    chunks = []
    period = None
    kind = None
    for r in rs:
        if isinstance(r, DeferredWave):
            feats = r.feats
            period = int(r.fcfg.target_rate)
            kind = r.fcfg.target_kind & ~(pk.HASCOMPX | pk.HASCRCC)
            e = r.entry
        else:
            feats, period, kind, e = r
        chunks.append(feats)
    data = np.concatenate(chunks, axis=0) if len(chunks) > 1 else chunks[0]

    # windowing / label extraction (HCopy -s/-e/-x)
    if ta.has("s") or ta.has("e"):
        t0 = int(float(ta.get("s", 0.0) or 0.0) // period)
        t1 = (int(float(ta.get("e")) // period) if ta.has("e")
              else data.shape[0])
        data = data[t0 : max(t1, t0 + 1)]
    if ta.has("x"):
        want = ta.get("x")
        occ = int(ta.get("n", 1) or 1)
        tr = find_labels(e.logical, mlfs, ta.get("L"), ta.get("X", "lab"))
        hits = [l for l in tr.labels if l.name == want
                and l.start is not None and l.end is not None]
        if len(hits) < occ:
            HError(1030, "HCopy: label %s occurrence %d not found in %s",
                   want, occ, e.logical)
        lab = hits[occ - 1]
        data = data[int(lab.start // period) : int(lab.end // period)]
    out_kind = kind
    # DISCRETE / _V target: vector-quantise against HPARM: VQTABLE
    # (HParm.c's VQ path feeding DISCRETE systems)
    tk = cfg.str_("TARGETKIND", None, module="HPARM")
    tkc = pk.str2parmkind(tk) if tk else None
    if tkc is not None and (
            pk.base_kind(tkc) == pk.BASE_KINDS.index("DISCRETE")
            or (tkc & pk.HASVQ)):
        from ..io.vq import load_vq

        vq_path = cfg.str_("VQTABLE", None, module="HPARM")
        if not vq_path:
            HError(6350,
                   "HCopy: DISCRETE/_V output needs HPARM: VQTABLE")
        vq = load_vq(vq_path)
        cols, o = [], 0
        x = np.asarray(data, np.float32)
        for s, cb in enumerate(vq.codebooks):
            w = cb.shape[1]
            cols.append(vq.quantize(x[:, o : o + w], s))
            o += w
        if o != data.shape[1]:
            HError(6350, "HCopy: VQ table width %d != feature width %d",
                   o, data.shape[1])
        data = np.stack(cols, axis=1).astype(np.int16)
        out_kind = pk.BASE_KINDS.index("DISCRETE") | pk.HASVQ
    if save_comp:
        out_kind |= pk.HASCOMPX
    if save_crc:
        out_kind |= pk.HASCRCC
    from ..utils.filters import filtered_output

    with filtered_output(tgt, "HPARMOFILTER", ta.config) as _tgt:
        write_htk_file(_tgt, data, period, out_kind)
    if ta.trace:
        print(
            f"{' + '.join(srcs)} -> {tgt} "
            f"[{data.shape[0]} frames, {data.shape[1]} dim, "
            f"{pk.parmkind2str(out_kind)}]"
        )


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
