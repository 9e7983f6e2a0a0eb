"""HVite — Viterbi word recognition over a word network, in torch.

The PyTorch counterpart of `htk_tpu/tools/hvite.py`'s recognition path
(`HTKTools/HVite.c`): the word network (-w SLF) expands with the
dictionary and HMM set (algo/net.compile_network) and every utterance
decodes with the token-passing recursion (algo/decode), whose frame loop
is the hand-written CUDA kernel on the card.

Usage: python -m htk_tpu_torch.tools.hvite [options] dictFile hmmList testFiles...

  -w netfile  recognition from word network (SLF)
  -s f        grammar/LM scale factor          -p f  word insertion penalty
  -r f        pronunciation scale (accepted)
  -i mlf      output recognised labels to MLF
  -l dir / -y ext   output label dir / extension
  -H mmf      load HMM macro file (repeatable)
  -t f / -u i genBeam / max active models: accepted and, as in htk_tpu
              on general word networks, not read by the decoder; the
              retry ladder (HREC: PRUNERETRYINC) runs as in htk_tpu
  -o flags    output format flags (as htk_tpu)
  -T n        trace (prints the decode device)

Not yet ported, each refused with HError 3290: alignment (-a), lattices
(-z), N-best (-n), input transforms (-J, and -k with a model-set input
transform), hybrid ANN decoding (-N), discrete sets, and live audio.

Config: HNET: FORCECXTEXP/ALLOWXWRDEXP/CFPHONES/SHAREINTERIORS,
HREC: DECODEBATCH (recognition batch size, default 8), PRUNERETRYINC,
HTKTPU: PRECISION, HTKTPU: PROFILE. Several files decode in length-sorted
buckets of DECODEBATCH utterances, one decode launch per bucket; a single
file takes the per-utterance path. The device is the CUDA card, or the
CPU when HTK_TPU_TORCH_DEVICE=cpu asks for it (tools/_common.py).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..algo.decode import decode, decode_batch
from ..algo.net import compile_network, word_internal_phone_map
from ..io.dictionary import read_dict
from ..io.mlf import MLF, Label, Transcription, save_label_file
from ..io.mmf import load_hmm_list, load_mmf
from ..io.slf import read_slf
from ..models.hmmset import compile_hmmset
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError
from ..utils.metrics import maybe_profile
from ._common import default_device, open_speech_file, outp_precision

USAGE = ("Usage: python -m htk_tpu_torch.tools.hvite [options] dictFile "
         "hmmList testFiles...")

OPTS = {
    "w": Option("w", 1, "recognise from network"),
    "a": Option("a", 0, "align from label files"),
    "m": Option("m", 0, "output model alignment"),
    "s": Option("s", 1, "LM scale", typ=float),
    "p": Option("p", 1, "word penalty", typ=float),
    "r": Option("r", 1, "pron scale", typ=float),
    "i": Option("i", 1, "output MLF"),
    "l": Option("l", 1, "output label dir"),
    "y": Option("y", 1, "output label ext"),
    "H": Option("H", 1, "load MMF", repeatable=True),
    "I": Option("I", 1, "input MLF", repeatable=True),
    "L": Option("L", 1, "input label dir"),
    "X": Option("X", 1, "input label ext"),
    "t": Option("t", 1, "genBeam pruning threshold", typ=float),
    "u": Option("u", 1, "max active models", typ=int),
    "b": Option("b", 1, "boundary word"),
    "o": Option("o", 1, "output format flags: N normalise scores, "
                "S no scores, T no times, W no words (-m), M no models"),
    "n": Option("n", 2, "n-best (accepted)", typ=int),
    "z": Option("z", 1, "output lattices with this extension"),
    "q": Option("q", 1, "lattice output format flags (accepted)"),
    "J": Option("J", 1, "input transform dir", repeatable=True),
    "k": Option("k", 0, "use input transforms"),
    "h": Option("h", 1, "speaker mask (accepted; global transform)"),
    "N": Option("N", 1, "ANN file for hybrid decoding"),
}

_NOT_PORTED = {
    "a": "alignment",
    "z": "lattice output",
    "n": "N-best output",
    "J": "input transforms",
    "N": "hybrid ANN decoding",
}


def _not_ported(what: str):
    HError(3290, "HVite: %s is not yet ported to htk_tpu_torch", what)


def _out_label_path(logical: str, out_dir: Optional[str], ext: str) -> str:
    stem = os.path.splitext(os.path.basename(logical))[0]
    name = f"{stem}.{ext}"
    return os.path.join(out_dir, name) if out_dir else name


def _retry_ladder(gen_beam, max_act, cfg):
    """The HFB.c-style retry escalation, decoder side: the beam widened
    twice, then unpruned."""
    inc = cfg.flt_("PRUNERETRYINC", 200.0, module="HREC")
    ladder = ([(gen_beam + inc, max_act), (gen_beam + 2 * inc, max_act)]
              if gen_beam is not None and inc > 0 else [])
    ladder.append((None, None))
    return ladder


def _transcription(res, period) -> Transcription:
    tr = Transcription(alternatives=[[]])
    for w, (t0, t1) in zip(res.words, res.times):
        tr.alternatives[0].append(Label(
            name=w, start=t0 * period, end=(t1 + 1) * period))
    return tr


def run(argv: List[str]) -> int:
    ta = parse_args("HVite", argv, OPTS, min_args=2, usage=USAGE)
    for opt, what in _NOT_PORTED.items():
        if ta.has(opt):
            _not_ported(f"-{opt} ({what})")
    gen_beam = float(ta.get("t")) if ta.has("t") else None
    max_act = int(ta.get("u")) if ta.has("u") else None
    if ta.trace and (gen_beam is not None or max_act is not None):
        print(f"HVite: pruning genBeam={gen_beam} maxActive={max_act} "
              "(recognition scans; alignment stays exact)")
    cfg = ta.config
    prec = outp_precision(cfg)
    dict_file, hmm_list_file = ta.args[0], ta.args[1]
    files = ta.script + ta.args[2:]
    src_kind = (cfg.str_("SOURCEKIND", "", module="HPARM") or "").upper()
    if not files and src_kind == "HAUDIO":
        _not_ported("live audio recognition (SOURCEKIND = HAUDIO)")
    if not files:
        HError(1030, "HVite: no test files\n%s", USAGE)

    mmfs = ta.get_all("H")
    if not mmfs:
        HError(1030, "HVite: at least one -H mmf required")
    hset = load_mmf(mmfs, cfg=ta.config)
    if ta.has("k") and hset.input_xform:
        _not_ported("-k (model-set input transform)")
    comp = compile_hmmset(hset)
    if comp.discrete:
        _not_ported("recognition with a discrete HMM set")
    device = default_device()
    if ta.trace:
        print(f"HVite: device {device}")

    vocab = read_dict(dict_file, ta.config)
    load_hmm_list(hmm_list_file, ta.config)  # validated for parity; comp holds models

    lm_scale = float(ta.get("s", 1.0) or 1.0)
    word_pen = float(ta.get("p", 0.0) or 0.0)
    out_mlf_path = ta.get("i")
    out_dir = ta.get("l")
    out_ext = ta.get("y", "rec")
    period = int(cfg.flt_("TARGETRATE", 100000.0, module="HPARM"))

    out_mlf = MLF() if out_mlf_path else None
    ofmt = (ta.get("o") or "").upper()
    sup_scores = "S" in ofmt
    sup_times = "T" in ofmt

    if not ta.has("w"):
        HError(1030, "HVite: either -w netfile or -a required\n%s", USAGE)
    lat = read_slf(ta.get("w"), ta.config)
    # HNet.c config: FORCECXTEXP forces full cross-word context
    # expansion; ALLOWXWRDEXP permits it when the set is context-
    # dependent. CFPHONES (own key [LC]) lists transparent phones.
    force_x = cfg.bool_("FORCECXTEXP", False, module="HNET") or False
    allow_x = cfg.bool_("ALLOWXWRDEXP", False, module="HNET") or False
    has_cd = any("-" in n or "+" in n for n in comp.names)
    if force_x or (allow_x and has_cd):
        cfp = (cfg.str_("CFPHONES", "sp", module="HNET") or "sp").split()
        share = bool(cfg.bool_("SHAREINTERIORS", True, module="HNET"))
        net = compile_network(lat, vocab, comp, cross_word=True,
                              cf_phones=cfp, share_interiors=share)
        if ta.trace and share:
            print("HVite: cross-word interiors shared "
                  f"({net.n_states} states)")
    else:
        pmap = word_internal_phone_map(comp.names)
        net = compile_network(lat, vocab, comp, phone_map=pmap)
    if ta.trace:
        print(
            f"HVite: network {net.n_nodes} nodes, {net.n_chains} chains, "
            f"{net.n_states} states"
        )

    entries, featl = [], []
    for fn in files:
        data, _p, _k, e = open_speech_file(fn, cfg)
        entries.append(e)
        featl.append(np.asarray(data))
    results: List = [None] * len(featl)
    with maybe_profile(cfg, "HVite"):
        if len(featl) > 1:
            # batched recognition: one decode launch per length-sorted
            # bucket, identical results to the per-utterance path
            order = sorted(range(len(featl)),
                           key=lambda i: featl[i].shape[0])
            bsz = int(cfg.int_("DECODEBATCH", 8, module="HREC") or 8)
            for i0 in range(0, len(order), bsz):
                idx = order[i0 : i0 + bsz]
                rs = decode_batch(net, comp, [featl[j] for j in idx],
                                  lm_scale, word_pen, precision=prec,
                                  beam=gen_beam, max_active=max_act,
                                  device=device)
                for j, r in zip(idx, rs):
                    results[j] = r
        else:
            results = [decode(net, comp, f, lm_scale, word_pen,
                              precision=prec, beam=gen_beam,
                              max_active=max_act, device=device)
                       for f in featl]
    if gen_beam is not None or max_act is not None:
        for j, r in enumerate(results):
            if r is not None:
                continue
            for b, ma in _retry_ladder(gen_beam, max_act, cfg):
                HRError(8525, "HVite: no tokens for %s under pruning; "
                              "retrying at %s", entries[j].logical,
                        "unpruned" if b is None else f"beam {b:.0f}")
                r = decode(net, comp, featl[j], lm_scale, word_pen,
                           precision=prec, beam=b, max_active=ma,
                           device=device)
                if r is not None:
                    results[j] = r
                    break
    for e, res in zip(entries, results):
        if res is None:
            HRError(8522, "HVite: no tokens survived for %s", e.logical)
            tr = Transcription(alternatives=[[]])
        else:
            tr = _transcription(res, period)
            if ta.trace:
                print(f"{e.logical}: {' '.join(res.words)}  "
                      f"[{res.score:.2f}]")
        _emit(tr, e.logical, out_mlf, out_dir, out_ext)

    if out_mlf is not None:
        out_mlf.save(out_mlf_path, with_times=not sup_times,
                     with_scores=(ta.has("m") and not sup_scores),
                     cfg=ta.config)
        if ta.trace:
            print(f"HVite: wrote {out_mlf_path}")
    return 0


def _emit(tr, logical, out_mlf, out_dir, out_ext):
    if out_mlf is not None:
        stem = os.path.splitext(os.path.basename(logical))[0]
        out_mlf.add(f"*/{stem}.{out_ext}", tr)
    else:
        save_label_file(_out_label_path(logical, out_dir, out_ext), tr)


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
