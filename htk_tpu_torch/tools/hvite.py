"""HVite — Viterbi word recognition and forced alignment, in torch.

The PyTorch counterpart of `htk_tpu/tools/hvite.py` (`HTKTools/HVite.c`):
recognition mode expands a word network (-w SLF) with the dictionary and
HMM set (algo/net.compile_network) and every utterance decodes with the
token-passing recursion (algo/decode), whose frame loop is the
hand-written CUDA kernel on the card; alignment mode (-a) builds a
composite HMM from each utterance's word transcription (expanded through
the dictionary) and runs the max-plus alignment scan (algo/viterbi),
emitting phone- or word-level label files.

Usage: python -m htk_tpu_torch.tools.hvite [options] dictFile hmmList testFiles...

  -w netfile  recognition from word network (SLF)
  -a          align from word transcriptions (-I mlf / -L dir / -X ext)
  -m          output model (phone) alignment with times
  -b word     boundary word inserted around alignment (e.g. silence)
  -s f        grammar/LM scale factor          -p f  word insertion penalty
  -r f        pronunciation scale (accepted)
  -i mlf      output recognised/aligned labels to MLF
  -l dir / -y ext   output label dir / extension
  -H mmf      load HMM macro file (repeatable)
  -t f / -u i genBeam / max active models: accepted and, as in htk_tpu
              on general word networks, not read by the decoder; the
              retry ladder (HREC: PRUNERETRYINC) runs as in htk_tpu
  -o flags    output format flags (as htk_tpu)
  -z ext      write word lattices (one recursion shared with the 1-best);
              with -a, the aligned 1-best as a linear numerator lattice
  -n i N      N-best output from the lattice
  -N annfile  hybrid decoding: the ANN's log-posteriors minus log-priors
              (algo/nnet.hybrid_outp) replace the GMM OutP
  -J dir      input transform dir (repeatable; per-speaker chains compose,
              a "global" TMF acts as the parent transform)
  -h mask     speaker mask for -J selection
  -k          the MMF's own input transform (~a, HHEd XF) is the base of
              every utterance's chain
  -T n        trace (prints the decode device)

Input transforms (tools/_xfcli.py): CMLLR legs transform the features;
MLLRMEAN (with MLLRVAR), regression-class MLLR, MLLRCOV and base-class
CMLLR transform the set in place per utterance (`write_back`, the last
two through the full-covariance scorer), and each in-place change drops
the device scorer cached on the set, so the next decode scores the
adapted Gaussians. A set loaded full-covariance adapts with MLLRMEAN and
plain CMLLR only (HError 7450 otherwise), as in the reference.

A discrete set (DISCRETE or _V feature files) reads its codewords as
int64 columns; their table-lookup scores (algo/fb_discrete.
discrete_state_scores, a device tensor, one utterance at a time) feed
the decoder's `state_scores_list` hook in place of OutP, as the ANN's
do under -N.

Live mode (HVite.c with SOURCEKIND = HAUDIO and no files): samples
stream from the audio source (io/audio.py; HAUDIO: AUDIOSOURCE = <file>
replays a file) through the streaming frontend (ops/stream.py) and the
streaming decoder (algo/stream_decode.py), one decode launch a chunk of
32 frames from the carried state; -T 2 prints the partial traceback
after each 0.25 s read, -T 1 the final `live:` line.

Config: HNET: FORCECXTEXP/ALLOWXWRDEXP/CFPHONES/SHAREINTERIORS,
HREC: DECODEBATCH (recognition batch size, default 8), LATTICEBEAM,
PRUNERETRYINC, HTKTPU: PRECISION, HTKTPU: PROFILE. Files decode in
length-sorted buckets of DECODEBATCH utterances, one decode launch per
bucket, and with -z or -n each bucket's lattices and 1-bests come from
that one launch; -N, discrete sets and feature-space (CMLLR) transform
chains batch too. Under model-space transform chains, which change the
set before each decode, a bucket is one utterance; so is each retry of
the ladder. The device is the CUDA card, or the CPU when
HTK_TPU_TORCH_DEVICE=cpu asks for it (tools/_common.py).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..algo import adapt
from ..algo.composite import build_composite
from ..algo.decode import decode_batch, generate_lattice_batch
from ..algo.fb_discrete import discrete_state_scores
from ..algo.latops import nbest_paths
from ..algo.nnet import hybrid_outp
from ..algo.net import compile_network, word_internal_phone_map
from ..algo.stream_decode import StreamingDecoder
from ..algo.viterbi import align
from ..io.audio import open_audio_input
from ..io.dictionary import read_dict
from ..io.mlf import MLF, Label, Transcription, find_labels, save_label_file
from ..io.mmf import load_hmm_list, load_mmf
from ..io.slf import NULL_WORD, LArc, Lattice, LNode, read_slf, write_slf
from ..models.ann import ANNModule, load_ann, require_feedforward
from ..models.hmmset import compile_hmmset, drop_device_caches, write_back
from ..ops.dsp import FrontendConfig
from ..ops.stream import StreamingFrontend
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError
from ..utils.metrics import maybe_profile
from ._common import (default_device, open_speech_file, outp_precision,
                      preload_corpus, _retry_ladder)
from ._xfcli import load_input_transforms, resolve_chain

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
    "n": Option("n", 2, "n-best", typ=int),
    "z": Option("z", 1, "output lattices with this extension"),
    "q": Option("q", 1, "lattice output format flags (accepted)"),
    "J": Option("J", 1, "input transform dir", repeatable=True),
    "k": Option("k", 0, "use input transforms"),
    "h": Option("h", 1, "speaker mask for -J selection"),
    "N": Option("N", 1, "ANN file for hybrid decoding"),
}


def _out_label_path(logical: str, out_dir: Optional[str], ext: str) -> str:
    stem = os.path.splitext(os.path.basename(logical))[0]
    name = f"{stem}.{ext}"
    return os.path.join(out_dir, name) if out_dir else name


def _transcription(res, period) -> Transcription:
    tr = Transcription(alternatives=[[]])
    for w, (t0, t1) in zip(res.words, res.times):
        tr.alternatives[0].append(Label(
            name=w, start=t0 * period, end=(t1 + 1) * period))
    return tr


def _nbest_transcription(lat, nbest, vocab, logical, trace):
    """N-best sentences from the utterance's lattice (HVite -n), mapped
    through the dictionary's output symbols ('' = suppressed)."""
    alts = nbest_paths(lat, nbest, lmscale=1.0, wdpenalty=0.0) if lat else []

    def outsym(w):
        wd = vocab.get(w)
        if wd is None or wd.prons[0].out_sym is None:
            return w
        return wd.prons[0].out_sym

    tr = Transcription(alternatives=[])
    for _s, path in alts:
        tr.alternatives.append([Label(name=outsym(w), end=int(t * 1e7))
                                for w, t in path if outsym(w)])
    if not tr.alternatives:
        tr.alternatives = [[]]
    if trace:
        for k, (s, path) in enumerate(alts):
            print(f"{logical} [{k + 1}]: "
                  f"{' '.join(w for w, _t in path)} [{s:.2f}]")
    return tr


def _has_model_xf(chain) -> bool:
    return any(isinstance(x, tuple) or x.kind in ("MLLRMEAN", "MLLRCOV")
               for x in chain)


def _has_var_xf(chain) -> bool:
    return any((any(y.var_scale is not None for y in x[1])
                if isinstance(x, tuple) else x.var_scale is not None)
               for x in chain)


def _input_transforms(ta, hset, comp):
    """-J/-h/-k: returns (adapt_for, model_space). `adapt_for(logical,
    data)` applies the utterance's transform chain: it returns the data
    with the chain's feature-space legs applied and sets the compiled set
    to the chain's model-space parameters (restoring the base ones for a
    speaker without any). `model_space` says whether any chain touches
    the set; `adapt_for` is None without transforms."""
    xforms = load_input_transforms(ta.get_all("J"), ta.trace, "HVite")
    spk_mask = ta.get("h")
    # -k: the model set's own ~a input transform (HHEd XF) becomes the
    # base of every utterance's chain
    base_xf = None
    if ta.has("k") and hset.input_xform:
        _bnm, base_xf = adapt.load_tmf_text(hset.input_xform)
        if ta.trace:
            print(f"HVite: using MMF input transform ({base_xf.kind})")
        if not xforms:
            xforms = {"global": [base_xf]}
            base_xf = None
    if not xforms:
        return None, False
    base_means = comp.means.copy()
    base_vars = comp.variances.copy()
    base_gconsts = comp.gconsts.copy()
    # a set that loaded full-covariance (as opposed to one a transform
    # promotes to the FULLC scorer below) adapts means only: MLLRMEAN
    # moves fc_mu, CMLLR stays in feature space, and anything that would
    # re-Cholesky against the placeholder diagonal variances is refused
    native_fc = bool(comp.full_cov)
    if native_fc:
        for chain in xforms.values():
            for x in chain:
                bad = ((x[1] and x[1][0].kind == "CMLLR")
                       or any(y.var_scale is not None for y in x[1])
                       ) if isinstance(x, tuple) else (
                           x.kind == "MLLRCOV" or x.var_scale is not None)
                if bad:
                    HError(7450, "HVite: full-covariance sets adapt with "
                                 "MLLRMEAN (model) and plain CMLLR "
                                 "(feature) transforms only")
    any_model_xf = any(_has_model_xf(c) for c in xforms.values())
    # if any speaker scales variances, every speaker must write them back
    # (else the next speaker would inherit the previous one's scaling)
    any_var_xf = any(_has_var_xf(c) for c in xforms.values())

    def adapt_for(logical, data):
        # -h given: always resolve the speaker, even with one TMF loaded —
        # a single speaker-specific TMF must not silently apply to other
        # speakers' utterances (_xfcli.resolve_chain)
        chain = resolve_chain(xforms, spk_mask, logical, "HVite")
        if base_xf is not None:
            chain = [base_xf] + list(chain)
        cur_m, cur_v = base_means, base_vars
        vars_touched = False
        cov_xf = None
        cmllr_cls = None
        for xf in chain:
            if isinstance(xf, tuple):  # regression-class MLLR/CMLLR set
                _nm, xfs, c2x, classes = xf
                if xfs and xfs[0].kind == "CMLLR":
                    cmllr_cls = xf  # model-space constrained, applied last
                    continue
                if any(x.var_scale is not None for x in xfs):
                    cur_v = adapt.apply_mllr_classes_vars(
                        comp, cur_v, xfs, c2x, classes)
                    vars_touched = True
                cur_m = adapt.apply_mllr_classes(comp, cur_m, xfs, c2x,
                                                 classes)
            elif xf.kind == "MLLRMEAN":
                cur_m = xf.apply_to_means(cur_m)
                if xf.var_scale is not None:
                    cur_v = xf.apply_to_vars(cur_v)
                    vars_touched = True
            elif xf.kind == "MLLRCOV":
                cov_xf = xf  # full variance transform, applied last
            else:  # CMLLR: feature space
                data = xf.apply_to_features(data).astype(data.dtype)
        if native_fc:
            # full-covariance set: MLLRMEAN means project through the
            # compiled precision Cholesky (covariances untouched, so
            # fc_proj/gConsts stay); cur_m falls back to base_means for
            # a speaker with a feature-only chain, restoring the set
            if any_model_xf:
                comp.means = cur_m.astype(np.float32)
                comp.fc_mu = adapt.fc_mu_from_means(comp, cur_m)
                drop_device_caches(comp)
            return data
        # drop any previous speaker's full-cov override first so
        # write_back's diagonal guard and gconsts stay consistent
        if comp.full_cov:
            comp.full_cov = False
            comp.fc_proj = comp.fc_mu = None
            comp.gconsts = base_gconsts.copy()
            drop_device_caches(comp)
        if any_model_xf:
            # also restores canonical params after a previous speaker
            write_back(comp, means=cur_m,
                       variances=(cur_v if (vars_touched or any_var_xf)
                                  else None))
        if cov_xf is not None:
            fc_proj, fc_mu, gc = adapt.apply_mllrcov(
                comp, cov_xf, means=cur_m,
                variances=(cur_v if vars_touched else None))
        elif cmllr_cls is not None:
            _nm, xfs, c2x, classes = cmllr_cls
            fc_proj, fc_mu, gc = adapt.apply_cmllr_classes_fc(
                comp, xfs, c2x, classes, means=cur_m)
        else:
            return data
        comp.fc_proj, comp.fc_mu, comp.gconsts = fc_proj, fc_mu, gc
        comp.full_cov = True
        drop_device_caches(comp)
        return data

    return adapt_for, any_model_xf


def run(argv: List[str]) -> int:
    ta = parse_args("HVite", argv, OPTS, min_args=2, usage=USAGE)
    gen_beam = float(ta.get("t")) if ta.has("t") else None
    max_act = int(ta.get("u")) if ta.has("u") else None
    if ta.trace and (gen_beam is not None or max_act is not None):
        print(f"HVite: pruning genBeam={gen_beam} maxActive={max_act} "
              "(recognition scans; alignment stays exact)")
    cfg = ta.config
    prec = outp_precision(cfg)
    dict_file, hmm_list_file = ta.args[0], ta.args[1]
    files = ta.script + ta.args[2:]
    # HVite live mode (HVite.c with SOURCEKIND = HAUDIO and no files):
    # samples stream from the audio source through the incremental
    # frontend and decoder instead of per-file batch processing.
    src_kind = (cfg.str_("SOURCEKIND", "", module="HPARM") or "").upper()
    live = not files and src_kind == "HAUDIO"
    if not files and not live:
        HError(1030, "HVite: no test files\n%s", USAGE)

    mmfs = ta.get_all("H")
    if not mmfs:
        HError(1030, "HVite: at least one -H mmf required")
    hset = load_mmf(mmfs, cfg=ta.config)
    comp = compile_hmmset(hset)
    adapt_for, model_xf = _input_transforms(ta, hset, comp)
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
    # -o output-format flags (HVite.c -o): N normalise acoustic scores
    # by duration, S suppress scores, T suppress times, W suppress the
    # word tags in model alignment, M suppress model (phone) labels
    ofmt = (ta.get("o") or "").upper()
    sup_scores = "S" in ofmt
    sup_times = "T" in ofmt

    if not ta.has("w"):
        if not ta.has("a"):
            HError(1030, "HVite: either -w netfile or -a required\n%s",
                   USAGE)
        _align_files(ta, cfg, comp, vocab, files, prec, device, out_mlf,
                     out_dir, out_ext, period, ofmt, adapt_for)
        _save_mlf(ta, out_mlf, out_mlf_path, sup_times, sup_scores)
        return 0
    lat = read_slf(ta.get("w"), ta.config)
    # HNet.c config: FORCECXTEXP forces full cross-word context
    # expansion; ALLOWXWRDEXP permits it when the set is context-
    # dependent. CFPHONES (own key [LC]) lists transparent phones.
    force_x = cfg.bool_("FORCECXTEXP", False, module="HNET") or False
    allow_x = cfg.bool_("ALLOWXWRDEXP", False, module="HNET") or False
    has_cd = any("-" in n or "+" in n for n in comp.names)
    if force_x or (allow_x and has_cd):
        cfp = (cfg.str_("CFPHONES", "sp", module="HNET") or "sp").split()
        # lattices and n-best need whole-word nodes: no shared interiors
        share = (bool(cfg.bool_("SHAREINTERIORS", True, module="HNET"))
                 and not ta.get("z") and not ta.has("n"))
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
    # hybrid decoding (-N): the ANN's scores replace OutP
    ann = load_ann(ta.get("N")) if ta.has("N") else None
    if live:
        if ann is not None:
            require_feedforward(ann, "HVite live mode")
        return _run_live(ta, cfg, net, comp, lm_scale, word_pen, out_mlf,
                         out_mlf_path, out_dir, out_ext, period, device)

    lat_ext = ta.get("z")
    lat_beam = cfg.flt_("LATTICEBEAM", 200.0, module="HREC") or 200.0
    nbest = 0
    if ta.has("n"):
        v = ta.get("n")
        nbest = int(v[1] if isinstance(v, tuple) else v)
    want_lat = bool(lat_ext) or nbest > 1

    entries, featl = [], []
    pre = preload_corpus(files, cfg)
    for fn in files:
        data, _p, _k, e = pre.get(fn) or open_speech_file(fn, cfg)
        entries.append(e)
        featl.append(np.asarray(data))
    raw = list(featl)

    def adapted(j):
        """Utterance j's features under its transform chain, the set
        adapted to its speaker for model-space chains."""
        if adapt_for is not None:
            featl[j] = np.asarray(adapt_for(entries[j].logical, raw[j]))
        return featl[j]

    if adapt_for is not None and not model_xf:
        # feature-space (CMLLR) chains touch no model state, so they
        # batch fine: applied per utterance up front
        for j in range(len(featl)):
            adapted(j)
    results: List = [None] * len(featl)
    lats: List = [None] * len(featl)
    # the ANN's scores are computed once an utterance on the device and
    # kept for the retry ladder
    if ann is not None:
        model = ANNModule(ann, device)
        if ta.trace:
            print(f"HVite: hybrid decoding with ANN {ta.get('N')}")
    scores: dict = {}

    def state_scores(j):
        if j not in scores:
            scores[j] = (discrete_state_scores(comp, featl[j], device=device)
                         if ann is None else hybrid_outp(
                             ann, featl[j], device=device, model=model))
        return scores[j]

    def write_lat(j, lt):
        stem = os.path.splitext(os.path.basename(entries[j].logical))[0]
        lt.utterance = stem
        write_slf(lt, os.path.join(out_dir or ".", f"{stem}.{lat_ext}"))

    def recognise(idx, b, ma, first):
        """The 1-bests of the utterances `idx`, decoded as one bucket at
        beam `b` and max active `ma`, with their lattices under -z/-n; a
        retry (`first` False) writes a lattice only with a recovered
        1-best. The hybrid and discrete scores go in each utterance's
        own, through the decoder's `state_scores_list` hook."""
        if model_xf:
            adapted(idx[0])
        fl = [featl[j] for j in idx]
        ss = ([state_scores(j) for j in idx]
              if ann is not None or comp.discrete else None)
        if not want_lat:
            return decode_batch(net, comp, fl, lm_scale, word_pen,
                                precision=prec, beam=b, max_active=ma,
                                state_scores_list=ss, device=device)
        prs = generate_lattice_batch(
            net, comp, fl, lm_scale, word_pen, lattice_beam=lat_beam,
            frame_period_s=period / 1e7, precision=prec, beam=b,
            max_active=ma, want_results=True, state_scores_list=ss,
            device=device)
        for j, (lt, r) in zip(idx, prs):
            lats[j] = lt
            if lat_ext and lt is not None and (first or r is not None):
                write_lat(j, lt)
        return [r for _lt, r in prs]

    # length-sorted buckets of DECODEBATCH, one decode launch a bucket;
    # under model-space transforms the set changes before each decode, so
    # a bucket is one utterance
    order = sorted(range(len(featl)), key=lambda i: featl[i].shape[0])
    bsz = (1 if model_xf else
           int(cfg.int_("DECODEBATCH", 8, module="HREC") or 8))
    with maybe_profile(cfg, "HVite"):
        for i0 in range(0, len(order), bsz):
            idx = order[i0:i0 + bsz]
            for j, r in zip(idx, recognise(idx, gen_beam, max_act, True)):
                results[j] = r
    if gen_beam is not None or max_act is not None:
        for j, r in enumerate(results):
            if r is not None:
                continue
            for b, ma in _retry_ladder(gen_beam, max_act, cfg):
                HRError(8525, "HVite: no tokens for %s under pruning; "
                              "retrying at %s", entries[j].logical,
                        "unpruned" if b is None else f"beam {b:.0f}")
                r = recognise([j], b, ma, False)[0]
                if r is not None:
                    results[j] = r
                    break
    for j, (e, res) in enumerate(zip(entries, results)):
        if res is None:
            HRError(8522, "HVite: no tokens survived for %s", e.logical)
            tr = Transcription(alternatives=[[]])
        elif nbest > 1:
            tr = _nbest_transcription(lats[j], nbest, vocab, e.logical,
                                      ta.trace)
        else:
            tr = _transcription(res, period)
            if ta.trace:
                print(f"{e.logical}: {' '.join(res.words)}  "
                      f"[{res.score:.2f}]")
        _emit(tr, e.logical, out_mlf, out_dir, out_ext)
    _save_mlf(ta, out_mlf, out_mlf_path, sup_times, sup_scores)
    return 0


def _save_mlf(ta, out_mlf, out_mlf_path, sup_times, sup_scores):
    if out_mlf is not None:
        out_mlf.save(out_mlf_path, with_times=not sup_times,
                     with_scores=(ta.has("m") and not sup_scores),
                     cfg=ta.config)
        if ta.trace:
            print(f"HVite: wrote {out_mlf_path}")


def _align_files(ta, cfg, comp, vocab, files, prec, device, out_mlf,
                 out_dir, out_ext, period, ofmt, adapt_for=None):
    """HVite -a: each file's word transcription (-I/-L/-X), with the -b
    boundary word around it, becomes a composite HMM of the words' first
    pronunciations (word-internally context-expanded, as the recognition
    network compiler applies: on a triphone set a raw monophone pron
    would align against stale monophone models); the Viterbi alignment
    gives model-level labels with word tags (-m) or merged word segments,
    and with -z the aligned 1-best as a linear word lattice. `adapt_for`
    applies each utterance's input transform chain first (-J)."""
    mlfs = [MLF.load(p, ta.config) for p in ta.get_all("I")]
    label_dir = ta.get("L")
    label_ext = ta.get("X", "lab")
    bound = ta.get("b")
    lat_ext = ta.get("z")
    sup_words = "W" in ofmt
    sup_models = "M" in ofmt
    norm_scores = "N" in ofmt
    pron_map = word_internal_phone_map(comp.names)
    pre = preload_corpus(files, cfg)
    for fn in files:
        data, _p, _k, e = pre.get(fn) or open_speech_file(fn, cfg)
        if adapt_for is not None:
            data = adapt_for(e.logical, data)
        wtr = find_labels(e.logical, mlfs, label_dir, label_ext)
        words = [lab.name for lab in wtr.labels]
        if bound:
            words = [bound] + words + [bound]
        phones: List[str] = []
        occ_of_phone: List[int] = []  # word-occurrence index per phone
        for oi, w in enumerate(words):
            wd = vocab.get(w)
            if wd is None:
                HError(8621, "HVite: word %s not in dictionary", w)
            phs = pron_map(wd.prons[0].phones)
            phones.extend(phs)
            occ_of_phone.extend([oi] * len(phs))
        hmm = build_composite(comp, [comp.model_id(p) for p in phones])
        res = align(comp, hmm, np.asarray(data), precision=prec,
                    device=device)
        tr = Transcription(alternatives=[[]])
        if ta.has("m") and not sup_models:
            cur_occ = None
            for inst, t0, t1, seg_score in res.model_seq:
                sc = seg_score
                if norm_scores and t1 > t0:
                    sc = seg_score / (t1 - t0)
                lab = Label(name=phones[inst], start=t0 * period,
                            end=t1 * period, score=sc)
                # the first phone of each word carries the word label
                # (the model-alignment MLF convention)
                occ = occ_of_phone[inst]
                if occ != cur_occ:
                    if not sup_words:
                        lab.aux = [words[occ]]
                    cur_occ = occ
                tr.alternatives[0].append(lab)
        else:
            # merge aligned phone segments into word segments
            cur_occ, w0, w1 = None, 0, 0
            for inst, t0, t1, _sc in res.model_seq:
                occ = occ_of_phone[inst]
                if occ != cur_occ:
                    if cur_occ is not None:
                        tr.alternatives[0].append(Label(
                            name=words[cur_occ], start=w0 * period,
                            end=w1 * period))
                    cur_occ, w0 = occ, t0
                w1 = t1
            if cur_occ is not None:
                tr.alternatives[0].append(Label(
                    name=words[cur_occ], start=w0 * period,
                    end=w1 * period))
        if lat_ext:
            _write_numerator_lattice(res, occ_of_phone, words, period,
                                     e.logical, out_dir, lat_ext)
        if ta.trace:
            print(f"{e.logical}: aligned {len(phones)} phones, "
                  f"score {res.score:.2f}")
        _emit(tr, e.logical, out_mlf, out_dir, out_ext)


def _write_numerator_lattice(res, occ_of_phone, words, period, logical,
                             out_dir, lat_ext):
    """-a -z: the aligned 1-best as a linear word lattice, the numerator
    lattice HTK MMI recipes feed HMMIRest -q (the same arc-FB machinery
    as the denominator, so fixed arc spans cancel between the sides)."""
    segs = []  # (word occ, first frame, end frame, score)
    for inst, t0, t1, sc in res.model_seq:
        occ = occ_of_phone[inst]
        if segs and segs[-1][0] == occ:
            segs[-1][2] = t1
            segs[-1][3] += sc
        else:
            segs.append([occ, t0, t1, sc])
    lt = Lattice(lmscale=1.0, wdpenalty=0.0)
    lt.nodes.append(LNode(id=0, time=0.0, word=NULL_WORD))
    prev = 0
    for k, (occ, _w0, w1, sc) in enumerate(segs):
        lt.nodes.append(LNode(id=k + 1, time=w1 * period / 1e7,
                              word=words[occ]))
        lt.arcs.append(LArc(id=k, start=prev, end=k + 1, aclike=float(sc),
                            lmlike=0.0))
        prev = k + 1
    stem = os.path.splitext(os.path.basename(logical))[0]
    lt.utterance = stem
    write_slf(lt, os.path.join(out_dir or ".", f"{stem}.{lat_ext}"))


def _run_live(ta, cfg, net, comp, lm_scale, word_pen, out_mlf,
              out_mlf_path, out_dir, out_ext, period, device) -> int:
    """Live recognition: audio source -> streaming frontend -> streaming
    decoder on `device`, with partial traceback under -T 2 (HVite.c live
    loop).

    The audio 'device' on a headless host is a file-replay source
    (HAUDIO: AUDIOSOURCE = <file>; io/audio.py): a microphone backend
    would slot into open_audio_input without changing this loop.
    """
    src = open_audio_input(cfg)
    fcfg = FrontendConfig.from_config(cfg, samp_period=src.samp_period)
    sf = StreamingFrontend(fcfg, device=device)
    sd = StreamingDecoder(net, comp, lm_scale=lm_scale, word_pen=word_pen,
                          device=device)

    src.start()
    read_n = max(1, int(2500000 / src.samp_period))  # 0.25 s per read
    while (chunk := src.read(read_n)) is not None:
        feats = sf.feed(chunk.astype(np.float32))
        if feats.size:
            sd.feed(feats)
        if ta.trace > 1:
            part = sd.partial_result()
            if part is not None:
                print(f"live [{sd.frames_processed:5d}]: "
                      f"{' '.join(part.words)}")
    tail = sf.flush()
    if tail.size:
        sd.feed(tail)
    res = sd.flush()
    src.stop()

    logical = cfg.str_("AUDIOSOURCE", "liveaudio", module="HAUDIO") \
        or "liveaudio"
    tr = Transcription(alternatives=[[]])
    if res is None:
        HRError(8522, "HVite: no tokens survived (live)")
    else:
        for w, (t0, t1) in zip(res.words, res.times):
            tr.alternatives[0].append(
                Label(name=w, start=t0 * period, end=(t1 + 1) * period))
        if ta.trace:
            print(f"live: {' '.join(res.words)}  [{res.score:.2f}]")
    _emit(tr, logical, out_mlf, out_dir, out_ext)
    if out_mlf is not None:
        out_mlf.save(out_mlf_path, with_times=True, with_scores=False,
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
