"""HDecode — large-vocabulary cross-word decoder, on htk_tpu_torch.

Mirrors `HTKLVRec/HDecode.c`'s role (SURVEY.md §2.4) with a TPU-shaped
two-pass architecture instead of HLVRec's token-level LM states:

  pass 1: a dense full-vocabulary back-off bigram word loop scanned on
          device (algo/lvnet uniform-row network for large vocabularies,
          algo/net dense network below the LV threshold), with HLVRec's
          pruning controls mapped onto dense compute: -t genBeam kills
          states below the per-frame best, -u (maxModel/histogram role)
          lets only the top-N word-ends propagate across words. A word
          lattice is generated per utterance.
  pass 2: exact trigram best-path over that lattice
          (algo/latops.best_path_trigram). With HNET: FORCECXTEXP = T
          the lattice is first re-decoded through a lattice-constrained
          cross-word triphone expansion (compile_network cross_word=True
          on the pass-1 lattice), so cross-word acoustics are exact on
          the lattice — the TPU answer to HLVNet's static cross-word
          layers, which would need |contexts|^2 interior duplicates in a
          dense layout.

This mirrors how LVCSR systems actually deploy (bigram/lookahead search
+ n-gram rescoring); HLVRec's single-pass trigram tokens are an
implementation detail of scalar CPUs, not a capability difference. The
lattice beam bounds the approximation and is configurable.

Usage: HDecode [options] dictFile hmmList testFiles...

  -w lm     ARPA LM file (bigram drives the search, trigram the rescore)
  -H mmf    load HMM macro file (repeatable)
  -s f      LM scale      -p f  word insertion penalty
  -i mlf    output MLF    -l dir  output/lattice dir
  -z ext    also write the pass-1 lattices
  -t f      main beam (genBeam; 0 = off)
  -u n      max active word-ends per frame (histogram pruning; 0 = off)
  -n f      lattice beam (default 250)
  -o flags  output label format (accepted)
  -J dir    input transform dir (repeatable)   -h mask  speaker mask
  -k        the MMF's own input transform (~a) is the base of each chain
  Standard: -A -C -D -S -T -V

The port of `htk_tpu/tools/hdecode.py`. Pass 1 runs on
`default_device()` (the CUDA card, or the CPU when
HTK_TPU_TORCH_DEVICE=cpu asks for it): on LV nets (the uniform-row loop
of algo/lvnet) the cross-word step launches the maxplus kernel on dense
nets and segmax on factored ones; below the LV threshold the general
network's recursion is the decode_scan kernel. Pass 2 (latops) is host
code. Input transforms (-J, -k, -h; tools/_xfcli.py): feature-space
(CMLLR) legs apply to the features on the host; model-space legs become
per-speaker `model_params` overrides of the decoder, derived once a
speaker, and pass 1 batches utterances by (speaker, length) so each
bucket has one speaker's parameters. Chains that would promote the
scorer to full covariance are refused (HError 7450), as in the
reference. The reference's `preload_corpus` hook is not taken. Under -T
the batched pass 1 prints its lattice records: in beam, kept,
overflowing utterances (8523) and the gathers that resurrected
beam-pruned predecessors.

Config: HTKTPU: LVDECODE = T/F forces/disables the uniform-row LV
network (default: auto, on when the vocabulary has >= 800 words);
HNET: FORCECXTEXP enables the cross-word pass as in HVite; HDECODE:
TRIGUIDE, LATPREDS, STARTWORD, ENDWORD; HREC: ADAPTTOPA, DECODEBATCH
(default: auto), GENBEAMKNEE, PRUNERETRYINC.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..algo.adapt import load_tmf_text, speaker_from_mask
from ..algo.decode import generate_lattice, generate_lattice_batch
from ..algo.latops import best_path_trigram
from ..algo.lvnet import compile_lv_loop
from ..algo.net import compile_network, word_internal_phone_map
from ..io.dictionary import read_dict
from ..io.lm import read_lm
from ..io.mlf import MLF, Label, Transcription
from ..io.mmf import load_hmm_list, load_mmf
from ..io.slf import write_slf
from ..models.hmmset import compile_hmmset
from ..tools.hbuild import bigram_lattice
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError
from ..utils.metrics import maybe_profile
from ._common import default_device, open_speech_file, outp_precision
from ._xfcli import (chain_feature_data, chain_model_params,
                     load_input_transforms, resolve_chain)

USAGE = ("Usage: python -m htk_tpu_torch.tools.hdecode [options] dictFile "
         "hmmList testFiles...")

OPTS = {
    "w": Option("w", 1, "ARPA LM file"),
    "H": Option("H", 1, "load MMF", repeatable=True),
    "s": Option("s", 1, "LM scale", typ=float),
    "p": Option("p", 1, "word penalty", typ=float),
    "i": Option("i", 1, "output MLF"),
    "l": Option("l", 1, "output dir"),
    "z": Option("z", 1, "lattice extension"),
    "t": Option("t", 1, "main beam (genBeam)", typ=float),
    "u": Option("u", 1, "max active word-ends", typ=int),
    "n": Option("n", 1, "lattice beam", typ=float),
    "o": Option("o", 1, "output format flags"),
    "J": Option("J", 1, "input transform dir", repeatable=True),
    "k": Option("k", 0, "use input transforms"),
    "h": Option("h", 1, "speaker mask for -J selection"),
}

LV_VOCAB_THRESHOLD = 800


def run(argv: List[str]) -> int:
    ta = parse_args("HDecode", argv, OPTS, min_args=2, usage=USAGE)
    cfg = ta.config
    dict_file, hmm_list_file = ta.args[0], ta.args[1]
    files = ta.script + ta.args[2:]
    if not files:
        HError(1030, "HDecode: no test files\n%s", USAGE)
    if not ta.has("w"):
        HError(1030, "HDecode: ARPA LM (-w) required")
    mmfs = ta.get_all("H")
    if not mmfs:
        HError(1030, "HDecode: at least one -H mmf required")

    prec = outp_precision(cfg)
    hset = load_mmf(mmfs, cfg=ta.config)
    comp = compile_hmmset(hset)
    device = default_device()
    vocab = read_dict(dict_file, ta.config)
    load_hmm_list(hmm_list_file, ta.config)
    lm = read_lm(ta.get("w"), ta.config)

    # sentence boundary words (HDecode STARTWORD/ENDWORD config): when
    # the dictionary gives them pronunciations (recipe convention
    # "<s> [] sil" / "</s> [] sil"), they are decoded as real obligatory
    # silence models at the utterance edges; otherwise they contribute
    # LM context only.
    start_w = cfg.str_("STARTWORD", "<s>", module="HDECODE") or "<s>"
    end_w = cfg.str_("ENDWORD", "</s>", module="HDECODE") or "</s>"
    sent_start = start_w if start_w in lm.unigrams else "!ENTER"
    sent_end = end_w if end_w in lm.unigrams else "!EXIT"
    bound_prons = (start_w in vocab.words and end_w in vocab.words
                   and start_w in lm.unigrams and end_w in lm.unigrams)

    # pass-1 network: back-off bigram loop over the LM's vocabulary
    # intersected with the dictionary
    words = [w for w in lm.vocab
             if w in vocab.words and w not in (start_w, end_w)]
    if not words:
        HError(8621, "HDecode: no LM words found in dictionary")
    # HTK's HDecode assumes a cross-word-trained set; forcing cross-word
    # expansion on a word-internal set silently swaps word-edge models
    # for ones trained in other positions (FindModel fallback), so here
    # cross-word is opt-in: HNET: FORCECXTEXP = T. CFPHONES lists
    # transparent phones [LC].
    want_x = cfg.bool_("FORCECXTEXP", False, module="HNET") or False
    cfp = (cfg.str_("CFPHONES", "sp", module="HNET") or "sp").split()
    lv_cfg = cfg.bool_("LVDECODE", None, module="HTKTPU")
    use_lv = (len(words) >= LV_VOCAB_THRESHOLD
              if lv_cfg is None else bool(lv_cfg))
    pmap = word_internal_phone_map(comp.names)
    if use_lv:
        # uniform-row LV loop; cross-word exactness comes from the
        # lattice-constrained pass 2 below. TRIGUIDE (default T, the
        # HLVRec-LM.c single-pass role) scores pass 1 under each
        # token's trigram context so the beam protects trigram-best
        # hypotheses — without it pass-1 pruning errors at tight
        # genBeam are whole utterances no rescoring can recover.
        triguide = cfg.bool_("TRIGUIDE", None, module="HDECODE")
        triguide = (lm.order >= 3) if triguide is None else bool(triguide)
        net = compile_lv_loop(
            words, vocab, comp, lm=lm, phone_map=pmap,
            sent_start=sent_start, sent_end=sent_end,
            start_word=start_w if bound_prons else None,
            end_word=end_w if bound_prons else None,
            trigram=triguide)
        x_static = False
    elif want_x:
        lat_net = bigram_lattice(words, lm, sent_start, sent_end,
                                 start_word=start_w if bound_prons else None,
                                 end_word=end_w if bound_prons else None)
        net = compile_network(lat_net, vocab, comp, cross_word=True,
                              cf_phones=cfp)
        x_static = True
    else:
        lat_net = bigram_lattice(words, lm, sent_start, sent_end,
                                 start_word=start_w if bound_prons else None,
                                 end_word=end_w if bound_prons else None)
        net = compile_network(lat_net, vocab, comp, phone_map=pmap)
        x_static = False
    if ta.trace:
        print(f"HDecode: vocab {len(words)}, network {net.n_states} states, "
              f"{net.n_chains} chains"
              + (" [LV uniform rows]" if use_lv else ""))

    lm_scale = float(ta.get("s", 1.0) or 1.0)
    word_pen = float(ta.get("p", 0.0) or 0.0)
    main_beam = float(ta.get("t", 0.0) or 0.0) or None
    max_active = int(ta.get("u", 0) or 0) or None
    # HREC: ADAPTTOPA — adaptive-exact top-A: -u (default 512) drives
    # the explicit cross-word leg with a per-frame soundness
    # certificate; frames it can't certify recompute exactly. Scores
    # == the exact decode on every frame (see decode._topa_mode).
    if (cfg.bool_("ADAPTTOPA", False, module="HREC")
            and net.xw_backoff is not None
            and net.xw_trigram is None):
        max_active = -(max_active or 512)
    # trigram-guided pass 1 pairs with top-A by default: the guided
    # cross-word leg over ALL rows costs ~11x, while guided + top-A is
    # both more accurate AND faster than the bigram pass (BASELINE.md
    # round-5 quality sweep). -u 0 keeps it off explicitly.
    if (getattr(net, "xw_trigram", None) is not None
            and max_active is None and ta.get("u") is None):
        max_active = 512
    lat_beam = float(ta.get("n", 250.0) or 250.0)
    # HDECODE: LATPREDS — alternative-predecessor arcs per record
    # (HLVRec lattice semantics; 1 = HVite's single-pred lattices).
    # Pass-2 rescoring quality depends on these alternatives.
    lat_preds = int(cfg.flt_("LATPREDS", 8.0, module="HDECODE"))
    # Beam-cliff guardrail: BASELINE.md's lattice-quality sweep measured
    # whole-utterance search errors once genBeam drops below ~300-400
    # (the knee) — lattice rescoring cannot recover them.  Warn when -t
    # is set below the knee; HREC: GENBEAMKNEE moves it (0 disables).
    knee = cfg.flt_("GENBEAMKNEE", 400.0, module="HREC")
    if main_beam is not None and knee and main_beam < knee:
        HRError(8524, "HDecode: -t %.0f is below the measured search-"
                      "error knee (~%.0f): pruning losses at this beam "
                      "are whole utterances and no lattice rescoring "
                      "recovers them. Control lattice size with -n "
                      "(lossless down to 50) and keep -t >= %.0f, or set "
                      "HREC: GENBEAMKNEE = 0 to silence this",
                main_beam, knee, knee)
    period = int(cfg.flt_("TARGETRATE", 100000.0, module="HPARM"))
    out_dir = ta.get("l")
    out_mlf_path = ta.get("i")
    out_mlf = MLF() if out_mlf_path else None

    # input adaptation transforms (-J): per-speaker chains; feature-space
    # CMLLR applies to the features per utterance, model-space transforms
    # become per-speaker parameter overrides of the decoder
    xforms = load_input_transforms(ta.get_all("J"), ta.trace, "HDecode")
    spk_mask = ta.get("h")
    # -k: the model set's own ~a input transform (HHEd XF) becomes the
    # base of every utterance's chain
    base_xf = None
    if ta.has("k") and hset.input_xform:
        _bnm, base_xf = load_tmf_text(hset.input_xform)
        if not xforms:
            xforms = {"global": [base_xf]}
            base_xf = None
    xf_base = ((comp.means.copy(), comp.variances.copy())
               if xforms else None)
    spk_params: dict = {}

    def adapt(logical, data):
        """Returns (data, speaker key); caches per-speaker params."""
        if not xforms:
            return data, None
        spk = (speaker_from_mask(spk_mask, logical) if spk_mask
               else "_single")
        chain = resolve_chain(xforms, spk_mask, logical, "HDecode")
        if base_xf is not None:
            chain = [base_xf] + list(chain)
        if spk in spk_params:
            # model-space params are per-speaker and already derived;
            # only the feature-space legs touch per-utterance data
            return chain_feature_data(chain, data), spk
        data, params = chain_model_params(comp, chain, data, xf_base,
                                          "HDecode")
        spk_params[spk] = params
        return data, spk

    # pass 1 runs batched on LV nets: utterances are bucketed by
    # (speaker, length) and each bucket goes through one scan and one
    # compacted record fetch (generate_lattice_batch), HDecode.c's
    # sequential file loop replaced by the batch pipeline; identical
    # lattices per utterance (tested). Pass 2 and the rescoring stay per
    # utterance (host DP).
    entries, featl, spks = [], [], []
    for fn in files:
        data, _p, _k, e = open_speech_file(fn, cfg)
        data, spk = adapt(e.logical, np.asarray(data))
        entries.append(e)
        featl.append(np.asarray(data))
        spks.append(spk)
    lats: List = [None] * len(files)
    if use_lv and len(files) > 1:
        order = sorted(range(len(featl)),
                       key=lambda i: (str(spks[i]), featl[i].shape[0]))
        bsz = int(cfg.int_("DECODEBATCH", 0, module="HREC") or 0)
        if not bsz:
            # auto: 3 f32/int32 record planes (B, T, C) within ~4 GB
            t_max = max(f.shape[0] for f in featl)
            t_pad = ((t_max + 127) // 128) * 128
            bsz = max(1, min(64, (4 << 30) // (t_pad * net.n_chains * 12)))
        stats: dict = {}
        with maybe_profile(cfg, "HDecode"):
            i0 = 0
            while i0 < len(order):
                idx = [order[i0]]
                while (len(idx) < bsz and i0 + len(idx) < len(order)
                       and spks[order[i0 + len(idx)]] == spks[idx[0]]):
                    idx.append(order[i0 + len(idx)])
                i0 += len(idx)
                ls = generate_lattice_batch(
                    net, comp, [featl[j] for j in idx], lm_scale,
                    word_pen, lattice_beam=lat_beam,
                    frame_period_s=period / 1e7, beam=main_beam,
                    max_active=max_active, precision=prec,
                    max_preds=lat_preds, stats=stats,
                    model_params=spk_params.get(spks[idx[0]]),
                    device=device)
                for j, lt in zip(idx, ls):
                    lats[j] = lt
        if ta.trace:
            print(f"HDecode: pass 1 in batches of {bsz}: "
                  f"{stats['in_beam']} records in beam, {stats['kept']} "
                  f"kept, {stats['overflow']} utterance(s) over the "
                  f"budget, {stats['gathers']} resurrection gather(s) "
                  f"for {stats['resurrected']} record(s)")
    else:
        for j, data in enumerate(featl):
            lats[j] = generate_lattice(
                net, comp, data, lm_scale, word_pen, lattice_beam=lat_beam,
                frame_period_s=period / 1e7, beam=main_beam,
                max_active=max_active, precision=prec,
                max_preds=lat_preds, model_params=spk_params.get(spks[j]),
                device=device)

    # HFB.c-style retry escalation on the pass-1 beam (the decoder
    # analogue of HERest's -t retry ladder): an utterance whose pruned
    # pass 1 found no path re-runs with the beam widened by
    # HREC: PRUNERETRYINC (default 200), twice, then unpruned, before
    # being reported as failed. The beam rides the scan as a traced
    # operand, so widening does not recompile.
    if main_beam is not None or max_active is not None:
        inc = cfg.flt_("PRUNERETRYINC", 200.0, module="HREC")
        for j, lt in enumerate(lats):
            if lt is not None:
                continue
            ladder = []
            if main_beam is not None and inc > 0:
                ladder = [(main_beam + inc, max_active),
                          (main_beam + 2 * inc, max_active)]
            ladder.append((None, None))
            for b, ma in ladder:
                HRError(8525, "HDecode: no path for %s under pruning; "
                              "retrying at %s",
                        entries[j].logical,
                        "unpruned" if b is None else f"beam {b:.0f}")
                lt = generate_lattice(
                    net, comp, featl[j], lm_scale, word_pen,
                    lattice_beam=lat_beam, frame_period_s=period / 1e7,
                    beam=b, max_active=ma, precision=prec,
                    max_preds=lat_preds,
                    model_params=spk_params.get(spks[j]), device=device)
                if lt is not None:
                    lats[j] = lt
                    break

    for e, data, lat, spk in zip(entries, featl, lats, spks):
        stem = os.path.splitext(os.path.basename(e.logical))[0]
        tr = Transcription(alternatives=[[]])
        if lat is None:
            HRError(8522, "HDecode: no paths for %s", e.logical)
        else:
            if want_x and not x_static:
                # pass 2a: lattice-constrained cross-word re-decode —
                # context variants are bounded by the lattice's actual
                # arcs, so the expansion stays small at any vocabulary
                xnet = compile_network(lat, vocab, comp, cross_word=True,
                                       cf_phones=cfp)
                lat2 = generate_lattice(
                    xnet, comp, data, lm_scale, word_pen,
                    lattice_beam=lat_beam, frame_period_s=period / 1e7,
                    precision=prec, model_params=spk_params.get(spk),
                    device=device)
                if lat2 is not None:
                    lat = lat2
            if ta.has("z"):
                lat.utterance = stem
                write_slf(lat, os.path.join(out_dir or ".",
                                            f"{stem}.{ta.get('z')}"))
            # 4-gram ARPA: the exact 4-gram arc-state rescorer (a
            # capability the reference's trigram-only HLVRec lacks)
            if getattr(lm, "order", 2) >= 4:
                from ..algo.latops import best_path_4gram

                score, path = best_path_4gram(lat, lm, lm_scale,
                                              word_pen,
                                              sent_start=sent_start)
            else:
                score, path = best_path_trigram(lat, lm, lm_scale,
                                                word_pen,
                                                sent_start=sent_start)

            def outsym(w):
                wd = vocab.get(w)
                if wd is None or wd.prons[0].out_sym is None:
                    return w
                return wd.prons[0].out_sym  # '' suppresses (e.g. <s>)

            for w, t in path:
                if outsym(w):
                    tr.alternatives[0].append(
                        Label(name=outsym(w), end=int(t * 1e7)))
            if ta.trace:
                print(f"{e.logical}: "
                      f"{' '.join(outsym(w) for w, _t in path if outsym(w))} "
                      f"[{score:.2f}]")
        if out_mlf is not None:
            out_mlf.add(f"*/{stem}.rec", tr)
    if out_mlf is not None:
        out_mlf.save(out_mlf_path, with_times=False, cfg=ta.config)
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
