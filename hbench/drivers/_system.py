"""The system under test, built through the program's own classes from
what `traffic/synth.py` made: the HMM set (io.mmf objects, compiled by
`models.hmmset.compile_hmmset`), the dictionary, and the bigram as an
HBuild-style word network (HVite's `-w`) or as ARPA tables (HDecode's LM).
"""

from __future__ import annotations

import numpy as np

from htk_tpu_torch.io.dictionary import Vocab
from htk_tpu_torch.io.lm import NGramLM
from htk_tpu_torch.io.mmf import (HMMDef, HMMSet, MixPDF, StateInfo,
                                  StreamElem)
from htk_tpu_torch.io.parmkind import str2parmkind
from htk_tpu_torch.io.slf import LArc, LNode, Lattice, NULL_WORD
from htk_tpu_torch.models.hmmset import compile_hmmset

from ..traffic.synth import Structure, internal_triphones, lm_weights


def hmm_set(cfg: dict, st: Structure, means: np.ndarray,
            variances: np.ndarray):
    """The tied-state triphone set (5-state left-to-right models drawing
    their 3 emitting states from the pool, as the port's
    `synth.build_hmmset`), compiled."""
    n_tied, n_mix, dim = means.shape
    hset = HMMSet(vec_size=dim, parm_kind=str2parmkind(cfg["parm_kind"]))
    for k in range(n_tied):
        se = StreamElem(weights=[1.0 / n_mix] * n_mix,
                        mixes=[MixPDF(mean=means[k, m], var=variances[k, m])
                               for m in range(n_mix)])
        for mp in se.mixes:
            mp.fix_gconst()
        hset.macros["s"][f"st{k}"] = StateInfo(streams=[se])
    pool = list(hset.macros["s"].values())
    a = float(cfg["self_loop"])
    tp = np.zeros((5, 5), np.float32)
    tp[0, 1] = 1.0
    for i in range(1, 4):
        tp[i, i], tp[i, i + 1] = a, 1.0 - a
    hset.macros["t"]["trP"] = tp
    for name, picks in zip(st.tri_names, st.tri_states):
        hset.hmms[name] = HMMDef(name=name, nstates=5,
                                 states=[pool[int(k)] for k in picks],
                                 transp=tp)
    return compile_hmmset(hset)


def vocab(st: Structure, triphones: bool) -> Vocab:
    """The dictionary: monophones (HVite expands them with its phone map)
    or word-internal triphones (the LV loop's pronunciations)."""
    v = Vocab()
    for w, ph in zip(st.words, st.lex):
        v.add_pron(w, internal_triphones(ph) if triphones else ph)
    return v


def word_network(cfg: dict, st: Structure) -> Lattice:
    """The grammar as HBuild lays it out: sentence start and end !NULL
    nodes and each word's successors; a back-off bigram (the port's
    `synth.bigram_network`) adds one back-off !NULL node that every word
    leaves to and enters from."""
    lw = lm_weights(cfg)
    backoff = cfg["grammar"] == "backoff_bigram"
    n_null = 3 if backoff else 2
    end = 2 if backoff else 1
    lat = Lattice()
    for i in range(n_null):
        lat.nodes.append(LNode(id=i, word=NULL_WORD))
    for k, w in enumerate(st.words):
        lat.nodes.append(LNode(id=n_null + k, word=w))

    def arc(s, e, p):
        lat.arcs.append(LArc(id=len(lat.arcs), start=s, end=e, lmlike=p))

    V = len(st.words)
    for k in range(V):
        arc(0, n_null + k, lw["start"])
    for k in range(V):
        for j in st.succ[k]:
            arc(n_null + k, n_null + j, lw["explicit"])
    if backoff:
        for k in range(V):
            arc(n_null + k, 1, lw["bow"])
            arc(1, n_null + k, lw["uni"])
    for k in range(V):
        arc(n_null + k, end, lw["end"])
    return lat


def arpa_lm(cfg: dict, st: Structure) -> NGramLM:
    """The back-off bigram as ARPA tables (the port's `synth.bigram_lm`)."""
    assert cfg["grammar"] == "backoff_bigram", cfg["grammar"]
    lw = lm_weights(cfg)
    lm = NGramLM(order=2)
    for w in st.words:
        lm.unigrams[w] = (lw["uni"], lw["bow"])
    lm.unigrams["!ENTER"] = (-99.0, lw["bow"])
    lm.unigrams["!EXIT"] = (lw["uni"], 0.0)
    for k, w in enumerate(st.words):
        for j in st.succ[k]:
            lm.bigrams[(w, st.words[j])] = (lw["explicit"], 0.0)
    return lm


def gaussian_flops(cfg: dict, st: Structure) -> float:
    """The model's arithmetic a frame: every Gaussian of the set (the
    pool's states that some triphone uses) scored, 2 x 2D operations each
    (the (T, 2D) @ (2D, M) product)."""
    M = len(np.unique(st.tri_states)) * int(cfg["n_mix"])
    return 2.0 * 2 * int(cfg["dim"]) * M
