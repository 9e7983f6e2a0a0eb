"""Prototype HMM construction (the role of recipe proto files + MakeHMMSet).

Builds left-to-right prototype HMMs programmatically — what HTK recipes
keep as a hand-written `proto` MMF consumed by HCompV (HTKBook tutorial).

Copied from `htk_tpu/models/proto.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..io import parmkind as pk
from ..io.mmf import HMMDef, HMMSet, MixPDF, StateInfo, StreamElem


def left_to_right_transp(nstates: int, self_prob: float = 0.6) -> np.ndarray:
    """N-state left-to-right transition matrix (entry 1, exit N)."""
    tp = np.zeros((nstates, nstates), np.float32)
    tp[0, 1] = 1.0
    for i in range(1, nstates - 1):
        tp[i, i] = self_prob
        tp[i, i + 1] = 1.0 - self_prob
    return tp


def make_proto(
    nstates: int = 5,
    dim: int = 39,
    parm_kind: str = "MFCC_E_D_A",
    nmix: int = 1,
    name: str = "proto",
    stream_widths: Optional[List[int]] = None,
) -> HMMSet:
    """A fresh diagonal-covariance prototype HMMSet.

    `stream_widths` partitions the feature vector into multiple streams
    (must sum to dim); default is one stream covering it all.
    """
    widths = stream_widths or [dim]
    assert sum(widths) == dim, "stream widths must sum to dim"
    hset = HMMSet(vec_size=dim, parm_kind=pk.str2parmkind(parm_kind))
    hset.stream_widths = list(widths)
    h = HMMDef(name=name, nstates=nstates)
    for _ in range(nstates - 2):
        streams = []
        for w in widths:
            se = StreamElem()
            for m in range(nmix):
                mp = MixPDF(
                    mean=np.zeros(w, np.float32), var=np.ones(w, np.float32)
                )
                mp.fix_gconst()
                se.mixes.append(mp)
                se.weights.append(1.0 / nmix)
            streams.append(se)
        h.states.append(StateInfo(streams=streams))
    h.transp = left_to_right_transp(nstates)
    hset.hmms[name] = h
    hset.macros["h"][name] = h
    return hset


def make_discrete_proto(
    nstates: int = 5,
    codebook_sizes: List[int] = (256,),
    name: str = "proto",
) -> HMMSet:
    """A discrete-HMM prototype: uniform codeword tables per stream."""
    from ..io.mmf import logp_to_dprob

    hset = HMMSet(vec_size=len(codebook_sizes),
                  parm_kind=pk.str2parmkind("DISCRETE"))
    hset.stream_widths = [1] * len(codebook_sizes)
    h = HMMDef(name=name, nstates=nstates)
    for _ in range(nstates - 2):
        streams = []
        for k in codebook_sizes:
            se = StreamElem()
            se.dprobs = logp_to_dprob(np.full(k, -np.log(k)))
            streams.append(se)
        h.states.append(StateInfo(streams=streams))
    h.transp = left_to_right_transp(nstates)
    hset.hmms[name] = h
    hset.macros["h"][name] = h
    return hset


def clone_proto(hset: HMMSet, proto_name: str, names: List[str]) -> HMMSet:
    """Clone the proto into one fresh (untied) HMM per name (flat start).

    Every clone gets its own state/mixture objects — the HHEd `CL`-style
    deep copy — so later reestimation can move them independently.
    """
    proto = hset.hmms[proto_name]
    out = HMMSet(
        vec_size=hset.vec_size,
        parm_kind=hset.parm_kind,
        cov_kind=hset.cov_kind,
        dur_kind=hset.dur_kind,
        stream_widths=list(hset.stream_widths),
    )
    for nm in names:
        h = HMMDef(name=nm, nstates=proto.nstates)
        for si in proto.states:
            streams = []
            for se_src in si.streams:
                se = StreamElem()
                if se_src.dprobs is not None:
                    se.dprobs = np.array(se_src.dprobs).copy()
                    streams.append(se)
                    continue
                for w, mp in zip(se_src.weights, se_src.mixes):
                    nmp = MixPDF(
                        mean=np.array(mp.mean, np.float32).copy(),
                        var=np.array(mp.var, np.float32).copy(),
                        cov_kind=mp.cov_kind,
                    )
                    nmp.fix_gconst()
                    se.mixes.append(nmp)
                    se.weights.append(w)
                streams.append(se)
            sw = (np.array(si.stream_weights, np.float32).copy()
                  if si.stream_weights is not None else None)
            h.states.append(StateInfo(streams=streams, stream_weights=sw))
        h.transp = np.array(proto.transp, np.float32).copy()
        out.hmms[nm] = h
        out.macros["h"][nm] = h
    return out
