"""Composite utterance HMM construction for embedded training.

The host-side preprocessing that `HTKLib/HFB.c` does per utterance when it
abuts the transcription's phone models into one big utterance HMM. Here
the result is dense arrays sized for device scans (algo/fb.py):

  - comp_state: (Q,) physical emitting-state ids (for OutP gather)
  - logA: (Q, Q) log transition matrix between composite emitting states
  - a0: (Q,) log prob of starting in each state
  - aE: (Q,) log prob of exiting the utterance from each state
  - segment-id planes mapping composite transitions back to physical
    transition-matrix cells for accumulator scatter.

Tee models (nonzero entry->exit transition, e.g. the `sp` short-pause
model) are supported: tee chains multiply through so a model may be
skipped entirely, matching HNet/HFB semantics.

Copied from `htk_tpu/algo/composite.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..models.hmmset import CompiledHMMSet
from ..utils.errors import HError
from ..utils.logmath import LZERO


def _ladd_np(x, y):
    hi = np.maximum(x, y)
    lo = np.minimum(x, y)
    diff = lo - hi
    out = np.where(
        diff < -23.025850929940457,
        np.where(hi < -0.5e10, LZERO, hi),
        hi + np.log1p(np.exp(np.maximum(diff, -23.025850929940457))),
    )
    return out


@dataclass
class CompositeHMM:
    """Dense composite utterance HMM (host arrays, pre-padding)."""

    comp_state: np.ndarray  # (Q,) int32 physical state ids
    logA: np.ndarray  # (Q, Q) f32
    a0: np.ndarray  # (Q,) f32
    aE: np.ndarray  # (Q,) f32
    # accumulator scatter maps (flat indices into (Tn*Nmax*Nmax), -1 = none)
    tr_seg: np.ndarray  # (Q, Q) int32: within-model transition cells
    entry_seg: np.ndarray  # (Q,) int32: model entry row cells (0 -> 1+lj)
    exit_seg: np.ndarray  # (Q,) int32: model exit col cells (1+li -> N-1)
    n_states: int  # Q
    model_ids: np.ndarray  # (K,) int32 models in sequence


def build_composite(comp: CompiledHMMSet, model_ids: Sequence[int]) -> CompositeHMM:
    """Abut the sequence of models into one composite HMM (HFB.c role)."""
    nmax = comp.nmax
    K = len(model_ids)
    if K == 0:
        HError(7330, "build_composite: empty model sequence")

    # per-instance tables
    sizes = []  # emitting count per instance
    offsets = []  # composite offset of each instance
    en = []  # (e_k,) entry log-probs  transP[0, 1+j]
    ex = []  # (e_k,) exit log-probs   transP[1+i, N-1]
    tee = []  # scalar entry->exit log prob
    q = 0
    for mid in model_ids:
        n = int(comp.model_nstates[mid])
        e = n - 2
        if e < 0:
            HError(7330, "build_composite: model %s has %d states",
                   comp.names[mid], n)
        lt = comp.log_transp[comp.model_transp[mid]]
        offsets.append(q)
        sizes.append(e)
        en.append(lt[0, 1 : 1 + e].astype(np.float64))
        ex.append(lt[1 : 1 + e, n - 1].astype(np.float64))
        tee.append(float(lt[0, n - 1]))
        q += e
    Q = q
    if Q == 0:
        HError(7330, "build_composite: all models are tee (no emitting states)")

    comp_state = np.zeros(Q, np.int32)
    for k, mid in enumerate(model_ids):
        e = sizes[k]
        comp_state[offsets[k] : offsets[k] + e] = comp.model_states[mid, :e]

    logA = np.full((Q, Q), LZERO, np.float64)
    a0 = np.full(Q, LZERO, np.float64)
    aE = np.full(Q, LZERO, np.float64)

    # within-model blocks
    for k, mid in enumerate(model_ids):
        e = sizes[k]
        n = e + 2
        lt = comp.log_transp[comp.model_transp[mid]][1 : 1 + e, 1 : 1 + e]
        o = offsets[k]
        logA[o : o + e, o : o + e] = lt

    # cross-model links: exit of k reaches entry of k2 > k through the
    # chain of models k+1..k2-1, possible only if every one of them is a
    # tee (its entry->exit log-prob adds to the chain).
    for k in range(K):
        if sizes[k] == 0:
            continue
        chain = 0.0  # accumulated tee log-prob across skipped models
        for k2 in range(k + 1, K):
            e2 = sizes[k2]
            if e2 > 0:
                o2 = offsets[k2]
                cross = ex[k][:, None] + chain + en[k2][None, :]
                blk = logA[offsets[k] : offsets[k] + sizes[k], o2 : o2 + e2]
                logA[offsets[k] : offsets[k] + sizes[k], o2 : o2 + e2] = _ladd_np(
                    blk, cross
                )
                if tee[k2] <= LZERO / 2:
                    break  # k2 is not skippable; chain stops here
            chain += tee[k2]
            if chain <= LZERO / 2:
                break

    # utterance entry: model k's entry reached through tees of 1..k-1
    chain = 0.0
    for k in range(K):
        e = sizes[k]
        if e > 0:
            a0[offsets[k] : offsets[k] + e] = _ladd_np(
                a0[offsets[k] : offsets[k] + e], chain + en[k]
            )
            if tee[k] <= LZERO / 2:
                break
        chain += tee[k]
        if chain <= LZERO / 2:
            break

    # utterance exit: model k exits through tees of k+1..K
    chain = 0.0
    for k in range(K - 1, -1, -1):
        e = sizes[k]
        if e > 0:
            aE[offsets[k] : offsets[k] + e] = _ladd_np(
                aE[offsets[k] : offsets[k] + e], ex[k] + chain
            )
            if tee[k] <= LZERO / 2:
                break
        chain += tee[k]
        if chain <= LZERO / 2:
            break

    # accumulator scatter maps: composite cells -> flat physical transP cell
    # (vectorised: these maps are rebuilt per utterance per pass, so host
    # cost here directly bounds training throughput)
    tr_seg = np.full((Q, Q), -1, np.int32)
    entry_seg = np.full(Q, -1, np.int32)
    exit_seg = np.full(Q, -1, np.int32)
    for k, mid in enumerate(model_ids):
        e = sizes[k]
        if e == 0:
            continue
        n = e + 2
        tid = int(comp.model_transp[mid])
        o = offsets[k]
        li = np.arange(1, e + 1, dtype=np.int64)
        tr_seg[o : o + e, o : o + e] = (
            (tid * nmax + li[:, None]) * nmax + li[None, :]
        ).astype(np.int32)
        exit_seg[o : o + e] = ((tid * nmax + li) * nmax + (n - 1)).astype(np.int32)
        entry_seg[o : o + e] = (tid * nmax * nmax + li).astype(np.int32)

    return CompositeHMM(
        comp_state=comp_state,
        logA=logA.astype(np.float32),
        a0=a0.astype(np.float32),
        aE=aE.astype(np.float32),
        tr_seg=tr_seg,
        entry_seg=entry_seg,
        exit_seg=exit_seg,
        n_states=Q,
        model_ids=np.asarray(model_ids, np.int32),
    )
