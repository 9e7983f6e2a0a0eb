"""Viterbi alignment over composite utterance HMMs (max-plus scan), in torch.

The PyTorch counterpart of `htk_tpu/algo/viterbi.py`: the forced-alignment
core of `HTKTools/HVite.c -a` and the segmentation step of HInit. The same
composite HMM used for Baum-Welch (algo/composite) is decoded with a
(max, +) frame loop that keeps a (T, Q) backpointer plane; the traceback
runs on the host over the planes, as in the reference.

The reference runs the scan as one XLA program (no Pallas kernel); here it
is a Python frame loop of torch ops on the utterance's device, one
utterance at a time as in the reference. Observation scores come from the
set's packed Gaussians (ops/outp through `decode.scorer_for`), diagonal or
full covariance, gathered to the composite's states.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..models.hmmset import CompiledHMMSet
from ..utils.errors import HError
from .composite import CompositeHMM


def viterbi_scan(outp: torch.Tensor, logA: torch.Tensor, a0: torch.Tensor,
                 aE: torch.Tensor, t_real: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Max-plus forward pass with backpointers over outp (T, Q).

    Returns (score, deltas (T, Q), backptrs (T, Q) int64) on outp's
    device. Frame 0 takes `a0` and backpointer -1; each later frame the
    best source of every state, the FIRST maximum among equal candidates
    (torch.argmax, as jnp.argmax)."""
    T, Q = outp.shape
    deltas = torch.empty((T, Q), dtype=torch.float32, device=outp.device)
    bps = torch.empty((T, Q), dtype=torch.int64, device=outp.device)
    torch.add(a0, outp[0], out=deltas[0])
    bps[0] = -1
    for t in range(1, T):
        cand = deltas[t - 1][:, None] + logA  # (Q_from, Q_to)
        bp = torch.argmax(cand, dim=0)
        torch.add(cand.gather(0, bp[None])[0], outp[t], out=deltas[t])
        bps[t] = bp
    score = torch.max(deltas[max(int(t_real) - 1, 0)] + aE)
    return score, deltas, bps


def state_outp_for(comp: CompiledHMMSet, feats: torch.Tensor,
                   comp_state: torch.Tensor,
                   precision: str = "highest") -> torch.Tensor:
    """(T, Q) observation log-likelihoods of the composite's states for
    frames (T, D), on the frames' device (htk_tpu/algo/viterbi.py :
    state_outp_for with an all-true q_mask). Multi-stream sets sum their
    stream blocks, each raised to its stream weight, in the scorer."""
    from .decode import scorer_for

    if comp.discrete:
        HError(7331, "align: discrete HMM sets are not ported to "
                     "htk_tpu_torch")
    logb = scorer_for(comp, feats.device, precision)(feats)
    return logb[:, comp_state]


class Alignment(NamedTuple):
    score: float  # total Viterbi log-likelihood
    states: np.ndarray  # (T,) composite state index per frame
    # (model index in the sequence, t0, t1, segment score)
    model_seq: List[Tuple[int, int, int, float]]


def align(
    comp: CompiledHMMSet,
    hmm: CompositeHMM,
    feats: np.ndarray,
    precision: str = "highest",
    *,
    device,
) -> Alignment:
    """Forced alignment of one utterance against its composite HMM on
    `device`; the traceback and segmentation run on the host."""
    dev = torch.device(device)
    T = feats.shape[0]
    Q = hmm.n_states

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    outp = state_outp_for(
        comp, f32(feats),
        torch.as_tensor(np.asarray(hmm.comp_state, np.int64), device=dev),
        precision)
    score, deltas, bps = viterbi_scan(outp, f32(hmm.logA), f32(hmm.a0),
                                      f32(hmm.aE), T)
    deltas = deltas.cpu().numpy()
    bps = bps.cpu().numpy()
    score = float(score)

    # host traceback over the backpointer planes
    states = np.zeros(T, np.int32)
    j = int(np.argmax(deltas[T - 1] + np.asarray(hmm.aE)))
    states[T - 1] = j
    for t in range(T - 1, 0, -1):
        j = int(bps[t, states[t]])
        states[t - 1] = j

    # composite state -> instance index in the model sequence
    inst_of = np.zeros(Q, np.int32)
    qi = 0
    for k, mid in enumerate(hmm.model_ids):
        e = int(comp.model_nstates[mid]) - 2
        inst_of[qi : qi + e] = k
        qi += e

    model_seq: List[Tuple[int, int, int, float]] = []
    t0 = 0
    cur = int(inst_of[states[0]])
    for t in range(1, T + 1):
        if t == T or int(inst_of[states[t]]) != cur:
            seg_score = float(deltas[t - 1, states[t - 1]]) - (
                float(deltas[t0 - 1, states[t0 - 1]]) if t0 > 0 else 0.0
            )
            model_seq.append((cur, t0, t, seg_score))
            if t < T:
                cur = int(inst_of[states[t]])
                t0 = t
    return Alignment(score=score, states=states, model_seq=model_seq)
