"""A plain reference of hybrid DNN-HMM decoding, in float64 torch: the DNN's
scores (FeaMix splicing, the layers, log-softmax, minus log prior) and a
Viterbi search over a bigram word loop on them. It imports nothing of
htk_tpu_torch and no JAX; callers hand it plain arrays.

  splice     frame t reads frames clamp(t + o, 0, T - 1), o in -C..C,
             each utterance on its own (its edge frames replicated)
  layers     h = act(h @ W^T + b); the last layer's outputs are logits
  score      log_softmax(logits) - log prior
  loop       word i is a chain of states; a state keeps its token (log
             a_self) or passes it on (log a_fwd); a word's end is its last
             state's score plus log a_fwd; entry into word i at frame 0 is
             s * start_i, later max_j (WE_j + s * lm[j, i]) + p
  total      max_i (WE_i at the last frame + s * end_i)

The matmuls run with TF32 off, as a float32 reference on a CUDA card
would have to (they are float64 here, which TF32 does not touch).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
NEG = float("-inf")


def splice(x: torch.Tensor, context: int) -> torch.Tensor:
    """(T, D) -> (T, (2C+1) D), the window clamped at the edges."""
    T = x.shape[0]
    idx = [min(max(t + o, 0), T - 1) for t in range(T)
           for o in range(-context, context + 1)]
    return x[torch.as_tensor(idx, device=x.device)].reshape(T, -1)


def dnn_scores(layers: Sequence[Tuple[np.ndarray, np.ndarray, str]],
               priors: np.ndarray, context: int, feats: np.ndarray,
               device="cpu") -> torch.Tensor:
    """(T, K) float64 scores of one utterance's frames (T, D): `layers`
    (W (out, in), b (out,), activation) in order, the last one's outputs
    the logits."""
    h = splice(torch.as_tensor(np.asarray(feats), dtype=F64,
                               device=device), context)
    for k, (W, b, act) in enumerate(layers):
        h = h @ torch.as_tensor(W, dtype=F64, device=device).T + \
            torch.as_tensor(b, dtype=F64, device=device)
        if k < len(layers) - 1:
            h = {"SIGMOID": torch.sigmoid, "RELU": torch.relu,
                 "TANH": torch.tanh, "LINEAR": lambda v: v}[act](h)
    return torch.log_softmax(h, dim=-1) - torch.log(
        torch.as_tensor(priors, dtype=F64, device=device))[None]


class WordLoop:
    """The bigram word loop: `chains[i]` the state ids (columns of the
    scores) of word i; `lm` (V, V) natural-log lm[j, i] of i after j;
    `start`, `end` (V,) the sentence's entry and exit weights."""

    def __init__(self, chains: List[np.ndarray], lm: np.ndarray,
                 start: np.ndarray, end: np.ndarray, log_self: float,
                 log_fwd: float, lm_scale: float, word_pen: float):
        lens = np.array([len(c) for c in chains])
        ends = np.cumsum(lens)
        self.chains = chains
        self.first = torch.as_tensor(ends - lens)
        self.last = torch.as_tensor(ends - 1)
        self.states = torch.as_tensor(np.concatenate(chains))
        is_first = np.zeros(int(ends[-1]), bool)
        is_first[ends - lens] = True
        self.is_first = torch.as_tensor(is_first)
        self.lm = torch.as_tensor(lm, dtype=F64)
        self.start = torch.as_tensor(start, dtype=F64)
        self.end = torch.as_tensor(end, dtype=F64)
        self.log_self, self.log_fwd = log_self, log_fwd
        self.s, self.p = lm_scale, word_pen


def best_score(loop: WordLoop, ll: torch.Tensor) -> float:
    """The best total score of one utterance's (T, K) scores."""
    ll = ll.to(F64).cpu()
    T = ll.shape[0]
    v = torch.full((loop.states.numel(),), NEG, dtype=F64)
    v[loop.first] = loop.s * loop.start
    v = v + ll[0, loop.states]
    for t in range(1, T):
        WE = v[loop.last] + loop.log_fwd
        entry = (WE[:, None] + loop.s * loop.lm).max(dim=0).values + loop.p
        move = torch.cat([torch.tensor([NEG], dtype=F64), v[:-1]]) + \
            loop.log_fwd
        v = torch.maximum(v + loop.log_self,
                          move.masked_fill(loop.is_first, NEG))
        v[loop.first] = torch.maximum(v[loop.first], entry)
        v = v + ll[t, loop.states]
    return float((v[loop.last] + loop.log_fwd + loop.s * loop.end).max())


def segment_scores(loop: WordLoop, ll: torch.Tensor, w, t0,
                   t1) -> np.ndarray:
    """Word w[k] aligned by Viterbi inside frames t0[k]..t1[k], entered at
    its first state at t0 and left after t1 (its exit transition
    included): a word's acoustic score on a lattice arc. All k at once,
    frame by frame from each one's t0."""
    ll = ll.to(F64).cpu()
    w, t0, t1 = (np.asarray(x, np.int64) for x in (w, t0, t1))
    n = np.array([len(loop.chains[x]) for x in w])
    L = int(n.max())
    st = np.zeros((len(w), L), np.int64)
    for k, x in enumerate(w):
        st[k, :n[k]] = loop.chains[x]
    st = torch.as_tensor(st)
    real = torch.as_tensor(np.arange(L)[None] < n[:, None])
    span = torch.as_tensor(t1 - t0)
    t0 = torch.as_tensor(t0)
    T = ll.shape[0]
    v = torch.full((len(w), L), NEG, dtype=F64)
    v[:, 0] = 0.0
    out = torch.full((len(w),), NEG, dtype=F64)
    pad = torch.full((len(w), 1), NEG, dtype=F64)
    for tau in range(int(span.max()) + 1):
        ob = ll[(t0 + tau).clamp(max=T - 1)[:, None], st]
        if tau:
            move = torch.cat([pad, v[:, :-1]], dim=1) + loop.log_fwd
            v = torch.maximum(v + loop.log_self, move)
        v = (v + ob).masked_fill(~real, NEG)
        done = span == tau
        out[done] = v[done, torch.as_tensor(n - 1)[done]]
    return out.numpy() + loop.log_fwd
