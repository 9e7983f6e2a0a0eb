"""The plain reference of the decoding cells: Gaussian log-likelihoods and
a Viterbi search over the bigram word loop, in float64, worked out again
from what the benchmark generated (the Gaussians, the word chains of pool
states, the bigram successors, the frames). It imports nothing of the
program and takes nothing the program built: no compiled set, network,
packed weights or tables.

Semantics (HTK's token passing over an HBuild network of a back-off bigram
or a word-pair grammar, as the decoders under test implement it):

  emission   b_s(x) = log sum_m w_m N(x; mu_m, diag var_m), w_m = 1/M
  within     a state keeps its token (log a_self) or passes it to the next
             state of its word (log a_fwd); a word's first state is entered
             only from outside the word
  word end   WE_i = v(last state of i) + log a_fwd (the exit transition)
  entry      at frame 0: s * start_i; later: max_j (WE_j + s * lm(j, i)) + p
             with lm(j, i) = max(explicit bigram, back-off + unigram) for
             a back-off bigram; for a word-pair grammar the pair's weight
             where i may follow j, -inf where it may not
  total      max_i (WE_i at the last frame + s * end_i)

The word-insertion penalty p is collected at every word entry after
frame 0, so an utterance of n words pays it n - 1 times.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

F64 = torch.float64
NEG = float("-inf")


def state_loglik(x: torch.Tensor, means: torch.Tensor,
                 variances: torch.Tensor) -> torch.Tensor:
    """(T, P) float64 log-likelihoods of frames x (T, D) under each pool
    state's equally weighted diagonal Gaussians (P, M, D)."""
    x = x.to(F64)
    mu = means.to(F64)
    var = variances.to(F64)
    P, M, D = mu.shape
    iv = (1.0 / var).reshape(P * M, D)
    mv = (mu / var).reshape(P * M, D)
    const = (D * math.log(2 * math.pi) + torch.log(var).sum(-1)
             + (mu * mu / var).sum(-1)).reshape(P * M)
    quad = (x * x) @ iv.T - 2.0 * (x @ mv.T) + const  # (T, P * M)
    logn = -0.5 * quad.reshape(-1, P, M) - math.log(M)
    return torch.logsumexp(logn, dim=-1)


class WordLoop:
    """The bigram word loop as flat state arrays on `device`.

    `word_states`: each word's chain of pool-state ids; `succ`: each
    word's successors; `lm`: natural-log weights {explicit, start, end,
    and for a back-off bigram uni, bow}; `trans`: (log self-loop, log
    forward)."""

    def __init__(self, word_states: Sequence[np.ndarray],
                 succ: Sequence[Sequence[int]], lm: dict,
                 trans: Tuple[float, float], lm_scale: float,
                 word_pen: float, device):
        lens = np.array([len(s) for s in word_states], np.int64)
        ends = np.cumsum(lens)
        self.V = len(word_states)
        self.first = torch.as_tensor(ends - lens, device=device)
        self.last = torch.as_tensor(ends - 1, device=device)
        self.pool = torch.as_tensor(np.concatenate(word_states),
                                    device=device)
        ns = int(ends[-1])
        is_first = np.zeros(ns, bool)
        is_first[ends - lens] = True
        self.is_first = torch.as_tensor(is_first, device=device)
        self.log_self, self.log_fwd = trans
        self.s, self.p = float(lm_scale), float(word_pen)
        self.lm = lm
        src = np.repeat(np.arange(self.V), [len(x) for x in succ])
        dst = np.concatenate([np.asarray(x, np.int64) for x in succ])
        self.arc_src = torch.as_tensor(src, device=device)
        self.arc_dst = torch.as_tensor(dst, device=device)
        self.pair_keys = np.sort(src * self.V + dst)
        # a back-off bigram's leg (a word-pair grammar has none)
        self.bo_lm = lm["bow"] + lm["uni"] if "bow" in lm else None
        self.explicit = self.s * lm["explicit"]

    def lm_pairs(self, i: np.ndarray, j: np.ndarray) -> np.ndarray:
        """lm(i, j) of each pair: the explicit weight where j follows i,
        maxed with the back-off path where there is one; -inf where the
        grammar does not let j follow i."""
        k = np.asarray(i, np.int64) * self.V + np.asarray(j, np.int64)
        pos = np.minimum(np.searchsorted(self.pair_keys, k),
                         len(self.pair_keys) - 1)
        ex = self.pair_keys[pos] == k
        if self.bo_lm is None:
            return np.where(ex, self.lm["explicit"], NEG)
        return np.where(ex, max(self.lm["explicit"], self.bo_lm),
                        self.bo_lm)

    def lm_pair(self, i: int, j: int) -> float:
        return float(self.lm_pairs(np.array([i]), np.array([j]))[0])

    def cross(self, WE: torch.Tensor) -> torch.Tensor:
        """max_j (WE_j + s * lm(j, i)) for every word i: the explicit
        pairs (a segment max) and the back-off leg (one max)."""
        B = WE.shape[0]
        vals = WE[:, self.arc_src] + self.explicit
        ex = torch.full((B, self.V), NEG, dtype=F64, device=WE.device)
        ex = ex.scatter_reduce(1, self.arc_dst.expand(B, -1), vals, "amax",
                               include_self=True)
        if self.bo_lm is None:
            return ex
        bo = WE.max(dim=1, keepdim=True).values + self.s * self.bo_lm
        return torch.maximum(bo.expand(B, self.V), ex)


def _padded(lls: List[torch.Tensor]) -> torch.Tensor:
    T = max(int(x.shape[0]) for x in lls)
    out = torch.zeros((len(lls), T, lls[0].shape[1]), dtype=F64,
                      device=lls[0].device)
    for b, x in enumerate(lls):
        out[b, :x.shape[0]] = x
    return out


def best_scores(loop: WordLoop, lls: List[torch.Tensor],
                ends: bool = False):
    """The best total score of each utterance ((T, P) log-likelihoods
    each, decoded together). With `ends`, also the word-end plane: a (B,
    T, V) tensor whose [b, t, i] is the best score of a path that ends
    word i at frame t, its exit transition included (what a decoder
    records as word i's end at t)."""
    ll = _padded(lls)
    B, T, _ = ll.shape
    lens = [int(x.shape[0]) for x in lls]
    s, p = loop.s, loop.p
    Ns = loop.pool.numel()
    start = torch.full((Ns,), NEG, dtype=F64, device=ll.device)
    start[loop.first] = s * loop.lm["start"]
    end_add = loop.log_fwd + s * loop.lm["end"]
    first = loop.is_first
    pad = torch.full((B, 1), NEG, dtype=F64, device=ll.device)
    out = np.full(B, NEG)
    plane = (torch.empty((B, T, loop.V), dtype=F64, device=ll.device)
             if ends else None)
    v = None
    for t in range(T):
        ob = ll[:, t][:, loop.pool]
        if t == 0:
            v = start[None] + ob
        else:
            WE = v[:, loop.last] + loop.log_fwd
            ent = loop.cross(WE) + p
            move = torch.cat([pad, v[:, :-1]], dim=1) + loop.log_fwd
            within = torch.maximum(v + loop.log_self,
                                   move.masked_fill(first, NEG))
            within[:, loop.first] = torch.maximum(within[:, loop.first], ent)
            v = within + ob
        if ends:
            plane[:, t] = v[:, loop.last] + loop.log_fwd
        for b in range(B):
            if lens[b] == t + 1:
                out[b] = float((v[b, loop.last] + end_add).max())
    return (out, plane) if ends else out


def segment_scores(loop: WordLoop, ll: torch.Tensor,
                   word_states: Sequence[np.ndarray], w: np.ndarray,
                   a: np.ndarray, e: np.ndarray) -> np.ndarray:
    """The score of word w[k] aligned by Viterbi inside frames a[k]..e[k]
    of one utterance ((T, P) log-likelihoods): entered at its first state
    at frame a, its last state left after frame e (the exit transition
    included), as a word's acoustic score on a lattice arc. One pass a
    distinct (word, first frame), all its last frames read off it."""
    w, a, e = (np.asarray(x, np.int64) for x in (w, a, e))
    if not w.size:
        return np.zeros(0)
    T = int(ll.shape[0])
    key, inv = np.unique(w * (T + 1) + a, return_inverse=True)
    rw, ra = key // (T + 1), key % (T + 1)
    n = np.array([len(word_states[x]) for x in rw], np.int64)
    R, L = len(rw), int(n.max())
    pool = np.zeros((R, L), np.int64)
    for r in range(R):
        pool[r, :n[r]] = word_states[rw[r]]
    dev = ll.device
    pool_t = torch.as_tensor(pool, device=dev)
    real = torch.as_tensor(np.arange(L)[None] < n[:, None], device=dev)
    last = torch.as_tensor(n - 1, device=dev)
    rows = torch.arange(R, device=dev)
    ra_t = torch.as_tensor(ra, device=dev)
    span = e - a
    out = torch.full((R, int(span.max()) + 1), NEG, dtype=F64, device=dev)
    pad = torch.full((R, 1), NEG, dtype=F64, device=dev)
    v = torch.full((R, L), NEG, dtype=F64, device=dev)
    for tau in range(out.shape[1]):
        t = (ra_t + tau).clamp(max=T - 1)
        ob = ll[t[:, None], pool_t]
        if tau == 0:
            v[:, 0] = 0.0
            v = v + ob
        else:
            move = torch.cat([pad, v[:, :-1]], dim=1) + loop.log_fwd
            v = torch.maximum(v + loop.log_self, move) + ob
        v = v.masked_fill(~real, NEG)
        out[:, tau] = v[rows, last]
    got = out[torch.as_tensor(inv, device=dev),
              torch.as_tensor(span, device=dev)]
    return got.cpu().numpy() + loop.log_fwd


def path_scores(loop: WordLoop, lls: List[torch.Tensor],
                paths: List[Tuple[List[int], List[Tuple[int, int]]]],
                word_states: Sequence[np.ndarray]) -> np.ndarray:
    """The score of each given path: its words (ids) and each word's
    (first frame, last frame), every word aligned inside its own frames by
    Viterbi. A path whose frames do not run from 0 to T - 1 word after
    word scores -inf."""
    B = len(lls)
    ll = _padded(lls)
    T = ll.shape[1]
    dev = ll.device
    s, p = loop.s, loop.p
    L = max(1, max(sum(len(word_states[w]) for w in ws) for ws, _ in paths))
    pool = np.zeros((B, L), np.int64)
    t0 = np.full((B, L), T, np.int64)  # padding: never active
    t1 = np.full((B, L), -1, np.int64)
    enter = np.full((B, L), NEG)  # at a word's first state
    n_st = np.zeros(B, np.int64)
    fin_add = np.full(B, NEG)
    ok = np.ones(B, bool)
    for b, (ws, times) in enumerate(paths):
        if not ws or times[0][0] != 0 or times[-1][1] != lls[b].shape[0] - 1:
            ok[b] = False
            continue
        k = 0
        for n, (w, (a, e)) in enumerate(zip(ws, times)):
            if n and a != times[n - 1][1] + 1:
                ok[b] = False
            m = len(word_states[w])
            pool[b, k:k + m] = word_states[w]
            t0[b, k:k + m], t1[b, k:k + m] = a, e
            enter[b, k] = (s * loop.lm["start"] if n == 0 else
                           loop.log_fwd + s * loop.lm_pair(ws[n - 1], w)
                           + p)
            k += m
        n_st[b] = k
        fin_add[b] = loop.log_fwd + s * loop.lm["end"]
    pool_t = torch.as_tensor(pool, device=dev)
    t0_t = torch.as_tensor(t0, device=dev)
    t1_t = torch.as_tensor(t1, device=dev)
    enter_t = torch.as_tensor(enter, dtype=F64, device=dev)
    is_enter = torch.isfinite(enter_t)
    pad = torch.full((B, 1), NEG, dtype=F64, device=dev)
    lens = [int(x.shape[0]) for x in lls]
    out = np.full(B, NEG)
    v = None
    for t in range(T):
        ob = ll[:, t].gather(1, pool_t)
        active = (t0_t <= t) & (t <= t1_t)
        if t == 0:
            v = torch.full((B, L), NEG, dtype=F64, device=dev)
            v[:, 0] = enter_t[:, 0]
            v = v + ob
        else:
            prev = torch.cat([pad, v[:, :-1]], dim=1)
            move = torch.where(is_enter, prev + enter_t, prev + loop.log_fwd)
            v = torch.maximum(v + loop.log_self, move) + ob
        v = v.masked_fill(~active, NEG)
        for b in range(B):
            if lens[b] == t + 1 and ok[b]:
                out[b] = float(v[b, n_st[b] - 1]) + fin_add[b]
    return out


def lattice_best(node_time: np.ndarray, a_start: np.ndarray,
                 a_end: np.ndarray, aclike: np.ndarray, lmlike: np.ndarray,
                 start: int, end: int, lm_scale: float,
                 word_pen: float) -> float:
    """The best path score through a word lattice (nodes with times, arcs
    with acoustic and LM scores), under the decoder's convention: each arc
    scores aclike + s * lmlike, and every arc that neither leaves the start
    node nor enters the end node (a word entry after the first) adds p.
    Arcs run forward in time; the end node is reached last."""
    w = (aclike.astype(np.float64) + lm_scale * lmlike.astype(np.float64)
         + np.where((a_start != start) & (a_end != end), word_pen, 0.0))
    best = np.full(len(node_time), NEG)
    best[start] = 0.0
    into_end = a_end == end
    t_end = node_time[a_end]
    for tau in np.unique(t_end[~into_end]):
        m = (t_end == tau) & ~into_end
        np.maximum.at(best, a_end[m], best[a_start[m]] + w[m])
    np.maximum.at(best, a_end[into_end], best[a_start[into_end]]
                  + w[into_end])
    return float(best[end])
